"""Multi-layer bidirectional LSTM encoder.

Twin of ``action_segmentation_tpu/models/rnn.py``. The JAX package runs
a masked ``lax.scan``; here ``nn.LSTM`` runs over a packed sequence, as
the reference itself did (src/models/sequential.py:11-30): each video's
states stop at its length, the backward direction runs over each video
reversed within its length, and frames past a length come out as zeros.
The gate order (i, f, g, o) is torch's own; the JAX package stores each
weight as (in, 4H), the transpose of ``weight_ih_l*`` (``bridge.py``).
"""

import math

from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from action_segmentation_torch.models.nn import uniform, xavier_uniform


class LSTMEncoder(nn.Module):
    """``self.encoder`` is the nn.LSTM (batch first), so the state dict
    carries the reference's ``encoder.weight_ih_l0``... under the
    module's name. Weights are torch's default U(-1/sqrt(H), 1/sqrt(H)),
    or xavier-uniform with `xavier_w` (the reference's dim > 1 override,
    which the compound model's encoder goes through); biases keep the
    default."""

    def __init__(self, input_dim, hidden_per_dir, generator, num_layers=2, xavier_w=False,
                 device=None):
        super().__init__()
        lstm = nn.LSTM(input_dim, hidden_per_dir, num_layers, batch_first=True,
                       bidirectional=True, device="meta")
        bound = 1.0 / math.sqrt(hidden_per_dir)
        for name, p in list(lstm.named_parameters()):
            if name.startswith("weight") and xavier_w:
                value = xavier_uniform(tuple(p.shape), generator)
            else:
                value = uniform(tuple(p.shape), bound, generator)
            setattr(lstm, name, nn.Parameter(value))
        self.encoder = lstm.to(device)

    def forward(self, x, lengths):
        """x (B, T, D), lengths (B,) >= 1 -> (B, T, H_total), zeros past
        each length."""
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        out, _ = self.encoder(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
        return out
