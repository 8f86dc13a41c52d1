"""NICE coupling-layer flow for emission features.

Twin of ``action_segmentation_tpu/models/flow.py`` as an ``nn.Module``
whose state dict carries the reference's names (src/models/flow.py:
``cell{i}`` and, with --flow_scale, ``scale_cell{i}``, each a ReLU net of
``in_layer``, hidden ``cell{j}`` and ``out_layer``), so a reference or
JAX flow loads by name (``checkpoint.py``, ``bridge.py``). The flow maps
features x -> h with a log-Jacobian term that enters the training loss.
"""

from torch import nn
import torch

from action_segmentation_torch.models.nn import linear


def add_args(parser):
    parser.add_argument("--flow_hidden_layers", type=int, default=1)
    parser.add_argument("--flow_hidden_units", type=int, default=100)
    parser.add_argument("--flow_couple_layers", type=int, default=4)
    parser.add_argument("--flow_scale", action="store_true")
    parser.add_argument("--flow_scale_no_zero", action="store_true")


class ReLUNet(nn.Module):
    """in_layer, `hidden_layers` hidden cells and out_layer, a ReLU after
    every layer but the last; all zeros with `zero`."""

    def __init__(self, in_f, out_f, hidden_units, hidden_layers, generator, zero=False,
                 device=None):
        super().__init__()
        self.in_layer = linear(in_f, hidden_units, generator, zero=zero, device=device)
        self.hidden = hidden_layers
        for j in range(hidden_layers):
            setattr(self, "cell{}".format(j),
                    linear(hidden_units, hidden_units, generator, zero=zero, device=device))
        self.out_layer = linear(hidden_units, out_f, generator, zero=zero, device=device)

    def forward(self, x):
        h = torch.relu(self.in_layer(x))
        for j in range(self.hidden):
            h = torch.relu(getattr(self, "cell{}".format(j))(h))
        return self.out_layer(h)


class NiceFlow(nn.Module):
    """`--flow_couple_layers` additive couplings over alternating halves,
    affine with --flow_scale, whose scale nets start at zero unless
    --flow_scale_no_zero."""

    def __init__(self, args, features, generator, device=None):
        super().__init__()
        half = features // 2
        self.couple_layers = args.flow_couple_layers
        self.scale = bool(args.flow_scale)
        net = dict(hidden_units=args.flow_hidden_units, hidden_layers=args.flow_hidden_layers,
                   generator=generator, device=device)
        for i in range(self.couple_layers):
            setattr(self, "cell{}".format(i), ReLUNet(half, half, **net))
            if self.scale:
                setattr(self, "scale_cell{}".format(i),
                        ReLUNet(half, half, zero=not args.flow_scale_no_zero, **net))

    def forward(self, x, per_step=False):
        """x (..., D) -> (h (..., D), log_det): log_det sums the scale
        outputs over every axis but the leading batch axis, (B,); with
        `per_step` over the feature axis only, x.shape[:-1], so a caller
        can mask padded frames before it sums over time."""
        half = x.shape[-1] // 2
        log_det = x.new_zeros(x.shape[:-1])
        h = x
        for i in range(self.couple_layers):
            h1, h2 = h[..., :half], h[..., half:]
            if i % 2 == 1:
                h1, h2 = h2, h1
            t = getattr(self, "cell{}".format(i))(h1)
            if self.scale:
                s = getattr(self, "scale_cell{}".format(i))(h1)
                log_det = log_det + s.sum(dim=-1)
                h2 = torch.exp(s) * h2 + t
            else:
                h2 = h2 + t
            if i % 2 == 1:
                h1, h2 = h2, h1
            h = torch.cat([h1, h2], dim=-1)
        if not per_step:
            log_det = log_det.reshape(x.shape[0], -1).sum(dim=-1)
        return h, log_det
