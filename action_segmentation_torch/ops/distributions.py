"""Emission / duration / transition factor computations.

The tied diagonal-covariance Gaussian emission as one batched fp32
matmul, the Poisson duration table, and the masked log-softmax
transition/initial factors. The cross-term matmul is a plain large
product and stays with ``torch.matmul`` (fp32, TF32 off — see the
package ``__init__``).
"""

import torch

from action_segmentation_torch import BIG_NEG

LOG_2PI = 1.8378770664093453


def gaussian_emission_log_probs(features, means, cov_diag):
    """Tied diagonal-covariance Gaussian log-likelihoods.

    features: (..., T, D); means: (C, D) or (..., C, D) for per-instance
    means; cov_diag: (D,). Returns (..., T, C).

    log N(x; mu_c, diag(v)) = -0.5 * [ D log 2pi + sum log v
                                       + sum (x - mu_c)^2 / v ]
    expanded so the cross term is a single (T, D) x (D, C) matmul.
    """
    inv_v = 1.0 / cov_diag
    const = -0.5 * (features.shape[-1] * LOG_2PI + torch.sum(torch.log(cov_diag)))
    x_sq = torch.matmul(features**2, inv_v)  # (..., T)
    cross = torch.matmul(features, (means * inv_v).transpose(-1, -2))  # (..., T, C)
    mu_sq = torch.sum(means**2 * inv_v, dim=-1).unsqueeze(-2)  # broadcasts over T
    return const - 0.5 * (x_sq[..., None] - 2.0 * cross + mu_sq)


def poisson_length_log_probs(log_rates, max_k):
    """Duration table: row d = Poisson(exp(log_rate)) log-pmf at d.

    log_rates: (..., C). Returns (..., K, C) with K = max_k (row 0 is a
    valid Poisson value but unreachable in the DP since durations start
    at 1). K == 1 gives the 2-row [[0], [-1000]] table.
    """
    C = log_rates.shape[-1]
    if max_k == 1:
        table = torch.zeros(
            log_rates.shape[:-1] + (2, C), dtype=torch.float32, device=log_rates.device
        )
        table[..., 1, :] = -1000.0
        return table
    d = torch.arange(max_k, dtype=torch.float32, device=log_rates.device)[:, None]
    log_rates = log_rates.unsqueeze(-2)  # (..., 1, C)
    return d * log_rates - torch.exp(log_rates) - torch.lgamma(d + 1.0)


def masked_log_softmax(logits, disallowed_mask=None, dim=-1):
    """Fill disallowed entries with BIG_NEG, then log-softmax over `dim`.

    BIG_NEG = -1e9 rather than -inf keeps fully-masked slices finite.
    """
    if disallowed_mask is not None:
        logits = logits.masked_fill(disallowed_mask, BIG_NEG)
    return torch.log_softmax(logits, dim=dim)


def transition_log_probs(logits, disallowed_mask=None, allow_self_transitions=True):
    """Column-normalized transition factors, indexed [to, from].

    logits: (C, C) or (B, C, C). Optional boolean mask of disallowed
    transitions (same indexing) and a self-transition ban; normalization
    is a log-softmax over the `to` axis (dim -2).
    """
    if not allow_self_transitions:
        eye = torch.eye(logits.shape[-1], dtype=torch.bool, device=logits.device)
        disallowed_mask = eye if disallowed_mask is None else disallowed_mask | eye
    return masked_log_softmax(logits, disallowed_mask, dim=-2)


def initial_log_probs(logits, disallowed_mask=None):
    """Normalized initial factors."""
    return masked_log_softmax(logits, disallowed_mask, dim=-1)
