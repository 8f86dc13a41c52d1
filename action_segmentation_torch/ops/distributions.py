"""Emission / duration / transition factor computations.

The Gaussian emissions (tied diagonal, per-class diagonal, and full
covariances shared or per class) as fp32 matmuls, the Poisson duration
table, and the masked log-softmax transition/initial factors. The
products are plain large GEMMs and stay with ``torch.matmul``, and the
full covariances' factors with ``torch.linalg`` (fp32, TF32 off — see
the package ``__init__``).
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


def gaussian_emission_log_probs_diag(features, means, cov_diag):
    """Per-class diagonal-covariance Gaussian log-likelihoods.

    features: (..., T, D); means (C, D); cov_diag (C, D). Returns
    (..., T, C). The tied expansion with per-class inverse variances, so
    the square and cross terms are one matmul each.
    """
    inv_v = 1.0 / cov_diag  # (C, D)
    const = -0.5 * (features.shape[-1] * LOG_2PI + torch.sum(torch.log(cov_diag), dim=-1))
    x_sq = torch.matmul(features**2, inv_v.T)  # (..., T, C)
    cross = torch.matmul(features, (means * inv_v).T)
    mu_sq = torch.sum(means**2 * inv_v, dim=-1)  # (C,)
    return const - 0.5 * (x_sq - 2.0 * cross + mu_sq)


def cholesky_or_nan(cov):
    """(lower Cholesky factor of each (D, D) matrix in `cov`, info).

    A matrix that is not positive definite in fp32 gets an all-NaN
    factor, as ``jnp.linalg.cholesky`` gives it (``cholesky_ex`` leaves a
    partial factor and a positive ``info``); its class's log-likelihoods
    are then NaN, which an argmax takes as the maximum in both packages.
    Nothing here waits for the card."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info != 0)[..., None, None], torch.nan, chol), info


def fullcov_factors(means, cov):
    """What the full-covariance log-likelihoods need of (means, cov),
    computed once for many videos: (L^-1 with L the Cholesky factor of
    `cov` (D, D) or (C, D, D), the whitened means L^-1 mu_c (C, D), and
    log|diag L| () or (C,)), on `cov`'s device.

    L itself is factored on the host, whatever the device. A class with
    fewer frames than D has a rank-deficient covariance plus 1e-6 I, and
    whether its fp32 factor succeeds or fails is decided by rounding:
    LAPACK and cuSOLVER decide differently for a few such classes at
    D=300 (PERF.md §6), and a failed class's NaN column wins every
    frame of its task. Factored on the host, the card fails the classes
    the CPU fails; the solve and the GEMMs run on the card."""
    chol = cholesky_or_nan(cov.cpu())[0].to(cov.device)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    inv_chol = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    if cov.ndim == 2:
        return inv_chol, torch.matmul(means, inv_chol.T), logdet
    return inv_chol, torch.matmul(inv_chol, means[..., None])[..., 0], logdet


# per-class frames whitened at once: at most this many (frames, C, D)
# fp32 elements (256 MB) in flight
FULLCOV_CHUNK = 1 << 26


def gaussian_emission_log_probs_fullcov(features, means, cov, factors=None):
    """Full-covariance Gaussian log-likelihoods (sklearn's 'tied' for a
    (D, D) `cov`, 'full' for (C, D, D)).

    features: (..., T, D); means (C, D). Returns (..., T, C). With
    y = L^-1 x, log p_c = -0.5 (D log 2pi + ||y - L^-1 mu_c||^2) - log|diag L|.
    A shared covariance whitens once and expands the square, so the
    cross term is one (T, D) x (D, C) matmul; per class, the frames are
    whitened by one batched (C, D, D) x (D, frames) matmul, FULLCOV_CHUNK
    elements at a time. `factors` are ``fullcov_factors(means, cov)``,
    when the caller has them.
    """
    inv_chol, mu_y, logdet = factors if factors is not None else fullcov_factors(means, cov)
    D = features.shape[-1]
    if inv_chol.ndim == 2:
        y = torch.matmul(features, inv_chol.T)
        quad = (torch.sum(y**2, dim=-1)[..., None] - 2.0 * torch.matmul(y, mu_y.T)
                + torch.sum(mu_y**2, dim=-1))
        return -0.5 * (D * LOG_2PI + quad) - logdet
    x = features.reshape(-1, D)
    rows = max(1, FULLCOV_CHUNK // (inv_chol.shape[0] * D))
    quad = torch.cat([
        torch.sum((torch.matmul(inv_chol, x[i : i + rows].T) - mu_y[..., None]) ** 2, dim=1).T
        for i in range(0, x.shape[0], rows)
    ])
    quad = quad.reshape(features.shape[:-1] + (inv_chol.shape[0],))
    return -0.5 * (D * LOG_2PI + quad) - logdet


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
