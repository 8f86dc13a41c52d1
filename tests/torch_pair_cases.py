"""Draws of the pair sum's inputs that its kernel's scales find hard.

Shared by the CPU tests of the kernel's float64 emulation
(tests/test_torch_pair_grad_tc.py) and the card tests of the kernel
(tests/test_torch_gpu.py). This module imports the port alone (no JAX), so
that the card tests run where JAX is absent. chip_smoke.py keeps its own
copy of both draws.
"""

import numpy as np
import torch

from action_segmentation_torch import BIG_NEG


def masked_pair_draw(rng, b, t, c, gaps, device):
    """Pair-sum inputs (X, Y, trans, Z, lengths) where a masked pair
    dominates every frame: a class drawn a frame stands `gap` above the
    others in X and in Y (X, Y = -gap / 2 + 3 N(0, 1), that class's +gap),
    the gap drawn a frame from `gaps`, and the table's diagonal BIG_NEG
    (log-Dirichlet rows, expanded over the batch), so that the masked
    pair's exponent is about gap above the best unmasked pair's (about 0;
    Z = 0.1 N(0, 1)); lengths ragged down to 1."""
    gap = np.asarray(gaps, np.float64)[rng.randint(len(gaps), size=(b, t))]
    top = rng.randint(c, size=(b, t))
    X = rng.randn(b, t, c) * 3 - gap[..., None] / 2
    Y = rng.randn(b, t, c) * 3 - gap[..., None] / 2
    bi, ti = np.meshgrid(np.arange(b), np.arange(t), indexing="ij")
    X[bi, ti, top] += gap
    Y[bi, ti, top] += gap
    trans = np.log(rng.dirichlet(np.ones(c), size=c))
    trans[np.arange(c), np.arange(c)] = BIG_NEG
    Z = rng.randn(b) * 0.1
    lengths = rng.randint(1, t + 1, size=b)
    lengths[0] = t
    if b > 1:
        lengths[-1] = 1
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    return (dev(X), dev(Y), dev(trans).expand(b, c, c), dev(Z),
            torch.from_numpy(lengths).long().to(device))


def nan_pair_draw(rng, t, c, device):
    """``masked_pair_draw`` (6 videos of `t` frames, gaps of 100, 800 and
    5,000 nats, a table of each video's own) with a NaN in each of its
    inputs: X of video 0 at interior frame 1 (and at frame 0, which no sum
    reads), Y of video 1 at frame 1, Z of video 2, trans of video 3, and Z
    and trans of video 4, whose one frame has no interior boundary (its sum
    stays 0); videos 0-3 at least 2 frames."""
    X, Y, trans, Z, L = masked_pair_draw(rng, 6, t, c, (100.0, 800.0, 5000.0), device)
    X, Y, trans, Z, L = X.clone(), Y.clone(), trans.contiguous(), Z.clone(), L.clone()
    nan = float("nan")
    X[0, 1, 3 % c] = X[0, 0, (c - 1) // 2] = nan
    Y[1, 1, c - 1] = nan
    Z[2] = Z[4] = nan
    trans[3, c // 3, c - 1] = trans[4, 0, 0] = nan
    L[:4] = L[:4].clamp(min=2)
    L[4] = 1
    return X, Y, trans, Z, L
