"""Long videos through the port's log-semiring DP above 128 classes, held
against float64 and the JAX package.

Above 128 classes the card runs the wide scans (csrc/hsmm_scan_wide.cu,
W1 log and W1 fwd) and K4's wide kernel; on the CPU the same wrappers run
their plain versions, which the kernels equal bit for bit (chip_smoke.py
phases 4i and 4j). Since the wide scans fold their carry as the narrow ones
do (every SCAN_FOLD frames, and each class on its own past
SCAN_FOLD_LIMIT; ``hsmm_cuda._scan_plain``) and the backward anchors K4's
inputs per chunk of BAND_CHUNK rows at every width, the card route's
function above 128 classes is the Function's PLAIN path over centred
emissions (``hsmm_partition_centred``). Here: the wide plain scans against
``_scan_plain`` with the fold, offsets included; a 136-class video of
2,048 frames at the D=300 emission scale within the narrow route's bounds
of float64 (tests/test_torch_long_video.py, C=48 at T=2,048); the first
step's gradients of a Gaussian HSMM's parameters at about 1e4 nats a
frame against float64; and the folded partition against the JAX package's
float32 partition at unit scale. Run with -s to print the numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from action_segmentation_tpu.ops import hsmm as jh
from tests.test_hsmm_grad import random_pots_arrays
from tests.test_torch_hsmm_grad import ATOL, GRAD_ATOL, GRAD_RTOL, NAMES, RTOL, arrays_np
from tests.test_torch_long_video import BOUNDS, d300_arrays, gap, value_and_grads

# the narrow route's bounds at C=48, T=2,048 (gap and emit against float64)
LONG_BOUNDS = BOUNDS["C=48 T=2048"]
# the first step's gradients at about 1e4 nats a frame: each within this
# share of its norm of float64's (chip_smoke.py FP64_GRAD_NORM_BOUND, the
# U7 model's first step)
FP64_GRAD_NORM_BOUND = 1e-3


def plain(pots, lengths):
    return hg.hsmm_partition_fast(pots, lengths, hg.PLAIN)


def card_route(pots, lengths):
    """The function the card computes above 128 classes: the Function over
    centred emissions, through the plain versions of its kernels."""
    return hg.hsmm_partition_centred(pots, lengths, plain)


@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_wide_plain_scans_fold(monkeypatch, scale):
    """At C=130 the log and forward scans' plain versions, and the CPU
    wrappers of W1 log and W1 fwd, are ``_scan_plain`` with the fold,
    offsets included; the chains' offsets are non-zero past SCAN_FOLD
    frames. At unit emissions no class's |cum| reaches SCAN_FOLD_LIMIT
    (the same planes with the per-class fold off); at emissions x1,000 (a
    prefix sum's random walk passes 4,096 within a fold's 64 frames) the
    per-class fold fires (other planes)."""
    arrays, lengths = arrays_np(np.random.RandomState(13), 2, 150, 130, 5, constrained=True)
    arrays[3] = arrays[3] * scale
    pots = th.HsmmPotentials(*map(torch.from_numpy, arrays))
    scan_in = hc._stack_fwd_rev(pots, torch.from_numpy(lengths).long().clamp(min=1))
    want = hc._scan_plain(*scan_in, "log", fold=True)
    for got in (hc._log_scan_plain(*scan_in), hc.hsmm_log_scan(*scan_in),
                hc.hsmm_log_scan_wide(*scan_in)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    fwd_in = hc._forward_chains(scan_in, 2)
    fwd_want = hc._scan_plain(*fwd_in, "log", fold=True)[1:]
    for got in (hc._forward_scan_plain(*fwd_in), hc.hsmm_forward_scan(*fwd_in),
                hc.hsmm_forward_scan_wide(*fwd_in)):
        assert all(torch.equal(g, w) for g, w in zip(got, fwd_want))
    offsets = want[2]
    assert offsets.shape == (4, 3) and (offsets[:, 0] == 0).all()
    assert (offsets[:, 1:] != 0).any()
    monkeypatch.setattr(hc, "SCAN_FOLD_LIMIT", float("inf"))
    unlimited = hc._scan_plain(*scan_in, "log", fold=True)
    same = all(torch.equal(g, w) for g, w in zip(unlimited, want))
    assert same == (scale == 1.0)


def test_wide_long_video_against_float64():
    """A 136-class video of 2,048 frames at the D=300 emission scale: the
    card route's marginals (d logZ / d emit) within the narrow route's
    C=48, T=2,048 bounds of the Function's PLAIN path in float64 on the
    uncentred potentials; its backward reads the video in chunks of
    BAND_CHUNK rows."""
    B, T, C, K = 1, 2048, 136, 20
    arrays, lengths = d300_arrays(B, T, C, K), torch.full((B,), T)
    _, exact = value_and_grads(arrays, lengths, plain, torch.float64)
    _, got = value_and_grads(arrays, lengths, card_route)
    assert gap(exact[3], [T]) < 1e-6
    assert all(np.isfinite(g).all() for g in got)
    err = {n: float(np.abs(g - x).max()) for n, g, x in zip(NAMES, got, exact)}
    err["gap"] = gap(got[3], [T])
    print("C={} T={}: {}".format(C, T, err))
    for key, bound in LONG_BOUNDS.items():
        assert err[key] <= bound, key
    pots = th.HsmmPotentials(*map(torch.from_numpy, arrays))
    gamma, alphas, offsets = hc._log_scan_plain(*hc._stack_fwd_rev(pots, lengths))
    lse, _ = hg._log_partition(alphas[:B], offsets[:B], lengths, pots.end_mask)
    gb = hc._grad_band_inputs(pots, lengths, gamma, offsets, lse)
    assert gb.chunks == T // hc.BAND_CHUNK and gb.x_shift is not None


def gaussian_first_step(params, feats, K, dtype, partition):
    """The gradients of sum_b logZ with respect to a Gaussian HSMM's
    parameters (transition and initial logits, Poisson log-rates, means,
    covariance), the potentials built from them in `dtype` by the port's
    distributions; and the DP's mean |emission|."""
    ps = [torch.from_numpy(p).requires_grad_(True) for p in params]
    q = [p.to(dtype) for p in ps]
    B, C = feats.shape[0], params[1].shape[0]
    pots = th.HsmmPotentials(
        transition_log_probs(q[0]).expand(B, C, C), initial_log_probs(q[1]).expand(B, C),
        poisson_length_log_probs(q[2], K).expand(B, K, C),
        gaussian_emission_log_probs(torch.from_numpy(feats).to(dtype), q[3], q[4]),
        torch.zeros((B, C), dtype=dtype))
    partition(pots, torch.full((B,), feats.shape[1])).sum().backward()
    return [p.grad.double().numpy() for p in ps], float(pots.emit.detach().abs().mean())


def test_wide_first_step_at_1e4_nats_against_float64():
    """A 130-class Gaussian HSMM at T=256 whose emissions are about 1e4
    nats a frame (D=300 features 8 times the means' scale, the U7 model's
    scale): the first step's parameter gradients through the card route
    within FP64_GRAD_NORM_BOUND of their norm of the same step with the
    partition in float64."""
    C, T, K, D = 130, 256, 20, 300
    rng = np.random.RandomState(10)
    params = [x.astype(np.float32) for x in (
        rng.randn(C, C), rng.randn(C), rng.randn(C) * 0.3 + 1.5, rng.randn(C, D),
        np.abs(rng.randn(D)) + 0.5)]
    feats = (8 * rng.randn(1, T, D)).astype(np.float32)
    got, scale = gaussian_first_step(params, feats, K, torch.float32, card_route)
    exact, _ = gaussian_first_step(params, feats, K, torch.float64, plain)
    rel = {n: float(np.linalg.norm(g - x) / np.linalg.norm(x))
           for n, g, x in zip(("trans", "init", "rates", "means", "cov"), got, exact)}
    print("C={} T={} at {:.0f} nats a frame: {}".format(C, T, scale, rel))
    assert scale > 9e3
    assert max(rel.values()) <= FP64_GRAD_NORM_BOUND, rel


def test_wide_folded_partition_tracks_jax_at_unit_scale():
    """At unit scale, C=130 over 300 frames (four folds), the port's
    float32 logZ through the Function's PLAIN path is JAX's jnp
    ``hsmm_partition`` within rtol 1e-5 / atol 1e-4, and its gradients
    autograd's of it within rtol 2e-3 / atol 2e-4, the JAX package's
    tolerances."""
    B, T, C, K = 2, 300, 130, 5
    arrays = [np.array(a) for a in random_pots_arrays(np.random.RandomState(C), B, T, C, K)]
    arrays, lengths = arrays[:5], arrays[5]
    lengths[0] = T
    xs = [jnp.asarray(a) for a in arrays]
    want_z = jh.hsmm_partition(jh.HsmmPotentials(*xs), jnp.asarray(lengths))
    want = jax.grad(lambda *xs: jh.hsmm_partition(jh.HsmmPotentials(*xs),
                                                  jnp.asarray(lengths)).sum(),
                    argnums=(0, 1, 2, 3, 4))(*xs)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    L = torch.from_numpy(lengths)
    z = hg.hsmm_partition_fb(*ts, L, kernels=hg.PLAIN)
    z.sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z), rtol=RTOL, atol=ATOL)
    for name, t, w in zip(NAMES, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    pots = th.HsmmPotentials(*(t.detach() for t in ts))
    _, offsets = hc._forward_scan_plain(*hc._forward_chains(
        hc._stack_fwd_rev(pots, L.long()), B))
    assert offsets.shape == (B, 5) and (offsets[0, 1:] != 0).all()
