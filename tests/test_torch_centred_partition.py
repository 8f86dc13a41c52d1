"""The model's log-semiring DP over centred emissions
(``ops.hsmm_grad.centre_emissions``), held against float64.

At the D=300 emission scale (about -500 nats a frame) float32 prefix sums
of emissions reach -5e5 over 1,024 frames, and the partition's gradient
and posteriors, differences of such sums, lose about a nat (ROADMAP.md
§3; ``tests/test_torch_hsmm_grad.py::test_partition_fb_tracks_jax_at_d300_scale``
shows JAX's float32 path losing the same). The model's paths (its
unsupervised and discriminative losses, ``Segmenter.segment_with_marginals``)
shift each frame's emissions by their max over classes first. Here they
run through ``SemiMarkovModel._loss`` and the Segmenter with the module's
potentials replaced by fixed leaves, and their float32 results are held
against the same function in float64 (the Function's PLAIN path on the
uncentred potentials, the exact answer). Up to 128 classes the log scans
also fold their carry every 64 frames and the backward anchors its band
inputs per chunk (ops/hsmm_cuda.py), which keeps a long video near
float64 too (tests/test_torch_long_video.py). On the CPU the model takes the
kernels' plain versions up to 128 classes, which the card's kernels equal
(chip_smoke.py phase 3b), and autograd of the plain partition above.
At unit scale the centred path stays within the JAX package's
tolerances of JAX's float32 partition. Run with -s to print the numbers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.api import Segmenter
from action_segmentation_torch.data.synthetic import SyntheticDatasplit
from action_segmentation_torch.models.semimarkov import SemiMarkovModel
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from action_segmentation_torch.ops.span_codec import labels_to_spans
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_grad as jg
from tests.conftest import make_sm_args
from tests.test_torch_hsmm_grad import (
    ATOL,
    NAMES,
    RTOL,
    arrays_np,
    assert_grads,
    jax_value_and_grads,
    torch_value_and_grads,
)

K, D = 20, 300
# (max |sum_c marginal - 1|, emit, trans, lens) bounds against float64:
# the serving case's, and the video four times as long's
SERVING_BOUNDS = dict(gap=0.01, emit=0.01, trans=0.5, lens=1.0)
LONG_BOUNDS = dict(gap=0.02, emit=0.02)


@functools.lru_cache(maxsize=None)
def d300_arrays(B, T, C, seed=10):
    """Potentials at the D=300 Gaussian emission scale, drawn as in
    test_partition_fb_tracks_jax_at_d300_scale (B=1, T=1024, C=19 is
    that test's input): float32 numpy arrays (trans, init, lens, emit,
    end_mask), each video's own rows."""
    rng = np.random.RandomState(seed)
    feats, means = rng.randn(B, T, D), rng.randn(C, D)
    cov = np.abs(rng.randn(D)) + 0.5
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    pots = [
        transition_log_probs(f32(rng.randn(C, C))).expand(B, C, C),
        initial_log_probs(f32(rng.randn(C))).expand(B, C),
        poisson_length_log_probs(f32(rng.randn(C) * 0.3 + 1.5), K).expand(B, K, C),
        gaussian_emission_log_probs(f32(feats), f32(means), f32(cov)),
        torch.zeros(B, C),
    ]
    return tuple(np.ascontiguousarray(p.numpy()) for p in pots)


def value_and_grads(arrays, lengths, fn, dtype=torch.float32):
    """(fn(pots, lengths) (B,), the five gradients of its sum) on `arrays`
    as `dtype` leaves, as float64 numpy."""
    xs = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    z = fn(th.HsmmPotentials(*xs), lengths)
    z.sum().backward()
    return z.detach().double().numpy(), [x.grad.double().numpy() for x in xs]


def plain(pots, lengths):
    return hg.hsmm_partition_fast(pots, lengths, hg.PLAIN)


@functools.lru_cache(maxsize=None)
def float64_reference(B, T, C):
    """(logZ, the five gradients) of the potentials as they are in float64
    through the Function's PLAIN path: the exact answer."""
    return value_and_grads(d300_arrays(B, T, C), torch.full((B,), T), plain, torch.float64)


def model_with(pots_fn, C, **overrides):
    """A SemiMarkovModel of C classes on the CPU whose module's potentials
    are ``pots_fn(T)`` (an HsmmPotentials), whatever the features."""
    split = SyntheticDatasplit(num_videos=2, n_classes=C, max_len=10, span_k=3, seed=0)
    model = SemiMarkovModel.from_args(make_sm_args(sm_max_span_length=K, **overrides), split,
                                      device="cpu")

    def compute_potentials(features, lengths, vc, cons, end_allowed, *args, **kw):
        B = features.shape[0]
        return pots_fn(features.shape[1]), features.new_zeros(B), features.new_zeros(B)

    model.module.compute_potentials = compute_potentials
    return model


def model_loss_grads(arrays, lengths, use_labels=False, gt=None, dtype=torch.float32,
                     **overrides):
    """(ll (B,), the five gradients of sum_b ll) through the model's
    ``_loss`` with `arrays` as its potentials: loss = -sum(ll) / B."""
    B, T, C = arrays[3].shape
    xs = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    model = model_with(lambda _: th.HsmmPotentials(*xs), C, **overrides)
    ar = torch.arange(C)
    gt = torch.zeros((B, T), dtype=torch.long) if gt is None else gt
    loss, _ = model._loss(torch.zeros((B, T, 1), dtype=dtype), lengths, ar, ar, gt,
                          torch.zeros((B, T, C), dtype=dtype), torch.zeros((B, C), dtype=dtype),
                          torch.ones(B, dtype=dtype), use_labels)
    loss.backward()
    return -B * loss.detach().double().numpy(), [-B * x.grad.double().numpy() for x in xs]


def gap(marg, lengths):
    return max(float(np.abs(marg[b, :L].sum(-1) - 1).max()) for b, L in enumerate(lengths))


def errors(grads, exact):
    return {n: float(np.abs(g - x).max()) for n, g, x in zip(NAMES, grads, exact)}


def test_float64_yardstick_is_jax_float64():
    """The float64 answer the centred path is held against, the port's
    PLAIN Function on the serving case, is JAX's own partition and
    autodiff gradients in float64 (x64 as a context, not the global flag)."""
    B, T, C = 1, 1024, 19
    with jax.enable_x64(True):
        xs = [jnp.asarray(a, jnp.float64) for a in d300_arrays(B, T, C)]
        L = jnp.full((B,), T, jnp.int32)
        z, grads = jax.value_and_grad(
            lambda *xs: jh.hsmm_partition(jh.HsmmPotentials(*xs), L).sum(),
            argnums=(0, 1, 2, 3, 4))(*xs)
        assert z.dtype == jnp.float64
        z, grads = float(z), [np.asarray(g) for g in grads]
    exact_z, exact = float64_reference(B, T, C)
    np.testing.assert_allclose(exact_z, z, rtol=1e-12)
    for name, g, x in zip(NAMES, grads, exact):
        np.testing.assert_allclose(x, g, rtol=1e-7, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("T", [1024, 4096])
def test_unsupervised_loss_and_grads_against_float64(T):
    """The serving case (B=1, T=1024, C=19, K=20, D=300, seed 10) and a
    video four times as long, through the model's unsupervised loss."""
    B, C = 1, 19
    arrays, lengths = d300_arrays(B, T, C), torch.full((B,), T)
    exact_z, exact = float64_reference(B, T, C)
    got_z, got = model_loss_grads(arrays, lengths)
    _, old = value_and_grads(arrays, lengths, hg.hsmm_partition_fast)
    err, old_err = errors(got, exact), errors(old, exact)
    gaps = dict(centred=gap(got[3], [T]), uncentred=gap(old[3], [T]),
                float64=gap(exact[3], [T]))
    print("T={} gaps {}\n centred errors {}\n uncentred errors {}".format(T, gaps, err,
                                                                         old_err))
    assert gaps["float64"] < 1e-6
    assert np.isfinite(got_z).all() and all(np.isfinite(g).all() for g in got)
    if T == 1024:
        assert gaps["centred"] <= SERVING_BOUNDS["gap"] < gaps["uncentred"]
        for name in ("emit", "trans", "lens"):
            assert err[name] <= SERVING_BOUNDS[name] and err[name] < old_err[name], name
        # logZ: JAX's float32 value at the value tolerance, and nearer float64
        want_z = np.asarray(jg.hsmm_partition_fb(*map(jnp.asarray, arrays),
                                                 jnp.full(B, T, jnp.int32), True))
        np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
        print(" logZ error: centred {}, JAX {}".format(abs(got_z - exact_z).max(),
                                                      abs(want_z - exact_z).max()))
        assert abs(got_z - exact_z).max() < abs(want_z - exact_z).max()
    else:
        # both against float64: within the bounds, and nearer than uncentred
        assert gaps["centred"] <= LONG_BOUNDS["gap"] and gaps["centred"] < gaps["uncentred"]
        assert err["emit"] <= LONG_BOUNDS["emit"] and err["emit"] < old_err["emit"]


@pytest.mark.parametrize("T", [1024, 4096])
def test_segment_with_marginals_against_float64(T):
    """Segmenter.segment_with_marginals over the same potentials: the
    posteriors of the centred emissions, labels from the unchanged
    decode (equal to segment's)."""
    B, C = 1, 19
    arrays = d300_arrays(B, T, C)
    _, exact = float64_reference(B, T, C)

    def pots_fn(Tpad):
        xs = [torch.from_numpy(a) for a in arrays]
        xs[3] = torch.cat([xs[3], xs[3].new_zeros((B, Tpad - T, C))], dim=1)
        return th.HsmmPotentials(*xs)

    seg = Segmenter(model_with(pots_fn, C))
    features = np.zeros((T, 1), np.float32)
    labels, marg = seg.segment_with_marginals(features)
    assert marg.shape == (T, C) and np.isfinite(marg).all()
    g, err = gap(marg[None], [T]), float(np.abs(marg - exact[3][0]).max())
    print("T={} segment_with_marginals: gap {}, |marginal - float64| {}".format(T, g, err))
    if T == 1024:
        assert g <= SERVING_BOUNDS["gap"] and err <= SERVING_BOUNDS["emit"]
    else:
        assert g <= LONG_BOUNDS["gap"] and err <= LONG_BOUNDS["emit"]
    np.testing.assert_array_equal(labels, seg.segment(features))


@pytest.mark.parametrize("route", ["model", "function"])
def test_wide_case_against_float64(route):
    """160 classes at T=1024: the model's loss (on the CPU, autograd of the
    plain partition) and the Function's PLAIN path, the plain versions of
    the wide kernels the card runs there, each over centred emissions;
    uncentred, the gap is about 20 times larger."""
    B, T, C = 1, 1024, 160
    arrays, lengths = d300_arrays(B, T, C), torch.full((B,), T)
    _, exact = float64_reference(B, T, C)
    if route == "model":
        _, got = model_loss_grads(arrays, lengths)
        _, old = value_and_grads(arrays, lengths, th.hsmm_partition)
    else:
        _, got = value_and_grads(arrays, lengths,
                                 lambda pots, L: hg.hsmm_partition_centred(pots, L, plain))
        _, old = value_and_grads(arrays, lengths, plain)
    gaps = dict(centred=gap(got[3], [T]), uncentred=gap(old[3], [T]))
    print("C={} {}: gaps {}, emit errors centred {} uncentred {}".format(
        C, route, gaps, errors(got, exact)["emit"], errors(old, exact)["emit"]))
    assert 10 * gaps["centred"] <= gaps["uncentred"]
    assert 10 * errors(got, exact)["emit"] <= errors(old, exact)["emit"]


def gold_labels(B, T, C, seed=3):
    """(B, T) labels of spans of 5-15 frames (within the band of K=20) in
    random classes."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, T), np.int64)
    for b in range(B):
        t = 0
        while t < T:
            d = rng.randint(5, 16)
            out[b, t:t + d] = rng.randint(C)
            t += d
    return torch.from_numpy(out)


def test_discriminative_loss_offsets_cancel():
    """gold(centred) - logZ(centred) at the serving scale: in float64 the
    model's value is gold - logZ of the potentials as they are (the two
    offsets cancel), and in float32 it and its gradients (logZ's minus
    the gold path's indicators) stay near float64 where the uncentred
    difference of two -5e5 numbers does not."""
    B, T, C = 1, 1024, 19
    arrays, lengths = d300_arrays(B, T, C), torch.full((B,), T)
    gt = gold_labels(B, T, C)
    disc = dict(use_labels=True, gt=gt, sm_supervised_method="gradient-based",
                sm_train_discriminatively=True)
    got_ll, got = model_loss_grads(arrays, lengths, **disc)
    ll64, g64 = model_loss_grads(arrays, lengths, dtype=torch.float64, **disc)

    def log_prob(partition):
        return lambda pots, L: (th.hsmm_gold_score(pots, L, labels_to_spans(gt, K))
                                - partition(pots, L))

    exact_ll, exact = value_and_grads(arrays, lengths, log_prob(plain), torch.float64)
    np.testing.assert_allclose(ll64, exact_ll, rtol=1e-12, atol=1e-6)
    for g, x in zip(g64, exact):
        np.testing.assert_allclose(g, x, rtol=1e-9, atol=1e-9)
    old_ll, old = value_and_grads(arrays, lengths, log_prob(hg.hsmm_partition_fast))
    err, old_err = errors(got, exact), errors(old, exact)
    ll_err = float(np.abs(got_ll - exact_ll).max())
    old_ll_err = float(np.abs(old_ll - exact_ll).max())
    print("discriminative ll error: centred {}, uncentred {}\n centred errors {}\n "
          "uncentred errors {}".format(ll_err, old_ll_err, err, old_err))
    assert ll_err < old_ll_err
    for name in ("emit", "trans", "lens"):
        assert err[name] <= SERVING_BOUNDS[name] and err[name] < old_err[name], name


def test_centring_keeps_masks_lengths_and_views():
    """Ragged lengths with garbage past them, a frame the constraints mask
    everywhere, a frame masked in some classes, class-bucket padding (a
    duplicated column) and expanded trans/init/lens: the offset sums
    c over real frames only, padding stays as it was, masked entries
    stay masked, the views stay views, and in float64 logZ(centred) +
    offset is logZ of the potentials as they are."""
    rng = np.random.RandomState(4)
    B, T, C, Kb = 3, 40, 6, 5
    lengths = torch.tensor([40, 23, 1])
    emit = torch.from_numpy(rng.randn(B, T, C) * 30 - 400)
    emit[:, :, -1] = emit[:, :, 0]  # a padded class gathers class 0's emission
    emit[1, 23:] = 1e3  # garbage past a length
    emit[0, 7] += BIG_NEG  # masked everywhere
    emit[0, 11, :3] += BIG_NEG  # masked in some classes
    trans = torch.log_softmax(torch.from_numpy(rng.randn(C, C)), 0).expand(B, C, C)
    init = torch.log_softmax(torch.from_numpy(rng.randn(C)), 0).expand(B, C)
    lens = torch.from_numpy(rng.randn(Kb, C)).expand(B, Kb, C).clone()
    lens[:, 0] = BIG_NEG
    lens = lens[:1].expand(B, Kb, C)
    pots = th.HsmmPotentials(trans, init, lens, emit, torch.zeros(B, C))
    centred, offset = hg.centre_emissions(pots, lengths)

    for name in ("trans", "init", "lens", "end_mask"):
        assert getattr(centred, name) is getattr(pots, name), name
    assert centred.trans.stride(0) == 0 and centred.lens.stride(0) == 0
    want_c = np.zeros((B, T))
    e = emit.numpy()
    for b, L in enumerate(lengths.tolist()):
        for t in range(L):
            live = e[b, t][e[b, t] > BIG_NEG / 2]
            want_c[b, t] = live.max() if live.size else 0.0
    np.testing.assert_array_equal(offset.numpy(), want_c.sum(1))
    assert offset.dtype == torch.float64
    np.testing.assert_array_equal(centred.emit[1, 23:].numpy(), e[1, 23:])
    assert (centred.emit[0, 7] < BIG_NEG / 2).all()
    assert (centred.emit[0, 11, :3] < BIG_NEG / 2).all()
    # every real frame with a live entry has a best class at 0
    real = torch.arange(T)[None, :] < lengths[:, None]
    real[0, 7] = False
    best = centred.emit.masked_fill(centred.emit < BIG_NEG / 2, -np.inf).amax(-1)
    assert (best[real] == 0).all()

    # the shift is exact: the same logZ in float64, masked frame included
    want = plain(pots, lengths)
    got = hg.hsmm_partition_centred(pots, lengths, plain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        hg.hsmm_partition_centred(pots, lengths, th.hsmm_partition).numpy(), want.numpy(),
        rtol=1e-12)


@pytest.mark.parametrize(
    "B,T,C,Kb,constrained",
    [
        (1, 12, 4, 4, False),
        (3, 20, 5, 6, True),
        (7, 24, 19, 8, False),
    ],
)
def test_centred_partition_tracks_jax_at_unit_scale(B, T, C, Kb, constrained):
    """At unit scale the centred logZ is JAX's float32 logZ within rtol
    1e-5 / atol 1e-4 and its gradients JAX's within rtol 2e-3 / atol 2e-4,
    the tolerances of test_partition_fb_value_and_grads_match_jax."""
    arrays, lengths = arrays_np(np.random.RandomState(B * 7 + C), B, T, C, Kb, constrained)
    want_z, want = jax_value_and_grads(arrays, lengths)
    got_z, got = torch_value_and_grads(arrays, lengths, hg.hsmm_partition_centred)
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    assert_grads(got, want)
