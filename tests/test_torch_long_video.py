"""Long videos through the port's log-semiring DP, held against float64.

The log scans (K2 log, K1; their plain versions on the CPU) fold their
carry every SCAN_FOLD frames: the carry takes in the emission prefix sum
and gives up the step's best alpha, which the chain's offsets keep, so
that the planes stay near 0 however long the video (ops/hsmm_cuda.py
``_scan_plain``). logZ adds the offset back in float64, and the backward
forms K4's inputs from float64 pieces anchored per chunk of at most
BAND_CHUNK rows (``_grad_band_inputs``). Here the model's path (its
unsupervised loss through ``SemiMarkovModel._loss`` and
``Segmenter.segment_with_marginals``, over centred emissions) at the D=300
emission scale is held against the Function's PLAIN path in float64 on the
uncentred potentials (the exact answer) at 1,024, 4,096 and 12,000 frames,
two and four warps' widths and a band past the carry's 24 register rows;
the offsets at ragged lengths; T <= SCAN_FOLD against the scan before the
fold, bit for bit; JAX's float32 partition at unit scale with folds in
play; the chunks against one chunk in float64; the wide chains, which fold
and chunk as the narrow ones (tests/test_torch_wide_long_video.py holds
them against float64), and decode's max chains, which do not fold. Run
with -s to print the numbers.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.api import Segmenter
from action_segmentation_torch.data.synthetic import SyntheticDatasplit
from action_segmentation_torch.models.semimarkov import SemiMarkovModel
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from tests.conftest import make_sm_args
from tests.test_torch_hsmm_grad import (
    ATOL,
    GRAD_ATOL,
    GRAD_RTOL,
    NAMES,
    RTOL,
    arrays_np,
    assert_grads,
    jax_value_and_grads,
    torch_value_and_grads,
)

D = 300
# the model path's bounds against float64: (max |sum_c marginal - 1|,
# emit[, trans, lens]) by case
BOUNDS = {
    "serving T=1024": dict(gap=0.01, emit=0.01, trans=0.5, lens=1.0),
    "T=4096": dict(gap=0.02, emit=0.02),
    "B=2 T=12000": dict(gap=0.05, emit=0.05),
    "C=48 T=2048": dict(gap=0.02, emit=0.02),
    "K=40 T=2048": dict(gap=0.02, emit=0.02),
}


@functools.lru_cache(maxsize=None)
def case_arrays(name):
    """(float32 numpy arrays (trans, init, lens, emit, end_mask), lengths)
    of a case: the D=300 draws of tests/test_torch_centred_partition.py
    (seed 10), or chip_smoke.serving_pots's B=2, lengths (12000, 7001)
    (seed 0, emissions zeroed past each length)."""
    if name == "B=2 T=12000":
        pots, L = chip_smoke.serving_pots(np.random.RandomState(0), 2, 12000, 19, 20,
                                          torch.device("cpu"),
                                          lengths=np.array([12000, 7001], np.int32))
        return tuple(np.ascontiguousarray(x.numpy()) for x in pots), tuple(L.tolist())
    B, T, C, K = {"serving T=1024": (1, 1024, 19, 20), "T=4096": (1, 4096, 19, 20),
                  "C=48 T=2048": (1, 2048, 48, 20), "K=40 T=2048": (1, 2048, 19, 40)}[name]
    return d300_arrays(B, T, C, K), (T,) * B


def d300_arrays(B, T, C, K, seed=10):
    """Potentials at the D=300 Gaussian emission scale (the draws of
    tests/test_torch_centred_partition.py's ``d300_arrays`` at band K)."""
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
    """(fn(pots, lengths) (B,), the five gradients of its sum), float64 numpy."""
    xs = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    z = fn(th.HsmmPotentials(*xs), lengths)
    z.sum().backward()
    return z.detach().double().numpy(), [
        np.zeros(a.shape) if x.grad is None else x.grad.double().numpy()
        for a, x in zip(arrays, xs)]


def plain(pots, lengths):
    return hg.hsmm_partition_fast(pots, lengths, hg.PLAIN)


@functools.lru_cache(maxsize=None)
def float64_reference(name):
    arrays, lengths = case_arrays(name)
    return value_and_grads(arrays, torch.tensor(lengths), plain, torch.float64)


def model_with(pots_fn, C, K):
    """A SemiMarkovModel of C classes and band K on the CPU whose module's
    potentials are ``pots_fn(T)``, whatever the features."""
    split = SyntheticDatasplit(num_videos=2, n_classes=C, max_len=10, span_k=3, seed=0)
    model = SemiMarkovModel.from_args(make_sm_args(sm_max_span_length=K), split, device="cpu")

    def compute_potentials(features, lengths, vc, cons, end_allowed, *args, **kw):
        B = features.shape[0]
        return pots_fn(features.shape[1]), features.new_zeros(B), features.new_zeros(B)

    model.module.compute_potentials = compute_potentials
    return model


def model_loss_grads(arrays, lengths):
    """The five gradients of sum_b ll through the model's unsupervised
    ``_loss`` with `arrays` as its potentials (loss = -sum(ll) / B)."""
    B, T, C = arrays[3].shape
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    model = model_with(lambda _: th.HsmmPotentials(*xs), C, arrays[2].shape[1])
    ar = torch.arange(C)
    loss, _ = model._loss(torch.zeros((B, T, 1)), lengths, ar, ar,
                          torch.zeros((B, T), dtype=torch.long), torch.zeros((B, T, C)),
                          torch.zeros((B, C)), torch.ones(B), False)
    loss.backward()
    return [-B * x.grad.double().numpy() for x in xs]


def gap(marg, lengths):
    return max(float(np.abs(marg[b, :L].sum(-1) - 1).max()) for b, L in enumerate(lengths))


@pytest.mark.parametrize("name", list(BOUNDS))
def test_model_loss_against_float64(name):
    """The model's unsupervised loss: its frame marginals' gap and each
    gradient's error against float64 within the case's bounds."""
    arrays, lengths = case_arrays(name)
    _, exact = float64_reference(name)
    got = model_loss_grads(arrays, torch.tensor(lengths))
    assert gap(exact[3], lengths) < 1e-6
    assert all(np.isfinite(g).all() for g in got)
    err = {n: float(np.abs(g - x).max()) for n, g, x in zip(NAMES, got, exact)}
    err["gap"] = gap(got[3], lengths)
    print("{}: {}".format(name, err))
    for key, bound in BOUNDS[name].items():
        assert err[key] <= bound, key


@pytest.mark.parametrize("name", ["serving T=1024", "B=2 T=12000"])
def test_segment_with_marginals_against_float64(name):
    """Segmenter.segment_with_marginals on the case's first video: its
    posteriors within the case's bounds of float64."""
    arrays, lengths = case_arrays(name)
    T, C = lengths[0], arrays[3].shape[-1]
    first = [a[:1] for a in arrays]
    first[3] = first[3][:, :T]
    _, exact = float64_reference(name)

    def pots_fn(Tpad):
        xs = [torch.from_numpy(a) for a in first]
        xs[3] = torch.cat([xs[3], xs[3].new_zeros((1, Tpad - T, C))], dim=1)
        return th.HsmmPotentials(*xs)

    seg = Segmenter(model_with(pots_fn, C, arrays[2].shape[1]))
    _, marg = seg.segment_with_marginals(np.zeros((T, 1), np.float32))
    assert marg.shape == (T, C) and np.isfinite(marg).all()
    g, err = gap(marg[None], [T]), float(np.abs(marg - exact[3][0, :T]).max())
    print("{} segment_with_marginals: gap {}, |marginal - float64| {}".format(name, g, err))
    assert g <= BOUNDS[name]["gap"] and err <= BOUNDS[name]["emit"]


def test_ragged_lengths_pick_each_videos_offset():
    """Videos of 1, 63, 64, 65 and 1,000 frames in one batch at an
    emission scale whose offsets reach thousands: each video's logZ is its
    own (the same bits as the video alone, whose scan folds at the same
    steps) and float64's, and the gradients are float64's within the
    JAX package's gradient tolerance."""
    lengths = np.array([1, 63, 64, 65, 1000])
    arrays, _ = arrays_np(np.random.RandomState(5), 5, 1000, 7, 9, constrained=True)
    arrays[3] = arrays[3] - 30.0  # -30 nats a frame: offsets of -2,000 a fold
    L = torch.from_numpy(lengths)
    got_z, got = value_and_grads(arrays, L, hg.hsmm_partition_fast)
    exact_z, exact = value_and_grads(arrays, L, plain, torch.float64)
    np.testing.assert_allclose(got_z, exact_z, rtol=1e-6)
    for b, n in enumerate(lengths):
        alone = [a[b:b + 1] for a in arrays]
        alone[3] = alone[3][:, :n]
        z, _ = value_and_grads(alone, torch.tensor([n]), hg.hsmm_partition_fast)
        assert z[0] == got_z[b], (n, z[0], got_z[b])
    for name, g, x in zip(NAMES, got, exact):
        np.testing.assert_allclose(g, x, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


def pr21_scan(trans, init, dur, emit, semiring):
    """The scan as it was before the fold, written out: (gamma, alphas)."""
    N, T, C = emit.shape
    trans = hc._dense_trans(trans)
    W = torch.full((N, dur.shape[1], C), BIG_NEG, dtype=emit.dtype)
    W[:, 0] = init
    cum = torch.zeros((N, C), dtype=emit.dtype)
    gammas, alphas = [], []
    for t in range(T):
        cum = cum + emit[:, t]
        alpha = hc._reduce(W + dur, 1, semiring) + cum
        gamma = hc._reduce(trans + alpha[:, None, :], 2, semiring)
        W = torch.cat([(gamma - cum)[:, None], W[:, :-1]], dim=1)
        gammas.append(gamma)
        alphas.append(alpha)
    return torch.stack(gammas, dim=1), torch.stack(alphas, dim=1)


@pytest.mark.parametrize("T", [2, 63, 64])
def test_no_fold_up_to_scan_fold_steps(T):
    """At T <= SCAN_FOLD, with every |cum| under SCAN_FOLD_LIMIT, nothing
    folds: the log scans' planes are the scan's before the fold bit for
    bit, their offsets 0, logZ the LSE of its finals, bit for bit, and the
    backward's band inputs the float32 ones of ``_band_inputs`` with -logZ
    on G1, as before the fold."""
    arrays, lengths = arrays_np(np.random.RandomState(T), 3, T, 6, 5, constrained=True)
    arrays[3] = arrays[3] * 50.0
    pots = th.HsmmPotentials(*map(torch.from_numpy, arrays))
    L = torch.from_numpy(lengths).long().clamp(min=1)
    scan_in = hc._stack_fwd_rev(pots, L)
    gamma, alphas, offsets = hc.hsmm_log_scan(*scan_in)
    want_gamma, want_alphas = pr21_scan(*scan_in, "log")
    assert torch.equal(gamma, want_gamma) and torch.equal(alphas, want_alphas)
    assert offsets.shape == (6, 1) and (offsets == 0).all()
    fwd, fwd_offsets = hc.hsmm_forward_scan(*hc._forward_chains(scan_in, 3))
    assert torch.equal(fwd, want_alphas[:3]) and (fwd_offsets == 0).all()
    with torch.no_grad():
        z = hg.hsmm_partition_fast(pots, L)
    lse = torch.logsumexp(th._finals(want_alphas[:3], L, pots.end_mask), -1)
    assert torch.equal(z, lse)
    assert float(th._emission_cumsum(pots.emit).abs().max()) < hc.SCAN_FOLD_LIMIT
    gb = hc._grad_band_inputs(pots, L, gamma, offsets, lse)
    G1, G2p, band = hc._band_inputs(pots, L, want_gamma)
    assert gb.chunks == 1 and gb.x_shift is None
    assert torch.equal(gb.G1m, G1 - lse[:, None, None]) and torch.equal(gb.G2p, G2p)


@pytest.mark.parametrize("B,T,C,K", [(3, 300, 5, 6), (2, 300, 19, 8)])
def test_folded_partition_tracks_jax_at_unit_scale(B, T, C, K):
    """At unit scale over 300 frames (four folds) the port's float32 logZ
    is JAX's within rtol 1e-5 / atol 1e-4 and its gradients JAX's within
    rtol 2e-3 / atol 2e-4, the JAX package's tolerances."""
    arrays, lengths = arrays_np(np.random.RandomState(B * 11 + C), B, T, C, K, True)
    lengths[0] = T
    want_z, want = jax_value_and_grads(arrays, lengths)
    got_z, got = torch_value_and_grads(arrays, lengths)
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    assert_grads(got, want)


@pytest.mark.parametrize("K", [1, 6, 30])
def test_band_chunks_equal_one_chunk_in_float64(monkeypatch, K):
    """The backward over chunks of 16 rows (each with its Km-row halo, a
    halo past the next chunk at K = 30, an empty band at K = 1) at ragged
    lengths equals the backward over one chunk, in float64; the chunks'
    inputs are contiguous, as K4 takes them."""
    arrays, lengths = arrays_np(np.random.RandomState(K), 4, 100, 5, K, constrained=True)
    lengths[:3] = (100, 17, 1)
    L = torch.from_numpy(lengths)
    one_z, one = value_and_grads(arrays, L, plain, torch.float64)
    monkeypatch.setattr(hc, "BAND_CHUNK", 16)
    pots = th.HsmmPotentials(*(torch.from_numpy(a).double() for a in arrays))
    pots = pots._replace(lens=pots.lens[:1].expand_as(pots.lens))  # as a model gives it
    gamma, _, offsets = hc._log_scan_plain(*hc._stack_fwd_rev(pots, L.long()))
    gb = hc._grad_band_inputs(pots, L.long(), gamma, offsets, torch.zeros(4, dtype=torch.float64))
    assert gb.chunks == 7 and gb.G1m.shape[:2] == (28, 16 + K - 1)
    assert all(x.is_contiguous() for x in gb[:3])  # as the kernel takes them
    z, got = value_and_grads(arrays, L, plain, torch.float64)
    np.testing.assert_array_equal(z, one_z)
    for name, g, x in zip(NAMES, got, one):
        np.testing.assert_allclose(g, x, rtol=1e-9, atol=1e-12, err_msg=name)


def test_a_videos_gradient_does_not_depend_on_its_batch(monkeypatch):
    """A video's logZ and gradients are the same alone and in a batch
    padded to another length and chunk count (chunks of 256 rows from its
    first frame: 5 alone, 12 in the batch), as data parallelism's shares
    and the whole batch take them."""
    monkeypatch.setattr(hc, "BAND_CHUNK", 256)
    arrays, lengths = case_arrays("T=4096")
    first = [a[:, :1100] if a.ndim == 3 and a.shape[1] == 4096 else a for a in arrays]
    z_alone, g_alone = value_and_grads(first, torch.tensor([1100]), hg.hsmm_partition_centred)
    batch = [np.concatenate([a, a]) if a.ndim > 1 else a for a in arrays]
    batch[3] = batch[3][:, :3000].copy()
    z, g = value_and_grads(batch, torch.tensor([1100, 3000]), hg.hsmm_partition_centred)
    np.testing.assert_array_equal(z[0], z_alone[0])
    for name, x, y in zip(NAMES, g_alone, g):
        y = y[:1, :1100] if name == "emit" else y[:1]
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=name)


def test_wide_and_decode_chains_do_not_fold():
    """Above 128 classes the log scans fold as the narrow ones do (the
    plain scan with the fold, non-zero offsets past SCAN_FOLD frames, logZ
    the finals' LSE plus the offset) and the backward reads chunks of
    BAND_CHUNK rows anchored in float64, as the narrow route's; the max
    scans of decode (the wide backpointer scan, the narrow gamma scan) are
    the scan before the fold at any T."""
    arrays, lengths = arrays_np(np.random.RandomState(3), 2, 80, 130, 4, constrained=True)
    lengths[0] = 80
    pots = th.HsmmPotentials(*map(torch.from_numpy, arrays))
    L = torch.from_numpy(lengths).long().clamp(min=1)
    scan_in = hc._stack_fwd_rev(pots, L)
    gamma, alphas, offsets = hc.hsmm_log_scan(*scan_in)
    want = hc._scan_plain(*scan_in, "log", fold=True)
    assert all(torch.equal(g, w) for g, w in zip((gamma, alphas, offsets), want))
    assert offsets.shape == (4, 2) and (offsets[:, 0] == 0).all() and offsets[0, 1] != 0
    lse, logZ = hg._log_partition(alphas[:2], offsets[:2], L, pots.end_mask)
    assert torch.equal(logZ, lse.double() + hc.chain_offsets(offsets[:2], L - 1))
    gb = hc._grad_band_inputs(pots, L, gamma, offsets, lse)
    assert gb.chunks == 5 and gb.chunk == hc.BAND_CHUNK and gb.x_shift is not None
    assert gb.G1m.shape == (10, hc.BAND_CHUNK + 3, 130)

    fwd = tuple(x.contiguous() for x in hc._forward_chains(scan_in, 2))
    vit_alphas, _ = hc.hsmm_viterbi_scan(*fwd)
    assert torch.equal(vit_alphas, hc._scan_plain(*fwd, "max")[1])
    narrow = th.HsmmPotentials(*map(torch.from_numpy, arrays_np(
        np.random.RandomState(4), 2, 200, 7, 5, constrained=True)[0]))
    narrow_in = hc._stack_fwd_rev(narrow, L)
    gamma, _ = hc.hsmm_gamma_scan(*narrow_in)
    assert torch.equal(gamma, pr21_scan(*narrow_in, "max")[0])
