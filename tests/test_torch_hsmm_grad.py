"""The partition's kernel forward/backward (ops/hsmm_grad.py), the training
kernels' plain versions and the gold score, against the JAX package.

On the CPU the wrappers run their kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_hsmm_grad.py
does. Same numpy inputs on both sides. Tolerances are the JAX package's:
values (partitions, scan planes, band sweeps, gold scores) rtol 1e-5 /
atol 1e-4 (tests/test_hsmm_pallas.py); gradients and marginals rtol 2e-3
/ atol 2e-4 (tests/test_hsmm_grad.py). The kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_torch.ops.span_codec import labels_to_spans
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_grad as jg
from action_segmentation_tpu.ops import hsmm_pallas as hp
from action_segmentation_tpu.ops import span_codec as jsc
from tests.test_hsmm_grad import random_pots_arrays

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
NAMES = ("trans", "init", "lens", "emit", "end_mask")


def arrays_np(rng, B, T, C, K, constrained=False):
    """The JAX gradient test's draw, as numpy (float32) and lengths."""
    *arrays, lengths = random_pots_arrays(rng, B, T, C, K, constrained=constrained)
    return [np.array(a) for a in arrays], np.array(lengths)


def jax_value_and_grads(arrays, lengths):
    def loss(*xs):
        return jg.hsmm_partition_fb(*xs, jnp.asarray(lengths), True).sum()

    xs = [jnp.asarray(a) for a in arrays]
    z = jg.hsmm_partition_fb(*xs, jnp.asarray(lengths), True)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*xs)
    return np.asarray(z), [np.asarray(g) for g in grads]


def torch_value_and_grads(arrays, lengths, fn=None):
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]
    L = torch.from_numpy(lengths)
    if fn is None:
        z = hg.hsmm_partition_fb(*xs, L)
    else:
        z = fn(th.HsmmPotentials(*xs), L)
    z.sum().backward()
    return z.detach().numpy(), [
        np.zeros_like(a) if x.grad is None else x.grad.numpy() for a, x in zip(arrays, xs)
    ]


def assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize(
    "B,T,C,K,constrained",
    [
        (1, 12, 4, 4, False),
        (3, 20, 5, 6, True),
        (7, 24, 19, 8, False),  # JAX packs 6 videos per lane group
    ],
)
def test_partition_fb_value_and_grads_match_jax(B, T, C, K, constrained):
    arrays, lengths = arrays_np(np.random.RandomState(B * 7 + C), B, T, C, K, constrained)
    want_z, want = jax_value_and_grads(arrays, lengths)
    got_z, got = torch_value_and_grads(arrays, lengths)
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    assert_grads(got, want)


def test_partition_fb_unpacked_fallback_twin(monkeypatch):
    """Twin of the JAX long-T fallback test: with the packed-combine gate
    forced shut, JAX combines the cotangents per video in jnp from its
    alphas planes; the port, which has no gate, must match."""
    monkeypatch.setattr(hp, "_PACKED_COMBINE_BYTE_CEILING", 0)
    calls = []
    fb = jg.hsmm_alphas_fb_pallas
    monkeypatch.setattr(jg, "hsmm_alphas_fb_pallas",
                        lambda *a, **k: calls.append(1) or fb(*a, **k))
    B, T, C, K = 2, 23, 6, 5  # unique shape: traced under this gate
    arrays, lengths = arrays_np(np.random.RandomState(29), B, T, C, K, constrained=True)
    want_z, want = jax_value_and_grads(arrays, lengths)
    assert calls, "the JAX partition did not take the unpacked fallback"
    got_z, got = torch_value_and_grads(arrays, lengths)
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    assert_grads(got, want)


def masked_transition_arrays():
    """tests/test_hsmm_grad.py test_grads_finite_with_masked_transitions."""
    B, T, C, K = 1, 20, 3, 6
    trans = np.full((B, C, C), np.log(0.5), np.float32)
    trans[:, 1, 0] = -1e9  # forbid 0 -> 1
    init = np.zeros((B, C), np.float32)
    lens = np.zeros((B, K, C), np.float32)
    lens[:, 0] = -1e9
    emit = np.full((B, T, C), -200.0, np.float32)
    emit[:, :10, 0] = 0.0
    emit[:, 10:, 1] = 0.0
    end_mask = np.zeros((B, C), np.float32)
    return [trans, init, lens, emit, end_mask], np.full(B, T, np.int32)


def test_grads_finite_with_masked_transitions_twin():
    """A BIG_NEG-masked transition that the emission-optimal path wants:
    finite gradients equal to autograd of the plain scan and to JAX's."""
    arrays, lengths = masked_transition_arrays()
    got_z, got = torch_value_and_grads(arrays, lengths)
    for name, g in zip(NAMES, got):
        assert np.isfinite(g).all(), name
    want_z, want = torch_value_and_grads(arrays, lengths, th.hsmm_partition)
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    assert_grads(got, want)
    _, jax_grads = jax_value_and_grads(arrays, lengths)
    assert_grads(got, jax_grads)


def test_fast_marginals_match_autodiff_twin():
    arrays, lengths = arrays_np(np.random.RandomState(5), 3, 18, 4, 5)
    pots = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    L = torch.from_numpy(lengths)
    got = hg.hsmm_frame_marginals_fast(pots, L).numpy()
    np.testing.assert_allclose(got, th.hsmm_frame_marginals(pots, L).numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    jp = jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays])
    want = np.asarray(jg.hsmm_frame_marginals_fast(jp, jnp.asarray(lengths), interpret=True))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(
        th.hsmm_frame_marginals(pots, L).numpy(),
        np.asarray(jh.hsmm_frame_marginals(jp, jnp.asarray(lengths))),
        rtol=GRAD_RTOL, atol=GRAD_ATOL,
    )


def test_frame_marginals_sum_to_one_twin():
    arrays, lengths = arrays_np(np.random.RandomState(0), 2, 16, 4, 5)
    pots = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    marg = hg.hsmm_frame_marginals_fast(pots, torch.from_numpy(lengths)).numpy()
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(marg[b, :L].sum(axis=1), 1.0, atol=1e-4)
        np.testing.assert_allclose(marg[b, L:], 0.0, atol=1e-5)


def test_k1_guard_lens_grad_is_zero():
    """A one-row duration table (no representable duration): lens comes
    back as (B, K, C) zeros and nothing is NaN; logZ is the plain DP's."""
    arrays, lengths = arrays_np(np.random.RandomState(8), 3, 10, 4, 1)
    got_z, got = torch_value_and_grads(arrays, lengths)
    assert got[2].shape == (3, 1, 4) and (got[2] == 0).all()
    for name, g in zip(NAMES, got):
        assert not np.isnan(g).any(), name
    want = th.hsmm_partition(th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays]),
                             torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got_z, want, rtol=RTOL)


def test_primal_takes_the_forward_scan_and_the_gradient_the_pair():
    """Without gradients the partition runs the forward-only scan alone;
    with them, the stacked log scan forward and one band sweep and one
    pair sum backward."""
    calls = []

    def spy(name, fn):
        return lambda *a: calls.append(name) or fn(*a)

    kernels = hg.FbKernels(*(spy(n, f) for n, f in zip(hg.PLAIN._fields, hg.PLAIN)))
    arrays, lengths = arrays_np(np.random.RandomState(2), 3, 14, 5, 4)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    L = torch.from_numpy(lengths)
    with torch.no_grad():
        primal = hg.hsmm_partition_fb(*xs, L, kernels)
    assert calls == ["forward_scan"]
    z = hg.hsmm_partition_fb(*xs, L, kernels)
    assert calls[1:] == ["log_scan"]
    z.sum().backward()
    assert calls[1:] == ["log_scan", "band_grad", "pair_grad"]
    np.testing.assert_allclose(primal.numpy(), z.detach().numpy(), rtol=RTOL, atol=ATOL)
    before = (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches,
              hc.hsmm_band_grad.launches, hc.hsmm_pair_grad.launches)
    hg.hsmm_partition_fb(*xs, L).sum().backward()  # CPU tensors: no launch counted
    assert (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches,
            hc.hsmm_band_grad.launches, hc.hsmm_pair_grad.launches) == before


def test_expanded_inputs_sum_their_cotangents():
    """compute_potentials hands in stride-0 trans/init/lens; autograd sums
    their cotangents back through the expand."""
    arrays, lengths = arrays_np(np.random.RandomState(6), 4, 12, 5, 4)
    base = [torch.from_numpy(a[0]).requires_grad_(True) for a in arrays[:3]]
    emit, end = (torch.from_numpy(a) for a in arrays[3:])
    L = torch.from_numpy(lengths)
    z = hg.hsmm_partition_fb(*(x.expand((4,) + x.shape) for x in base), emit, end, L)
    z.sum().backward()
    full = [torch.from_numpy(np.repeat(a[:1], 4, axis=0)).requires_grad_(True)
            for a in arrays[:3]]
    th.hsmm_partition(th.HsmmPotentials(*full, emit, end), L).sum().backward()
    for x, y in zip(base, full):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.sum(0).numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("B,T,C,K,constrained",
                         [(1, 18, 5, 4, False), (3, 22, 5, 6, True), (7, 38, 19, 8, False)])
def test_log_scan_plain_matches_jax_planes(B, T, C, K, constrained):
    """The plain log scan over the stacked forward + reversed chains vs
    the gamma and alphas planes of JAX's _gamma_kernel (log, with alphas).
    JAX flips the reversed emissions over the whole buffer and injects
    each chain at step T - L, so the port's reversed step r is JAX's step
    T - L + r."""
    arrays, lengths = arrays_np(np.random.RandomState(B * 3 + C), B, T, C, K, constrained)
    lengths[-1] = 1 if B >= 3 else lengths[-1]
    jp = jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays])
    alphas_p, gammas_p, _, meta = hp._scan_packed_fb(
        jp, hp._lengths_i32(jnp.asarray(lengths)), "log", True, with_alphas=True
    )
    Gf, pack = meta["Gf"], meta["pack"]
    tp = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    gamma, alphas, offsets = hc.hsmm_log_scan(*hc._stack_fwd_rev(
        tp, torch.from_numpy(lengths).long()))
    assert offsets.shape == (2 * B, 1) and (offsets == 0).all()  # T < SCAN_FOLD: no fold
    for got, plane in ((gamma, gammas_p), (alphas, alphas_p)):
        want_f = np.asarray(hp._unpack_plane(plane[:Gf], B, T, C, pack))
        want_r = np.asarray(hp._unpack_plane(plane[Gf:], B, T, C, pack))
        np.testing.assert_allclose(got[:B].numpy(), want_f, rtol=RTOL, atol=ATOL)
        for b, L in enumerate(lengths):
            np.testing.assert_allclose(got[B + b, :L].numpy(), want_r[b, T - L:],
                                       rtol=RTOL, atol=ATOL)


def test_forward_scan_plain_matches_jax_alphas():
    """The forward-only form (K1's twin) vs hsmm_alphas_pallas: alphas
    and the partition."""
    B, T, C, K = 3, 26, 6, 5
    arrays, lengths = arrays_np(np.random.RandomState(12), B, T, C, K, constrained=True)
    jp = jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays])
    want_alphas, want_z = hp.hsmm_alphas_pallas(jp, jnp.asarray(lengths), interpret=True)
    tp = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    alphas, offsets = hc.hsmm_forward_scan(tp.trans, tp.init,
                                           th._durations(tp.lens).contiguous(), tp.emit)
    assert offsets.shape == (B, 1) and (offsets == 0).all()
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want_alphas), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        z = hg.hsmm_partition_fast(tp, torch.from_numpy(lengths))
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T,C,K", [(2, 21, 5, 6), (7, 30, 19, 8), (3, 12, 4, 12)])
def test_band_grad_plain_matches_jax(B, T, C, K):
    """The plain band sweep's four outputs vs JAX's _band_grad_packed
    (interpret mode) on the same forward/backward split, via
    _unpack_plane."""
    arrays, lengths = arrays_np(np.random.RandomState(B + T), B, T, C, K, constrained=True)
    lengths[0] = 1
    jp = jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays])
    li = hp._lengths_i32(jnp.asarray(lengths))
    alphas_p, gammas_p, cum_inc, meta = hp._scan_packed_fb(jp, li, "log", True,
                                                          with_alphas=True)
    pack, Gf = meta["pack"], meta["Gf"]
    rows = np.asarray(hp._unpack_plane(alphas_p[:Gf], B, T, C, pack))
    fin = rows[np.arange(B), lengths - 1] + arrays[4]
    logZ = np.asarray(jax.nn.logsumexp(fin, axis=-1))
    G1, g2, _ = hp._packed_G1_g2(gammas_p, cum_inc, meta)
    G1m = G1 - hp._pack_lane_values(jnp.asarray(logZ), meta)
    outs = hp._band_grad_packed(G1m, g2, meta["dur_p"][:Gf], K - 1, True)
    want = [np.asarray(hp._unpack_plane(x, B, T, C, pack)) for x in outs[:3]]
    want.append(np.asarray(hp._unpack_plane(outs[3], B, K - 1, C, pack)))

    tp = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    L = torch.from_numpy(lengths).long()
    gamma, _, offsets = hc.hsmm_log_scan(*hc._stack_fwd_rev(tp, L))
    gb = hc._grad_band_inputs(tp, L, gamma, offsets, torch.from_numpy(np.array(logZ)))
    got = hc.hsmm_band_grad(gb.G1m, gb.G2p, gb.band)
    for name, g, w in zip(("qg", "sa", "st", "lg"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


def gold_inputs(rng, B, T, C, K):
    arrays, lengths = arrays_np(rng, B, T, C, K, constrained=True)
    labels = np.repeat(rng.randint(0, C, size=(B, T // 3 + 1)), 3, axis=1)[:, :T]
    return arrays, lengths, labels


@pytest.mark.parametrize("max_k", [None, "K"])
def test_gold_score_and_log_prob_match_jax(max_k):
    """With max_k=None the span codec does not split runs, so some gold
    spans are longer than the band and score BIG_NEG on both sides."""
    B, T, C, K = 4, 30, 5, 3
    arrays, lengths, labels = gold_inputs(np.random.RandomState(4), B, T, C, K)
    labels[1, :12] = 2  # a 12-frame run: longer than the band (K - 1 = 2)
    spans_np = np.asarray(jsc.labels_to_spans(labels, None if max_k is None else K))
    spans = labels_to_spans(torch.from_numpy(labels), None if max_k is None else K)
    np.testing.assert_array_equal(spans.numpy(), spans_np)
    jp = jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays])
    tp = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    L = torch.from_numpy(lengths)
    want = np.asarray(jh.hsmm_gold_score(jp, jnp.asarray(lengths), jnp.asarray(spans_np)))
    got = th.hsmm_gold_score(tp, L, spans).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if max_k is None:
        assert (got < -1e8).any(), "no gold span longer than the band"
    want_lp = np.asarray(jh.hsmm_log_prob(jp, jnp.asarray(lengths), jnp.asarray(spans_np)))
    np.testing.assert_allclose(th.hsmm_log_prob(tp, L, spans).numpy(), want_lp,
                               rtol=RTOL, atol=ATOL)


def test_gold_score_grads_match_jax():
    B, T, C, K = 3, 24, 4, 6
    arrays, lengths, labels = gold_inputs(np.random.RandomState(9), B, T, C, K)
    spans = labels_to_spans(torch.from_numpy(labels), K)

    def jloss(*xs):
        return jh.hsmm_gold_score(jh.HsmmPotentials(*xs), jnp.asarray(lengths),
                                  jnp.asarray(spans.numpy())).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in arrays])
    _, got = torch_value_and_grads(
        arrays, lengths, lambda pots, L: th.hsmm_gold_score(pots, L, spans))
    assert_grads(got, [np.asarray(w) for w in want])


def test_training_wrappers_take_cpu_or_cuda_only():
    """The wrappers take CPU tensors (their plain versions, no launch
    counted) or CUDA tensors, nothing else."""
    meta = torch.empty((2, 4, 3), device="meta")
    scan_args = (torch.empty((2, 3, 3), device="meta"), torch.empty((2, 3), device="meta"),
                 torch.empty((2, 1, 3), device="meta"), meta)
    for scan in (hc.hsmm_log_scan, hc.hsmm_forward_scan):
        with pytest.raises(ValueError, match="meta"):
            scan(*scan_args)
    with pytest.raises(ValueError, match="meta"):
        hc.hsmm_band_grad(meta, torch.empty((2, 6, 3), device="meta"),
                          torch.empty((2, 1, 3), device="meta"))
    counters = (hc.hsmm_log_scan, hc.hsmm_forward_scan, hc.hsmm_band_grad)
    before = [k.launches for k in counters]
    gamma, alphas, offsets = hc.hsmm_log_scan(torch.zeros(2, 3, 3), torch.zeros(2, 3),
                                              torch.zeros(2, 1, 3), torch.zeros(2, 4, 3))
    fwd, fwd_offsets = hc.hsmm_forward_scan(torch.zeros(2, 3, 3), torch.zeros(2, 3),
                                            torch.zeros(2, 1, 3), torch.zeros(2, 4, 3))
    assert offsets.shape == fwd_offsets.shape == (2, 1)
    qg, sa, st, lg = hc.hsmm_band_grad(torch.zeros(2, 4, 3), torch.zeros(2, 6, 3),
                                       torch.zeros(2, 2, 3))
    assert gamma.shape == alphas.shape == fwd.shape == qg.shape == st.shape == (2, 4, 3)
    assert lg.shape == (2, 2, 3)
    assert [k.launches for k in counters] == before


def test_partition_fb_tracks_jax_at_d300_scale():
    """At the serving scale (D=300 Gaussian emissions, about -600 nats per
    frame, T=1024) JAX's float32 gradients lose the posterior to
    cancellation (ROADMAP.md §3); the port's, whose log scans fold their
    carry every SCAN_FOLD frames and whose backward forms its band inputs
    in float64 (ops/hsmm_cuda.py), lose less. Held against float64: logZ
    matches JAX's at the value tolerance; the frame marginals' worst gap
    from summing to 1 and every gradient's error are no larger than JAX's.
    Run with -s to print the numbers."""
    from action_segmentation_torch.ops.distributions import (
        gaussian_emission_log_probs,
        initial_log_probs,
        poisson_length_log_probs,
        transition_log_probs,
    )

    B, T, C, K, D = 1, 1024, 19, 20, 300
    rng = np.random.RandomState(10)
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
    arrays = [np.ascontiguousarray(p.numpy()) for p in pots]
    lengths = np.full(B, T, np.int32)

    want_z, want = jax_value_and_grads(arrays, lengths)
    got_z, got = torch_value_and_grads(arrays, lengths)
    xs64 = [torch.from_numpy(a).double().requires_grad_(True) for a in arrays]
    hg.hsmm_partition_fb(*xs64, torch.from_numpy(lengths), hg.PLAIN).sum().backward()
    exact = [x.grad.numpy() for x in xs64]
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)

    def gap(marg):
        return float(np.abs(marg.sum(axis=-1) - 1).max())

    gaps = {"port": gap(got[3]), "jax": gap(want[3]), "float64": gap(exact[3])}
    print("marginal-sum gap", gaps)
    assert gaps["float64"] < 1e-6
    assert gaps["port"] <= gaps["jax"]
    for name, g, w, x in zip(NAMES, got, want, exact):
        port_err, jax_err = np.abs(g - x).max(), np.abs(w - x).max()
        print("{}: |port - jax| {:g}, |jax - float64| {:g}, |port - float64| {:g}".format(
            name, np.abs(g - w).max(), jax_err, port_err))
        assert port_err <= jax_err, name
