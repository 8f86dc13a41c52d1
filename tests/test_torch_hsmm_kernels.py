"""The decode chain of ops/hsmm_cuda.py against the JAX Pallas chain.

On the CPU the wrappers run their kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. Same numpy inputs on both sides. Tolerances: gamma planes,
band maxima and scores rtol 1e-5 / atol 1e-4 (tests/test_hsmm_pallas.py);
labels equal. The kernels themselves are held against these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops.span_codec import spans_to_labels
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_pallas as hp
from tests.test_torch_hsmm import random_arrays

RTOL, ATOL = 1e-5, 1e-4


def both(arrays, lengths):
    return (
        jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays]),
        jnp.asarray(lengths),
        th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays]),
        torch.from_numpy(lengths),
    )


def with_length_one(lengths):
    lengths = lengths.copy()
    if len(lengths) >= 3:
        lengths[-1] = 1
    return lengths


# shapes no other test traces, so the jitted JAX chain is traced here
# under this test's gates (no jit-cache aliasing)
LABEL_SHAPES = [
    (1, 18, 5, 4, False),
    (3, 22, 5, 6, True),
    (7, 38, 19, 8, False),   # JAX packs 6 videos per lane group
    (2, 14, 3, 12, True),    # K - 1 > some lengths
    (4, 20, 9, 3, True),
]


@pytest.mark.parametrize("B,T,C,K,constrained", LABEL_SHAPES[:3])
def test_gamma_scan_plain_matches_jax_gamma_plane(B, T, C, K, constrained):
    """The plain gamma scan over the stacked forward + reversed chains vs
    the gamma plane of JAX's _gamma_kernel. JAX flips the reversed
    emissions over the whole buffer and injects each chain at step
    T - L, so the port's reversed step r is JAX's step T - L + r."""
    rng = np.random.RandomState(B * 7 + C)
    arrays, lengths = random_arrays(rng, B, T, C, K, constrained=constrained)
    lengths = with_length_one(lengths)
    jp, jl, tp, tl = both(arrays, lengths)

    _, gammas_p, _, meta = hp._scan_packed_fb(
        jp, hp._lengths_i32(jl), "max", True, with_alphas=False
    )
    Gf, pack = meta["Gf"], meta["pack"]
    want_f = np.asarray(hp._unpack_plane(gammas_p[:Gf], B, T, C, pack))
    want_r = np.asarray(hp._unpack_plane(gammas_p[Gf:], B, T, C, pack))

    gamma, alphas = hc._gamma_scan_plain(*hc._stack_fwd_rev(tp, tl.long()))
    assert alphas is None
    got_f, got_r = gamma[:B].numpy(), gamma[B:].numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=RTOL, atol=ATOL)
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(
            got_r[b, :L], want_r[b, T - L:], rtol=RTOL, atol=ATOL
        )


def test_gamma_scan_alphas_are_the_forward_scan():
    """with_alphas: the alphas plane is the reference DP's alphas."""
    arrays, lengths = random_arrays(np.random.RandomState(4), 3, 15, 4, 5)
    tp = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    gamma, alphas = hc._gamma_scan_plain(
        tp.trans.contiguous(), tp.init, th._durations(tp.lens).contiguous(),
        tp.emit, with_alphas=True,
    )
    want, _ = th._forward_scan(tp.trans, tp.init, tp.lens, tp.emit, "max")
    np.testing.assert_allclose(alphas.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    want_gamma = (tp.trans[:, None] + alphas[:, :, None, :]).amax(dim=3)
    np.testing.assert_array_equal(gamma.numpy(), want_gamma.numpy())


@pytest.mark.parametrize(
    "jax_band,B,T,C,K",
    [
        ("jnp", 2, 21, 5, 6),
        ("pallas", 2, 21, 5, 6),
        ("jnp", 3, 12, 4, 12),
        ("pallas", 3, 12, 4, 12),
        # K == 1: an empty band (all BIG_NEG); the Pallas interpreter
        # cannot take a zero-width table, the jnp combine can
        ("jnp", 1, 16, 3, 1),
    ],
)
def test_band_max_plain_matches_jax(jax_band, B, T, C, K):
    """The plain band max vs JAX's (B, C, T)-layout band combines: the
    jnp fallback _band_max_jnp and the unpacked Pallas kernel (K5). The
    JAX combines take K - 1 <= T only."""
    rng = np.random.RandomState(B * 13 + T)
    Km = K - 1
    G1 = rng.randn(B, T, C).astype(np.float32) * 3
    G2p = rng.randn(B, T + K, C).astype(np.float32) * 3
    G2p[:, T + 1:] = -1e9
    dur = rng.randn(B, Km, C).astype(np.float32)
    jargs = [jnp.asarray(x.transpose(0, 2, 1)) for x in (G1, G2p, dur)]
    if jax_band == "jnp":
        want = hp._band_max_jnp(*jargs, Km)
    else:
        want = hp._band_max_pallas(*jargs, Km, interpret=True)
    want = np.asarray(want).transpose(0, 2, 1)
    got = hc._band_max_plain(*[torch.from_numpy(x) for x in (G1, G2p, dur)]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        hc.hsmm_band_max(*[torch.from_numpy(x) for x in (G1, G2p, dur)]).numpy(), got
    )


def assert_labels(got, got_scores, want, want_scores, lengths):
    np.testing.assert_allclose(got_scores, want_scores, rtol=RTOL, atol=ATOL)
    for b, L in enumerate(lengths):
        np.testing.assert_array_equal(got[b, :L], want[b, :L])
        assert (got[b, L:] == -1).all()


@pytest.mark.parametrize("B,T,C,K,constrained", LABEL_SHAPES)
def test_viterbi_labels_match_jax_pallas(B, T, C, K, constrained):
    rng = np.random.RandomState(B * 31 + C + 1)
    arrays, lengths = random_arrays(rng, B, T, C, K, constrained=constrained)
    lengths = with_length_one(lengths)
    jp, jl, tp, tl = both(arrays, lengths)
    want, want_scores = hp.hsmm_viterbi_labels_pallas(jp, jl, interpret=True)
    got, got_scores = hc.hsmm_viterbi_labels(tp, tl)
    assert_labels(got.numpy(), got_scores.numpy(), np.asarray(want),
                  np.asarray(want_scores), lengths)


@pytest.mark.parametrize("B,T,C,K,constrained", LABEL_SHAPES[1:4])
def test_viterbi_labels_match_traceback(B, T, C, K, constrained):
    """Traceback-free max-marginal labels == the port's traceback Viterbi
    labels, and the plain-only chain gives the same."""
    rng = np.random.RandomState(B * 17 + C)
    arrays, lengths = random_arrays(rng, B, T, C, K, constrained=constrained)
    lengths = with_length_one(lengths)
    _, _, tp, tl = both(arrays, lengths)
    spans, want_scores = th.hsmm_viterbi(tp, tl)
    want = spans_to_labels(spans).numpy()
    got, got_scores = hc.hsmm_viterbi_labels(tp, tl)
    assert_labels(got.numpy(), got_scores.numpy(), want, want_scores.numpy(), lengths)
    plain, plain_scores = hc.hsmm_viterbi_labels_plain(tp, tl)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    np.testing.assert_array_equal(plain_scores.numpy(), got_scores.numpy())


def test_viterbi_labels_unpacked_fallback(monkeypatch):
    """Twin of the JAX long-T fallback test: with the packed-combine gate
    forced shut, JAX takes the alphas-emitting scan and the unpacked
    Pallas band kernel (K5); the port, which has no gate, must match."""
    monkeypatch.setattr(hp, "_PACKED_COMBINE_BYTE_CEILING", 0)
    calls = []
    band = hp._band_max_pallas
    monkeypatch.setattr(hp, "_band_max_pallas", lambda *a, **k: calls.append(1) or band(*a, **k))
    rng = np.random.RandomState(11)
    B, T, C, K = 3, 27, 7, 6  # unique shape: traced under this gate
    arrays, lengths = random_arrays(rng, B, T, C, K, constrained=True)
    jp, jl, tp, tl = both(arrays, lengths)
    want, want_scores = hp.hsmm_viterbi_labels_pallas(jp, jl, interpret=True)
    assert calls, "the JAX chain did not take the unpacked band kernel"
    got, got_scores = hc.hsmm_viterbi_labels(tp, tl)
    assert_labels(got.numpy(), got_scores.numpy(), np.asarray(want),
                  np.asarray(want_scores), lengths)


def test_viterbi_labels_jnp_band_fallback(monkeypatch):
    """Twin of the JAX extreme-T fallback test: with both VMEM gates
    forced shut, JAX combines through the pure-jnp band max."""
    monkeypatch.setattr(hp, "_PACKED_COMBINE_BYTE_CEILING", 0)
    monkeypatch.setattr(hp, "_VMEM_PLANE_BUDGET", 1)
    calls = []
    band = hp._band_max_jnp
    monkeypatch.setattr(hp, "_band_max_jnp", lambda *a, **k: calls.append(1) or band(*a, **k))
    rng = np.random.RandomState(13)
    B, T, C, K = 2, 35, 6, 5  # unique shape: traced under these gates
    arrays, lengths = random_arrays(rng, B, T, C, K, constrained=True)
    jp, jl, tp, tl = both(arrays, lengths)
    want, want_scores = hp.hsmm_viterbi_labels_pallas(jp, jl, interpret=True)
    assert calls, "the JAX chain did not take the jnp band combine"
    got, got_scores = hc.hsmm_viterbi_labels(tp, tl)
    assert_labels(got.numpy(), got_scores.numpy(), np.asarray(want),
                  np.asarray(want_scores), lengths)


def test_zero_lengths_clamped_like_jax():
    rng = np.random.RandomState(0)
    arrays, _ = random_arrays(rng, 4, 13, 5, 4)
    lengths = np.array([0, 5, 0, 13], np.int32)
    jp, jl, tp, tl = both(arrays, lengths)
    want, want_scores = hp.hsmm_viterbi_labels_pallas(jp, jl, interpret=True)
    got, got_scores = hc.hsmm_viterbi_labels(tp, tl)
    assert_labels(got.numpy(), got_scores.numpy(), np.asarray(want),
                  np.asarray(want_scores), np.maximum(lengths, 1))
