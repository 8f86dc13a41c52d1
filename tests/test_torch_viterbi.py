"""The exact-spans decode (K6 and its traceback) against the JAX package.

Twins of tests/test_hsmm_pallas.py's spans checks: the port's
``hsmm_viterbi_spans`` (its kernels' plain versions on CPU tensors) and
JAX's ``hsmm_viterbi_pallas`` in interpret mode get the same numpy inputs
from a seed. Spans must be equal; scores are held to JAX's own tolerance,
rtol 1e-5 / atol 1e-4 (atol 1e-3 at T=700 and across time chunks, as JAX's
long-sequence tests). The plain traceback is also held against the port's
reference traceback ``ops/hsmm.hsmm_viterbi``: equal spans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_pallas as hp

RTOL, ATOL = 1e-5, 1e-4


def random_inputs(rng, B, T, C, K, ragged=True, constrained=False):
    """tests/test_hsmm_pallas.random_pots's numpy stream: (arrays, lengths)."""
    trans = rng.randn(B, C, C).astype(np.float32)
    init = rng.randn(B, C).astype(np.float32)
    lens = rng.randn(B, K, C).astype(np.float32)
    lens[:, 0] = BIG_NEG
    emit = rng.randn(B, T, C).astype(np.float32)
    end_mask = np.zeros((B, C), np.float32)
    if constrained:
        end_mask[:] = BIG_NEG
        for b in range(B):
            end_mask[b, rng.randint(C)] = 0.0
    lengths = (
        rng.randint(max(2, T // 2), T + 1, size=B) if ragged else np.full(B, T)
    ).astype(np.int32)
    return (trans, init, lens, emit, end_mask), lengths


def both(arrays, lengths):
    """(JAX potentials, lengths), (port potentials, lengths)."""
    jax_in = jh.HsmmPotentials(*map(jnp.asarray, arrays)), jnp.asarray(lengths)
    port_in = th.HsmmPotentials(*map(torch.from_numpy, arrays)), torch.from_numpy(lengths)
    return jax_in, port_in


def assert_spans_like_jax(arrays, lengths, atol=ATOL):
    (jpots, jlen), (tpots, tlen) = both(arrays, lengths)
    want_spans, want_scores = hp.hsmm_viterbi_pallas(jpots, jlen, interpret=True)
    got_spans, got_scores = hc.hsmm_viterbi_spans(tpots, tlen)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=RTOL, atol=atol)
    np.testing.assert_array_equal(got_spans.numpy(), np.asarray(want_spans))
    return got_spans


SHAPES = [
    (1, 16, 5, 4, False),
    (3, 24, 5, 6, True),
    (7, 40, 19, 8, False),
    (4, 24, 70, 5, False),
    (2, 16, 3, 12, True),  # K - 1 > some lengths
]


@pytest.mark.parametrize("B,T,C,K,constrained", SHAPES)
def test_viterbi_spans_match_jax(B, T, C, K, constrained):
    """Twin of test_viterbi_matches_jnp, at its five shapes and seeds."""
    arrays, lengths = random_inputs(np.random.RandomState(B * 100 + C), B, T, C, K,
                                    constrained=constrained)
    before = (hc.hsmm_viterbi_scan.launches, hc.hsmm_viterbi_traceback.launches)
    assert_spans_like_jax(arrays, lengths)
    # plain versions on CPU tensors: no kernel launch counted
    assert (hc.hsmm_viterbi_scan.launches, hc.hsmm_viterbi_traceback.launches) == before


@pytest.mark.parametrize("B,T,C,K,constrained", SHAPES)
def test_traceback_plain_matches_reference_traceback(B, T, C, K, constrained):
    """The vectorized plain traceback over the plain scan's codes against
    the port's host traceback of ops/hsmm.py, which reads the reference
    scan's own backpointers: equal spans; scores to the score tolerance
    (the reference scan takes its prefix sums by torch.cumsum, the kernel
    and its plain version by a running add, so they differ by ulps)."""
    arrays, lengths = random_inputs(np.random.RandomState(B * 7 + C), B, T, C, K,
                                    constrained=constrained)
    _, (pots, L) = both(arrays, lengths)
    want_spans, want_scores = th.hsmm_viterbi(pots, L)
    got_spans, got_scores = hc.hsmm_viterbi_spans_plain(pots, L)
    assert torch.equal(got_spans, want_spans)
    torch.testing.assert_close(got_scores, want_scores, rtol=RTOL, atol=ATOL)


def test_long_sequence_spans_match_jax():
    """The spans half of test_long_sequence_time_chunked (T=700)."""
    arrays, lengths = random_inputs(np.random.RandomState(7), 2, 700, 6, 7)
    assert_spans_like_jax(arrays, lengths, atol=1e-3)


def test_one_frame_segments_match_jax():
    """The model's K = 1 (one duration row; K = 2 here, row 0 being
    unreachable): every segment is one frame, as many segments as frames,
    the most a walk takes; spans equal JAX's."""
    arrays, lengths = random_inputs(np.random.RandomState(13), 3, 64, 5, 2)
    spans = assert_spans_like_jax(arrays, lengths).numpy()
    for row, length in zip(spans, lengths):
        assert (row[:length] >= 0).all() and (row[length:] == -1).all()


def test_long_band_spans_match_jax():
    """A long band (K = 60) whose durations below 33 frames score -1000:
    the walk jumps 33-59 frames a segment, past what a small tile of code
    rows holds; spans equal JAX's."""
    arrays, lengths = random_inputs(np.random.RandomState(17), 2, 200, 4, 60)
    arrays[2][:, 1:33] = -1000.0
    spans = assert_spans_like_jax(arrays, lengths).numpy()
    jumps = [np.diff(np.flatnonzero(row >= 0)).max() for row in spans]
    assert max(jumps) > 32, jumps


def test_cross_chunk_spans_match_jax(monkeypatch):
    """The spans half of test_cross_chunk_carry: JAX's kernel over a
    five-chunk time grid (chunk shrunk to 64) against the port's one
    chain per video for all T. A shape no other test traces, so JAX's jit
    cache cannot hide the patch."""
    monkeypatch.setattr(hp, "_TIME_CHUNK", 64)
    arrays, lengths = random_inputs(np.random.RandomState(11), 3, 296, 7, 6)
    assert_spans_like_jax(arrays, lengths, atol=1e-3)


def test_zero_length_spans_clamped_like_jax():
    """The spans half of test_zero_length_clamped_like_jnp: lengths of 0
    are clamped to 1, as every entry point does."""
    arrays, _ = random_inputs(np.random.RandomState(0), 4, 12, 5, 4)
    spans = assert_spans_like_jax(arrays, np.array([0, 5, 0, 12], np.int32))
    assert (spans[[0, 2], 1:] == -1).all() and (spans[[0, 2], 0] >= 0).all()


def test_impossible_start_handled_like_jax():
    """A best path that starts before frame 0 (every init masked, so only
    BIG_NEG paths exist): the plain traceback writes a start in [-T, 0)
    at its wrapped index and drops one below -T, as JAX's scatter does;
    spans equal JAX's kernel path and its jnp traceback."""
    rng = np.random.RandomState(5)
    arrays, lengths = random_inputs(rng, 2, 6, 3, 9, ragged=False)
    arrays[1][:] = BIG_NEG  # init
    # long spans win, by more than an fp32 ulp at BIG_NEG (64)
    arrays[2][:, 1:] = 1000 * np.arange(8, dtype=np.float32)[None, :, None]
    spans = assert_spans_like_jax(arrays, lengths)
    (jpots, jlen), _ = both(arrays, lengths)
    np.testing.assert_array_equal(spans.numpy(), np.asarray(jh.hsmm_viterbi(jpots, jlen)[0]))
    # the walk: a 5-frame span [1, 6), then a start at 1 - 8 = -7, dropped
    assert spans[:, 1].tolist() == [0, 0] and int((spans >= 0).sum()) == 2
    # length 3, durations up to 4: a 2-frame span [1, 3), then a start at
    # 1 - 4 = -3, wrapped to frame 3
    lengths[:] = 3
    arrays[2][:, 5:] = BIG_NEG
    spans = assert_spans_like_jax(arrays, lengths)
    assert (spans[:, 3] >= 0).all() and (spans[:, 1] >= 0).all()
