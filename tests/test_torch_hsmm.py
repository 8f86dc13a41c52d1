"""The port's reference DP and span codec against their JAX twins.

Same numpy inputs (made from a seed) through ``action_segmentation_tpu.ops``
and ``action_segmentation_torch.ops``. Tolerances are the JAX package's
own for DP scores and partitions: rtol 1e-5 / atol 1e-4
(tests/test_hsmm_pallas.py); spans and labels must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import span_codec as tsc
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import span_codec as jsc

BIG_NEG = -1e9
RTOL, ATOL = 1e-5, 1e-4


def random_arrays(rng, B, T, C, K, ragged=True, constrained=False):
    """(trans, init, lens, emit, end_mask), lengths as numpy float32/int32."""
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


def both(arrays):
    return (
        jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays]),
        th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays]),
    )


SHAPES = [
    (1, 16, 5, 4, False),
    (3, 24, 5, 6, True),
    (7, 40, 19, 8, False),
    (2, 16, 3, 12, True),  # K - 1 > some lengths
]


@pytest.mark.parametrize("B,T,C,K,constrained", SHAPES)
def test_partition_matches_jax(B, T, C, K, constrained):
    arrays, lengths = random_arrays(np.random.RandomState(B * 10 + C), B, T, C, K,
                                    constrained=constrained)
    jp, tp = both(arrays)
    want = np.asarray(jh.hsmm_partition(jp, jnp.asarray(lengths)))
    got = th.hsmm_partition(tp, torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T,C,K,constrained", SHAPES)
def test_viterbi_matches_jax(B, T, C, K, constrained):
    arrays, lengths = random_arrays(np.random.RandomState(B * 100 + C), B, T, C, K,
                                    constrained=constrained)
    jp, tp = both(arrays)
    want_spans, want_scores = jh.hsmm_viterbi(jp, jnp.asarray(lengths))
    got_spans, got_scores = th.hsmm_viterbi(tp, torch.from_numpy(lengths))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_spans.numpy(), np.asarray(want_spans))


def test_zero_length_clamped_like_jax():
    """Lengths of 0 are clamped to 1 by every entry point."""
    arrays, _ = random_arrays(np.random.RandomState(0), 4, 12, 5, 4)
    lengths = np.array([0, 5, 0, 12], np.int32)
    jp, tp = both(arrays)
    want_spans, want_scores = jh.hsmm_viterbi(jp, jnp.asarray(lengths))
    got_spans, got_scores = th.hsmm_viterbi(tp, torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_spans.numpy(), np.asarray(want_spans))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        th.hsmm_partition(tp, torch.from_numpy(lengths)).numpy(),
        np.asarray(jh.hsmm_partition(jp, jnp.asarray(lengths))),
        rtol=RTOL, atol=ATOL,
    )
    clamped = th.hsmm_partition(tp, torch.from_numpy(np.maximum(lengths, 1)))
    np.testing.assert_array_equal(
        th.hsmm_partition(tp, torch.from_numpy(lengths)).numpy(), clamped.numpy()
    )


def test_k1_guard_matches_jax():
    """A one-row duration table (no representable duration) takes the
    BIG_NEG guard on both sides."""
    arrays, lengths = random_arrays(np.random.RandomState(5), 3, 10, 4, 1)
    jp, tp = both(arrays)
    want_spans, want_scores = jh.hsmm_viterbi(jp, jnp.asarray(lengths))
    got_spans, got_scores = th.hsmm_viterbi(tp, torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_spans.numpy(), np.asarray(want_spans))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=RTOL)
    np.testing.assert_allclose(
        th.hsmm_partition(tp, torch.from_numpy(lengths)).numpy(),
        np.asarray(jh.hsmm_partition(jp, jnp.asarray(lengths))),
        rtol=RTOL,
    )


def test_reverse_within_length_and_cumsum_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 9, 3).astype(np.float32)
    lengths = np.array([9, 1, 5, 3], np.int32)
    want = np.asarray(jh.reverse_within_length(jnp.asarray(x), jnp.asarray(lengths)))
    got = th.reverse_within_length(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    want_cum = np.stack([np.asarray(jh._emission_cumsum(jnp.asarray(xb))) for xb in x])
    got_cum = th._emission_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_cum, want_cum, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("max_k", [None, 1, 2, 4])
def test_span_codec_matches_jax(max_k):
    rng = np.random.RandomState(3)
    labels = np.repeat(rng.randint(0, 3, size=(4, 10)), rng.randint(1, 5), axis=1)
    want = np.asarray(jsc.labels_to_spans(labels, max_k))
    got = tsc.labels_to_spans(torch.from_numpy(labels), max_k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsc.labels_to_spans_np(labels, max_k), want)
    back = tsc.spans_to_labels(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jsc.spans_to_labels(want)))
    np.testing.assert_array_equal(back, labels)
    lengths = np.full(labels.shape[0], labels.shape[1])
    assert tsc.rle_spans(got, lengths) == jsc.rle_spans(want, lengths)


# ---- twins of tests/test_hsmm_core.py's brute-force checks -----------------


def _one(*per_instance):
    return th.HsmmPotentials(*[torch.from_numpy(np.asarray(x))[None] for x in per_instance])


def test_partition_and_viterbi_vs_bruteforce():
    """Twin of tests/test_hsmm_core.py::test_partition_and_viterbi_vs_bruteforce
    on the port's DP: every segmentation and labelling of tiny sequences
    enumerated in numpy; logZ, the best score and the best spans, and the
    gold score of the best path. The plain decode chains
    (``hsmm_viterbi_labels`` and ``hsmm_viterbi_spans``) give its labels."""
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from tests.test_hsmm_core import brute_force, path_to_spans, random_potentials

    rng = np.random.RandomState(0)
    for trial in range(6):
        C, K, T = rng.randint(2, 4), rng.randint(2, 5), rng.randint(2, 7)
        length = T if trial % 2 == 0 else max(1, T - 1)
        arrays = random_potentials(rng, C, K, T, constrained_end=trial % 3 == 0)
        want_logZ, want_best, best_path = brute_force(*arrays[:4], length, arrays[4])
        pots = _one(*arrays)
        lengths = torch.tensor([length])
        assert abs(float(th.hsmm_partition(pots, lengths)[0]) - want_logZ) < 1e-3, trial
        spans, score = th.hsmm_viterbi(pots, lengths)
        assert abs(float(score[0]) - want_best) < 1e-3
        want_spans = path_to_spans(*best_path, T)
        got = spans[0].numpy()
        assert (got[:length] == want_spans[:length]).all(), (got, want_spans)
        assert (got[length:] == -1).all()
        gold = th.hsmm_gold_score(pots, lengths, torch.from_numpy(want_spans)[None].long())
        assert abs(float(gold[0]) - want_best) < 1e-3
        want_labels = tsc.spans_to_labels(torch.from_numpy(want_spans)[None].long())[0, :length]
        labels, _ = hc.hsmm_viterbi_labels(pots, lengths)
        np.testing.assert_array_equal(labels[0, :length].numpy(), want_labels.numpy())
        chain_spans, _ = hc.hsmm_viterbi_spans(pots, lengths)
        np.testing.assert_array_equal(chain_spans[0, :length].numpy(), want_spans[:length])


def test_gold_score_random_paths():
    """Twin of tests/test_hsmm_core.py::test_gold_score_random_paths: the
    port's gold score of hand-built paths against a sum in numpy."""
    from tests.test_hsmm_core import path_to_spans, random_potentials

    rng = np.random.RandomState(1)
    C, K, T = 3, 4, 6
    trans, init, lens, emit, end_mask = random_potentials(rng, C, K, T)
    pots = _one(trans, init, lens, emit, end_mask)
    length = 5
    for durs in [(1, 1, 3), (3, 2), (2, 2, 1), (1, 1, 1, 1, 1)]:
        classes = tuple(rng.randint(C) for _ in durs)
        spans = path_to_spans(durs, classes, T)
        want, t = 0.0, 0
        for i, (c, d) in enumerate(zip(classes, durs)):
            want += lens[d, c] + emit[t : t + d, c].sum()
            want += init[c] if i == 0 else trans[c, classes[i - 1]]
            t += d
        want += end_mask[classes[-1]]
        got = float(th.hsmm_gold_score(pots, torch.tensor([length]),
                                       torch.from_numpy(spans)[None].long())[0])
        assert abs(got - want) < 1e-3, (durs, classes, got, want)


def test_constructed_periodic_decode():
    """Twin of tests/test_hsmm_core.py::test_constructed_periodic_decode (the
    reference's constructed-potentials decode, src/models/test_semimarkov.py
    :266-323): a forced periodic segmentation, decoded by the port's
    traceback Viterbi and by the plain exact-spans chain. (The labels
    chain is left out: the BIG_NEG emissions' prefix sums reach -1e10,
    where float32 absorbs the +1 a frame, so every path ties.)"""
    from action_segmentation_torch.ops import hsmm_cuda as hc

    b, C, N, K, step = 4, 4, 40, 6, 4
    padded = N + 2 * step
    lengths = np.full(b, N)
    lengths[0] = padded
    init = np.full(C, BIG_NEG, np.float32)
    init[0] = 0.0
    emit = np.full((b, padded, C), BIG_NEG, np.float32)
    for n in range(padded):
        emit[:, n, (n // step) % C] = 1.0
    lens = np.full((K, C), BIG_NEG, np.float32)
    lens[step] = 0.0
    pots = th.HsmmPotentials(
        torch.zeros(C, C).expand(b, C, C), torch.from_numpy(init).expand(b, C),
        torch.from_numpy(lens).expand(b, K, C), torch.from_numpy(emit), torch.zeros(b, C))
    lengths = torch.from_numpy(lengths)
    spans, _ = th.hsmm_viterbi(pots, lengths)
    chain_spans, _ = hc.hsmm_viterbi_spans(pots, lengths)
    for labels in (tsc.spans_to_labels(spans), tsc.spans_to_labels(chain_spans)):
        for i in range(b):
            want = (np.arange(int(lengths[i])) // step) % C
            np.testing.assert_array_equal(labels[i, : int(lengths[i])].numpy(), want)
