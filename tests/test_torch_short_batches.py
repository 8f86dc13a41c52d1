"""Batches shorter than the duration band, against the JAX package.

A batch whose padded length T is below K - 2 (every video shorter than
the longest span) still has spans ending past its buffer: the band
inputs' G2p carries K - 1 whole BIG_NEG rows past boundary T whatever T
is, as JAX's ``_packed_G1_g2`` and ``_labels_prep_single`` pad them.
Batching buckets videos by length, so a bucket of short videos is such a
batch. On the CPU the wrappers run their kernels' plain versions; the
JAX side runs its Pallas kernels in interpret mode. Same numpy inputs on
both sides. Tolerances are the JAX package's: scores rtol 1e-5 / atol
1e-4 (tests/test_hsmm_pallas.py), marginals rtol 2e-3 / atol 2e-4
(tests/test_hsmm_grad.py); labels equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_tpu.ops import hsmm as jh
from action_segmentation_tpu.ops import hsmm_grad as jg
from action_segmentation_tpu.ops import hsmm_pallas as hp
from tests.test_torch_hsmm import random_arrays

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# (B, T, C, K, lengths): T + 1 < K - 1, and T + 1 = K - 1 exactly
SHORT = [(2, 5, 4, 20, [5, 3]), (3, 18, 4, 20, [18, 11, 1])]


def inputs(B, T, C, K, lengths, seed):
    arrays, _ = random_arrays(np.random.RandomState(seed), B, T, C, K)
    lengths = np.asarray(lengths, np.int32)
    return (jh.HsmmPotentials(*[jnp.asarray(a) for a in arrays]), jnp.asarray(lengths),
            th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays]),
            torch.from_numpy(lengths))


@pytest.mark.parametrize("B,T,C,K,lengths", SHORT)
def test_band_inputs_pad_whole_rows(B, T, C, K, lengths):
    """G2p has T + 1 + K - 1 rows, the last K - 1 of them BIG_NEG, so both
    band kernels take it (T2 >= T + Km)."""
    *_, tp, tl = inputs(B, T, C, K, lengths, 0)
    gamma, _ = hc._gamma_scan_plain(*hc._stack_fwd_rev(tp, tl.long()))
    G1, G2p, band = hc._band_inputs(tp, tl.long(), gamma)
    assert G2p.shape == (B, T + K, C) and band.shape == (B, K - 1, C)
    assert (G2p[:, T + 1:] == BIG_NEG).all()
    assert hc.hsmm_band_max(G1, G2p, band).shape == (B, T, C)


@pytest.mark.parametrize("B,T,C,K,lengths", SHORT)
def test_short_batch_labels_match_jax_pallas(B, T, C, K, lengths):
    """Labels and scores of the labels chain (and of its plain-only twin)
    equal JAX's Pallas chain's on a batch shorter than the band."""
    jp, jl, tp, tl = inputs(B, T, C, K, lengths, B * 7 + T)
    want, want_scores = hp.hsmm_viterbi_labels_pallas(jp, jl, interpret=True)
    want, want_scores = np.asarray(want), np.asarray(want_scores)
    for chain in (hc.hsmm_viterbi_labels, hc.hsmm_viterbi_labels_plain):
        got, got_scores = chain(tp, tl)
        np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.numpy(), want)
        for b, L in enumerate(lengths):
            assert (got[b, L:] == -1).all()


@pytest.mark.parametrize("B,T,C,K,lengths", SHORT)
def test_short_batch_frame_marginals_match_jax(B, T, C, K, lengths):
    """The training path's frame marginals (the kernel forward/backward,
    through the band gradient's plain version) equal JAX's and sum to 1
    on every valid frame."""
    jp, jl, tp, tl = inputs(B, T, C, K, lengths, B * 11 + T)
    got = hg.hsmm_frame_marginals_fast(tp, tl).numpy()
    want = np.asarray(jg.hsmm_frame_marginals_fast(jp, jl, interpret=True))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(got[b, :L].sum(axis=1), 1.0, atol=1e-4)
        np.testing.assert_allclose(got[b, L:], 0.0, atol=1e-5)
