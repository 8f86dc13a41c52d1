"""The decode kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX). Kernel and plain
version do the same float32 operations in the same order, so they are
held to the JAX package's score tolerance (rtol 1e-5 / atol 1e-4,
tests/test_hsmm_pallas.py) and labels must be equal.
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_pots(rng, B, T, C, K, device):
    trans = np.log(rng.dirichlet(np.ones(C), size=(B, C)).astype(np.float32)).transpose(0, 2, 1)
    init = rng.randn(B, C).astype(np.float32)
    lens = rng.randn(B, K, C).astype(np.float32)
    lens[:, 0] = -1e9
    emit = (rng.randn(B, T, C) * 3 - 400).astype(np.float32)  # D=300-like scale
    end = np.zeros((B, C), np.float32)
    end[:, rng.rand(C) < 0.3] = -1e9
    end[:, 0] = 0.0
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    pots = th.HsmmPotentials(
        *[torch.from_numpy(np.ascontiguousarray(x)).to(device)
          for x in (trans, init, lens, emit, end)]
    )
    return pots, torch.from_numpy(lengths).to(device)


SHAPES = [(3, 50, 5, 4), (18, 1024, 19, 20), (4, 300, 128, 20), (5, 200, 19, 1), (2, 64, 33, 40)]


@pytest.mark.parametrize("B,T,C,K", SHAPES)
def test_gamma_kernel_matches_plain(cuda, B, T, C, K):
    pots, lengths = random_pots(np.random.RandomState(B + T), B, T, C, K, cuda)
    scan_in = hc._stack_fwd_rev(pots, lengths.long())
    before = hc.hsmm_gamma_scan.launches
    got, alphas = hc.hsmm_gamma_scan(*scan_in, with_alphas=True)
    assert hc.hsmm_gamma_scan.launches == before + 1
    want, want_alphas = hc._gamma_scan_plain(*scan_in, with_alphas=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(alphas, want_alphas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T,C,K", SHAPES)
def test_band_kernel_matches_plain(cuda, B, T, C, K):
    pots, lengths = random_pots(np.random.RandomState(B * T), B, T, C, K, cuda)
    lengths = lengths.long()
    gamma, _ = hc._gamma_scan_plain(*hc._stack_fwd_rev(pots, lengths))
    band_in = hc._band_inputs(pots, lengths, gamma)
    before = hc.hsmm_band_max.launches
    got = hc.hsmm_band_max(*band_in)
    assert hc.hsmm_band_max.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, hc._band_max_plain(*band_in), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T,C,K", SHAPES)
def test_labels_kernels_match_plain(cuda, B, T, C, K):
    pots, lengths = random_pots(np.random.RandomState(3 * B + T), B, T, C, K, cuda)
    got, got_scores = hc.hsmm_viterbi_labels(pots, lengths)
    want, want_scores = hc.hsmm_viterbi_labels_plain(pots, lengths)
    torch.testing.assert_close(got_scores, want_scores, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, want)


def test_kernels_reject_what_they_do_not_take(cuda):
    pots, lengths = random_pots(np.random.RandomState(0), 2, 16, 5, 4, cuda)
    trans, init, dur, emit = hc._stack_fwd_rev(pots, lengths.long())
    with pytest.raises(TypeError):
        hc.hsmm_gamma_scan(trans, init, dur, emit.double())
    with pytest.raises(ValueError):
        hc.hsmm_gamma_scan(trans, init, dur, emit.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        hc.hsmm_gamma_scan(trans.cpu(), init, dur, emit)
    with pytest.raises(ValueError):
        hc.hsmm_gamma_scan(trans, init, dur[:, :0].contiguous(), emit)
    wide = torch.zeros((2, 4, 129), device=cuda)
    with pytest.raises(ValueError):
        hc.hsmm_gamma_scan(torch.zeros((2, 129, 129), device=cuda),
                           torch.zeros((2, 129), device=cuda),
                           torch.zeros((2, 1, 129), device=cuda), wide)
