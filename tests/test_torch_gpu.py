"""The kernels against their plain versions, and the baselines, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX). Kernel and plain
version do the same float32 operations in the same order, so they are
held to the JAX package's score tolerance (rtol 1e-5 / atol 1e-4,
tests/test_hsmm_pallas.py) and labels, backpointer codes and spans must
be equal, as must K3's fm and K4's qg, sa and st, denormal sums included. The
pair sum's tensor route (a float64 product) is held instead to the plain
version in float64, each entry within the looser of that tolerance and the
float32 plain version's own error at that entry. The partition's
gradients are held to the JAX package's gradient tolerance (rtol 2e-3 /
atol 2e-4, tests/test_hsmm_grad.py).
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from action_segmentation_torch.ops.span_codec import spans_to_labels

# tests/ is on sys.path under pytest; imported by its own name, since a
# top-level package named `tests` that some libraries install would shadow
# the repository's `tests.`
from torch_pair_cases import masked_pair_draw, nan_pair_draw  # noqa: E402

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_pots(rng, B, T, C, K, device, unit=False):
    """Potentials at the D=300 emission scale, or with unit-scale
    emissions (where float32 holds the partition's gradient to the
    gradient tolerance over a few hundred frames)."""
    trans = np.log(rng.dirichlet(np.ones(C), size=(B, C)).astype(np.float32)).transpose(0, 2, 1)
    init = rng.randn(B, C).astype(np.float32)
    lens = rng.randn(B, K, C).astype(np.float32)
    lens[:, 0] = -1e9
    if unit:
        emit = rng.randn(B, T, C).astype(np.float32)
    else:
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
# the partition's gradients: K = 2 is the model's K = 1 table (one
# duration), the raw one-row table has no representable segmentation
FB_SHAPES = [(3, 50, 5, 4), (18, 1024, 19, 20), (4, 300, 128, 20), (5, 200, 19, 2), (2, 64, 33, 40)]


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


# batches shorter than the band (T + 1 < K - 1): G2p still carries K - 1
# whole BIG_NEG rows past e = T
SHORT_SHAPES = [(2, 5, 4, 20), (2, 7, 19, 20)]
# the band max (csrc/band_max.cu) beyond SHAPES (which hold K=1, Km = 0):
# several slabs (Km past the slab), T not a multiple of the serving
# shape's 47-row tile, a video shorter than one tile, C=1, one long video
BAND_MAX_SHAPES = SHAPES + SHORT_SHAPES + [
    (4, 300, 19, 101), (2, 100, 128, 65), (18, 1000, 19, 20), (3, 30, 19, 20),
    (3, 100, 1, 20), (1, 12000, 19, 20)]


def band_max_inputs(B, T, C, K, device, seed):
    """(G1, G2p, band) as the labels chain builds them."""
    pots, lengths = random_pots(np.random.RandomState(seed), B, T, C, K, device)
    lengths = lengths.long()
    gamma, _ = hc._gamma_scan_plain(*hc._stack_fwd_rev(pots, lengths))
    return hc._band_inputs(pots, lengths, gamma)


@pytest.mark.parametrize("B,T,C,K", BAND_MAX_SHAPES)
def test_band_kernel_matches_plain(cuda, B, T, C, K):
    """The kernel's fm equal to the plain version's: the same float32 adds
    and maxima, whatever the tile and slab."""
    band_in = band_max_inputs(B, T, C, K, cuda, B * T)
    tile = hc.band_max_tile(B, T, C, K - 1, hc._sm_count(cuda.index or 0))
    if K == 101 or (C, K) == (128, 65):
        assert tile.slab < K - 1  # several slabs
    if (T, C) == (1000, 19):
        assert T % tile.rows != 0
    before = hc.hsmm_band_max.launches
    got = hc.hsmm_band_max(*band_in)
    assert hc.hsmm_band_max.launches == before + 1
    want = hc._band_max_plain(*band_in)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "{} of {} differ from the plain version".format(
        int((got != want).sum()), got.numel())


def test_band_max_launch_refuses_a_tile_that_does_not_fit(cuda):
    """The launch takes the wrapper's tile; shared memory that cannot hold
    a slab of its rows or, with several slabs, the carry beside it, more
    than 1,024 threads, or no slab for a band is refused, not run."""
    band_in = band_max_inputs(2, 64, 19, 20, cuda, 7)
    long_in = band_max_inputs(2, 64, 19, 101, cuda, 8)
    tile = hc.band_max_tile(2, 64, 19, 19)
    several = hc.band_max_tile(2, 64, 19, 100)
    assert several.slab < 100
    for args, bad in ((band_in, tile._replace(smem_bytes=tile.smem_bytes - 4)),
                      (band_in, tile._replace(rows=54, threads=54 * 19, tiles=2)),
                      (band_in, tile._replace(slab=0, smem_bytes=0)),
                      (band_in, tile._replace(smem_bytes=hc.MAX_BLOCK_SMEM + 4)),
                      (long_in, several._replace(smem_bytes=several.smem_bytes - 4))):
        with pytest.raises(RuntimeError, match="hsmm_band_max"):
            hc._launch_band_max(*args, bad)
    for args, good in ((band_in, tile), (long_in, several)):
        got = hc._launch_band_max(*args, good)
        torch.cuda.synchronize()
        assert torch.equal(got, hc._band_max_plain(*args))


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


@pytest.mark.parametrize("B,T,C,K", SHAPES)
def test_log_scans_match_plain(cuda, B, T, C, K):
    pots, lengths = random_pots(np.random.RandomState(7 * B + T), B, T, C, K, cuda)
    scan_in = hc._stack_fwd_rev(pots, lengths.long())
    before = (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches)
    got = hc.hsmm_log_scan(*scan_in)
    fwd = hc.hsmm_forward_scan(*scan_in)
    assert (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches) == (
        before[0] + 1, before[1] + 1)
    want = hc._log_scan_plain(*scan_in)
    torch.cuda.synchronize()
    # gamma, alphas and offsets (the fold every SCAN_FOLD steps) equal
    for name, g, w in zip(("gamma", "alphas", "offsets", "forward alphas", "forward offsets"),
                          (*got, *fwd), (*want, *want[1:])):
        assert torch.equal(g, w), "{}: {} of {} differ".format(name, int((g != w).sum()),
                                                              g.numel())


# the band gradient (csrc/band_grad.cu) beyond SHAPES (which hold K=1,
# Km = 0): batches shorter than the band, several slabs (Km past the
# slab), a video shorter than the serving shape's 47-row tile, T not a
# multiple of the tile, C=1, and one long video
BAND_GRAD_SHAPES = SHAPES + SHORT_SHAPES + [
    (4, 300, 19, 101), (2, 100, 128, 65), (3, 30, 19, 20), (18, 1000, 19, 20), (3, 100, 1, 20),
    (1, 12000, 19, 20)]


def band_grad_inputs(B, T, C, K, device, seed, scan=hc._log_scan_plain, chunk=None):
    """(G1m, G2p, band) as the partition's backward builds them, from the
    log scan `scan` (the plain version, or the kernel at a wide shape
    whose plain scan is a long Python loop), in chunks of `chunk` rows (by
    default BAND_CHUNK; T: one chunk a video, whose rows K4's wide kernel
    splits into runs that meet by tickets)."""
    pots, lengths = random_pots(np.random.RandomState(seed), B, T, C, K, device)
    return grad_inputs(pots, lengths.long(), scan, chunk or hc.BAND_CHUNK)


def grad_inputs(pots, lengths, scan=hc._log_scan_plain, chunk=hc.BAND_CHUNK):
    """(G1m, G2p, band): the band gradient's launch over each video's
    chunks of `chunk` rows as ``hg._cotangents`` forms it from the log
    scan `scan`."""
    gamma, alphas, offsets = scan(*hc._stack_fwd_rev(pots, lengths))
    lse, _ = hg._log_partition(alphas[:pots.emit.shape[0]], offsets[:pots.emit.shape[0]],
                               lengths, pots.end_mask)
    gb = hc._grad_band_inputs(pots, lengths, gamma, offsets, lse, chunk)
    return gb.G1m, gb.G2p, gb.band


def assert_band_grad_matches_plain(band_in):
    """Two launches (of the narrow kernel up to 128 classes, of the wide
    one past them): qg, sa and st equal to the plain version's (the same
    float32 operations in the same order), lg the same in both runs and
    within the score tolerance of the plain sum (its association over T
    is the kernel's tiles)."""
    wide = band_in[0].shape[-1] > hc.MAX_CLASSES
    counter, other = ((hc.hsmm_band_grad_wide, hc.hsmm_band_grad) if wide
                      else (hc.hsmm_band_grad, hc.hsmm_band_grad_wide))
    before = (counter.launches, other.launches)
    got = hc.hsmm_band_grad(*band_in)
    again = hc.hsmm_band_grad(*band_in)
    assert (counter.launches, other.launches) == (before[0] + 2, before[1])
    want = hc._band_grad_plain(*band_in)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("qg", "sa", "st", "lg"), got, again, want):
        assert torch.equal(g, a), name + ": two runs differ"
        if name == "lg":
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)
        else:
            assert torch.equal(g, w), "{}: {} of {} differ from the plain version".format(
                name, int((g != w).sum()), g.numel())


@pytest.mark.parametrize("B,T,C,K", BAND_GRAD_SHAPES)
def test_band_grad_kernel_matches_plain(cuda, B, T, C, K):
    band_in = band_grad_inputs(B, T, C, K, cuda, B + 5 * T)
    tile = hc.band_grad_tile(B, T, C, K - 1, hc._sm_count(cuda.index or 0))
    if K == 101:
        assert tile.slab < K - 1  # several slabs
    if (T, C) == (1000, 19):
        assert T % tile.rows != 0
    assert_band_grad_matches_plain(band_in)


def gaussian_band_inputs(B, T, C, K, device, seed, D=300):
    """Band inputs from D=300 Gaussian emissions (features, means and
    covariance drawn as bench.build_inputs draws them), whose span
    posteriors spread over hundreds of nats: many st sums are denormal."""
    from action_segmentation_torch.ops.distributions import (
        gaussian_emission_log_probs,
        initial_log_probs,
        poisson_length_log_probs,
        transition_log_probs,
    )

    rng = np.random.RandomState(seed)
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    emit = gaussian_emission_log_probs(
        dev(rng.randn(B, T, D).astype(np.float32)), dev(rng.randn(C, D).astype(np.float32)),
        dev(np.abs(rng.randn(D).astype(np.float32)) + 0.5))
    trans = transition_log_probs(dev(rng.randn(C, C).astype(np.float32)))
    init = initial_log_probs(dev(rng.randn(C).astype(np.float32)))
    lens = poisson_length_log_probs(dev(rng.randn(C).astype(np.float32) * 0.3 + 1.5), K)
    pots = th.HsmmPotentials(trans.expand(B, C, C), init.expand(B, C),
                             lens.expand((B,) + lens.shape), emit.contiguous(),
                             torch.zeros(B, C, device=device))
    lengths = torch.full((B,), T, dtype=torch.long, device=device)
    return grad_inputs(pots, lengths)


@pytest.mark.parametrize("B,T,C,K", [(18, 1024, 19, 20), (5, 1056, 20, 20)])
def test_band_grad_matches_plain_on_denormal_st(cuda, B, T, C, K):
    """The serving shape and a CrossTask fit batch at the D=300 scale:
    the plain st holds denormal sums, and the kernel's qg, sa and st
    still equal the plain version's (each add of an expf or log1pf result
    rounds on its own, as the plain version's does)."""
    band_in = gaussian_band_inputs(B, T, C, K, cuda, 10)
    st = hc._band_grad_plain(*band_in)[2]
    tiny = torch.finfo(torch.float32).tiny
    assert int(((st != 0) & (st.abs() < tiny)).sum()) > 0
    assert_band_grad_matches_plain(band_in)


def test_band_grad_counters_return_to_zero(cuda):
    """K4's per-video counters: 18 videos, then 3, then 18 again, each lg
    right; every counter is back at 0 after each launch."""
    for i, B in enumerate((18, 3, 18)):
        band_in = band_grad_inputs(B, 256, 19, 20, cuda, 100 + i)
        assert_band_grad_matches_plain(band_in)
        assert int(hc._TICKETS[band_in[0].device].abs().sum()) == 0


def test_band_grad_launch_refuses_a_tile_that_does_not_fit(cuda):
    """The launch takes the wrapper's tile; shared memory that cannot hold
    a slab of its rows, more than 1,024 threads, or no slab for a band
    is refused, not run."""
    band_in = band_grad_inputs(2, 64, 19, 20, cuda, 7)
    tile = hc.band_grad_tile(2, 64, 19, 19)
    for bad in (tile._replace(smem_bytes=tile.smem_bytes - 4),
                tile._replace(rows=54, tiles=2),
                tile._replace(slab=0, smem_bytes=0),
                tile._replace(smem_bytes=hc.MAX_BLOCK_SMEM + 4)):
        with pytest.raises(RuntimeError, match="hsmm_band_grad"):
            hc._launch_band_grad(*band_in, bad)
    got = hc._launch_band_grad(*band_in, tile)
    want = hc._band_grad_plain(*band_in)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)


# the transition cotangent (csrc/pair_grad.cu): the serving shape (14
# runs a video that meet by tickets), T <= SCAN_FOLD (X = alphas, Z =
# logZ), C = 1, a tile's edge at 33, 128, the S6 model's width (two runs of
# 36 tiles) and 1,577 classes (one run of 625 tiles)
PAIR_SHAPES = [(18, 1024, 19, 20), (4, 64, 19, 20), (3, 50, 5, 4), (3, 100, 1, 20),
               (2, 96, 33, 8), (4, 300, 128, 20), (2, 1024, 342, 20), (2, 64, 1577, 20)]


def pair_inputs(pots, lengths, scan=hc._log_scan_plain):
    """(X, Y, trans, Z, lengths): the pair sum's inputs as ``hg._cotangents``
    forms them from the log scan `scan` (the kernel at a wide shape, whose
    plain scan is a long Python loop)."""
    B, T = pots.emit.shape[:2]
    gamma, alphas, offsets = scan(*hc._stack_fwd_rev(pots, lengths))
    lse, _ = hg._log_partition(alphas[:B], offsets[:B], lengths, pots.end_mask)
    gb = hc._grad_band_inputs(pots, lengths, gamma, offsets, lse)
    qg = hc._band_grad_chunked(hc.hsmm_band_grad, gb, T)[0]
    X, Y, Z = hg._pair_inputs(pots, gb, qg, alphas[:B], lse)
    return X, Y, pots.trans, Z, lengths


# the pair sum's wrappers: the tensor route's and the scalar route's
PAIR_WRAPPERS = (hc.hsmm_pair_grad, hc.hsmm_pair_grad_narrow)


def pair_launches():
    return tuple(k.launches for k in PAIR_WRAPPERS)


def assert_pair_grad_matches_plain(pair_in, route=None):
    """Two launches (of the route ``hsmm_pair_grad`` takes, or of `route`),
    the same bits, NaN where the plain version in float64 is NaN and
    nowhere else, finite where it is finite, the tickets back at 0. The
    tensor route: each finite entry within the looser of the score
    tolerance and the float32 plain version's own error at that entry of
    the plain version in float64 (it forms each exponent in float64 and
    sums in float64). The scalar route: within the score tolerance of the
    float32 plain version (each term the same float32 operations; the sum
    over frames associated by pass, thread and run)."""
    B, T, C = pair_in[0].shape
    if route is None:
        route = hc.pair_grad_tile(B, T, C, hc._sm_count(pair_in[0].device.index)).route
        counter = hc.hsmm_pair_grad if route == "tensor" else hc.hsmm_pair_grad_narrow
        before = pair_launches()
        got = hc.hsmm_pair_grad(*pair_in)
        again = hc.hsmm_pair_grad(*pair_in)
        assert pair_launches() == tuple(
            n + 2 * (k is counter) for n, k in zip(before, PAIR_WRAPPERS))
    else:
        tile = hc.pair_grad_tile(B, T, C, hc._sm_count(pair_in[0].device.index), route)
        lengths = pair_in[4].to(torch.int32)
        got, again = (hc._launch_pair_grad(*pair_in[:4], lengths, tile) for _ in range(2))
    want32 = hc._pair_grad_plain(*pair_in)
    want = hc._pair_grad_plain64(*pair_in)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), "two runs differ"
    assert torch.equal(got.isnan(), want.isnan())
    live = torch.isfinite(want)
    assert torch.isfinite(got[live]).all()
    if route == "scalar":
        torch.testing.assert_close(got, want32, rtol=RTOL, atol=ATOL, equal_nan=True)
    else:
        err32 = (want32.double()[live] - want[live]).abs()
        err32 = torch.where(torch.isfinite(err32), err32, torch.zeros_like(err32))
        gap = (got.double()[live] - want[live]).abs()
        bad = gap > torch.maximum(ATOL + RTOL * want[live].abs(), err32)
        assert not bool(bad.any()), (int(bad.sum()), float(gap.max()))
    tickets = hc._TICKETS.get(got.device)
    assert tickets is None or int(tickets.abs().sum()) == 0


@pytest.mark.parametrize("expanded", [False, True], ids=["per-video trans", "expanded trans"])
@pytest.mark.parametrize("B,T,C,K", PAIR_SHAPES)
def test_pair_grad_kernel_matches_plain(cuda, B, T, C, K, expanded):
    pots, lengths = random_pots(np.random.RandomState(B + 3 * T + C), B, T, C, K, cuda)
    if expanded:  # as compute_potentials hands it in: read in place
        pots = pots._replace(trans=pots.trans[:1].expand(B, C, C))
    scan = hc._log_scan_plain if C <= hc.MAX_CLASSES else hc.hsmm_log_scan
    assert_pair_grad_matches_plain(pair_inputs(pots, lengths.long(), scan))


@pytest.mark.parametrize("route", ["tensor", "scalar"])
@pytest.mark.parametrize("B,T,C,K", [(18, 1024, 19, 20), (3, 100, 1, 20), (2, 96, 33, 8),
                                     (2, 1024, 342, 20)])
def test_pair_grad_each_route_at_every_width(cuda, B, T, C, K, route):
    """Each kernel on the other's widths too: the tensor route at the
    serving shape (14 runs a video meeting by tickets) and C = 1, the
    scalar route past 32 classes."""
    pots, lengths = random_pots(np.random.RandomState(B + 5 * T + C), B, T, C, K, cuda)
    scan = hc._log_scan_plain if C <= hc.MAX_CLASSES else hc.hsmm_log_scan
    assert_pair_grad_matches_plain(pair_inputs(pots, lengths.long(), scan), route)


@pytest.mark.parametrize("gaps", [(100.0,), (800.0,), (5000.0,), (100.0, 800.0, 5000.0)],
                         ids=["100", "800", "5000", "mixed"])
@pytest.mark.parametrize("C", [33, 64, 70, 342])
def test_pair_grad_kernel_where_a_masked_pair_dominates(cuda, C, gaps):
    """The tensor route at gaps on both sides of theta: the product, the
    exact path (every interior tile-frame of the 5,000-nat draw at C = 64)
    and the left-out tile-frames, finite and equal to the plain
    version's."""
    assert_pair_grad_matches_plain(masked_pair_draw(np.random.RandomState(C), 3, 200, C, gaps,
                                                    cuda))


@pytest.mark.parametrize("C", [19, 33, 70, 342])
def test_pair_grad_kernel_propagates_nan(cuda, C):
    """A NaN in X, Y, Z or trans (``nan_pair_draw``) on either route: NaN
    where the plain version has it (a column, a row, a video, an entry),
    its sum elsewhere, 0 in the video of one frame."""
    pair_in = nan_pair_draw(np.random.RandomState(C), 200, C, cuda)
    assert_pair_grad_matches_plain(pair_in)
    got = hc.hsmm_pair_grad(*pair_in)
    assert got.isnan().flatten(1).any(1).tolist() == [True] * 4 + [False] * 2
    assert torch.equal(got[4], torch.zeros_like(got[4]))


def test_partition_backward_sums_the_pairs_once_and_marginals_never(cuda):
    pots, lengths = random_pots(np.random.RandomState(7), 3, 100, 19, 20, cuda, unit=True)
    xs = [x.detach().clone().requires_grad_(True) for x in pots]
    before = pair_launches()  # C = 19: the scalar route
    hg.hsmm_partition_fb(*xs, lengths).sum().backward()
    assert pair_launches() == (before[0], before[1] + 1)
    hg.hsmm_frame_marginals_fast(pots, lengths)
    assert pair_launches() == (before[0], before[1] + 1)


def test_pair_grad_rejects_what_it_does_not_take(cuda):
    pots, lengths = random_pots(np.random.RandomState(2), 2, 40, 5, 4, cuda)
    X, Y, trans, Z, L = pair_inputs(pots, lengths.long())
    with pytest.raises(TypeError):
        hc.hsmm_pair_grad(X.double(), Y, trans, Z, L)
    with pytest.raises(ValueError):
        hc.hsmm_pair_grad(X, Y[:, :-1].contiguous(), trans, Z, L)
    with pytest.raises(ValueError):
        hc.hsmm_pair_grad(X, Y, trans.double(), Z, L)
    with pytest.raises(ValueError):
        hc.hsmm_pair_grad(X, Y, trans[:, :4], Z, L)
    with pytest.raises(ValueError):
        hc.hsmm_pair_grad(X.transpose(1, 2).contiguous().transpose(1, 2), Y, trans, Z, L)


@pytest.mark.parametrize("B,T,C,K", [(3, 50, 5, 4), (18, 160, 19, 20), (4, 128, 128, 20),
                                     (5, 90, 19, 2), (2, 64, 33, 40)])
def test_partition_fb_grads_match_autograd(cuda, B, T, C, K):
    """The kernel forward/backward against autograd of the plain
    partition, in float32, at unit emission scale."""
    pots, lengths = random_pots(np.random.RandomState(B * K + T), B, T, C, K, cuda, unit=True)

    def grads(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in pots]
        z = fn(xs)
        z.sum().backward()
        return z.detach(), [x.grad for x in xs]

    before = (hc.hsmm_log_scan.launches, hc.hsmm_band_grad.launches)
    got_z, got = grads(lambda xs: hg.hsmm_partition_fb(*xs, lengths))
    assert (hc.hsmm_log_scan.launches, hc.hsmm_band_grad.launches) == (
        before[0] + 1, before[1] + 1)
    want_z, want = grads(lambda xs: th.hsmm_partition(th.HsmmPotentials(*xs), lengths))
    torch.testing.assert_close(got_z, want_z, rtol=RTOL, atol=ATOL)
    for name, g, w in zip(("trans", "init", "lens", "emit", "end_mask"), got, want):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)
    # the primal: the forward-only scan
    before = hc.hsmm_forward_scan.launches
    with torch.no_grad():
        primal = hg.hsmm_partition_fb(*pots, lengths)
    assert hc.hsmm_forward_scan.launches == before + 1
    torch.testing.assert_close(primal, got_z, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,T,C,K", FB_SHAPES)
def test_partition_fb_kernels_match_plain(cuda, B, T, C, K):
    """The kernel forward/backward against the same Function through the
    plain versions, in float32, at the D=300 emission scale."""
    pots, lengths = random_pots(np.random.RandomState(B + T + K), B, T, C, K, cuda)

    def grads(kernels):
        xs = [x.detach().clone().requires_grad_(True) for x in pots]
        z = hg.hsmm_partition_fb(*xs, lengths, kernels)
        z.sum().backward()
        return [z.detach()] + [x.grad for x in xs]

    for name, g, w in zip(("logZ", "trans", "init", "lens", "emit", "end_mask"),
                          grads(hg.KERNELS), grads(hg.PLAIN)):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)


@pytest.mark.parametrize("B,T,C,K", FB_SHAPES + [(2, 128, 342, 20)])
def test_centred_partition_on_the_card(cuda, B, T, C, K):
    """The model's partition, the DP over centred emissions plus their
    offset (``hsmm_partition_centred``): through the kernels (the log scan
    and K4 once each, the wide ones above 128 classes) against the same
    through the plain versions in float32, and against the plain path in
    float64 on the potentials as they are, its frame marginals summing to
    1 within 0.05."""
    pots, lengths = random_pots(np.random.RandomState(B + T + K), B, T, C, K, cuda)
    wide = C > hc.MAX_CLASSES
    counted = ((hc.hsmm_log_scan_wide, hc.hsmm_band_grad_wide) if wide
               else (hc.hsmm_log_scan, hc.hsmm_band_grad))

    def grads(pots, kernels, centred=True):
        xs = [x.detach().clone().requires_grad_(True) for x in pots]
        p = th.HsmmPotentials(*xs)
        if centred:
            z = hg.hsmm_partition_centred(
                p, lengths, lambda q, L: hg.hsmm_partition_fast(q, L, kernels))
        else:
            z = hg.hsmm_partition_fast(p, lengths, kernels)
        z.sum().backward()
        return [z.detach()] + [x.grad for x in xs]

    before = [k.launches for k in counted]
    got = grads(pots, hg.KERNELS)
    assert [k.launches - b for k, b in zip(counted, before)] == [1, 1]
    names = ("logZ", "trans", "init", "lens", "emit", "end_mask")
    for name, g, w in zip(names, got, grads(pots, hg.PLAIN)):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)
    exact = grads(th.HsmmPotentials(*(x.double() for x in pots)), hg.PLAIN, centred=False)
    torch.testing.assert_close(got[0].double(), exact[0], rtol=RTOL, atol=ATOL)
    real = torch.arange(T, device=cuda)[None, :] < lengths[:, None]
    assert float((got[4].sum(-1) - 1)[real].abs().max()) <= 0.05
    assert float((exact[4].sum(-1) - 1)[real].abs().max()) < 1e-6


def test_training_kernels_reject_what_they_do_not_take(cuda):
    pots, lengths = random_pots(np.random.RandomState(1), 2, 16, 5, 4, cuda)
    trans, init, dur, emit = hc._stack_fwd_rev(pots, lengths.long())
    for scan in (hc.hsmm_log_scan, hc.hsmm_forward_scan):
        with pytest.raises(TypeError):
            scan(trans, init, dur, emit.double())
        with pytest.raises(ValueError):
            scan(trans.cpu(), init, dur, emit)
        with pytest.raises(ValueError):
            scan(trans, init, dur[:, :0].contiguous(), emit)
        with pytest.raises(ValueError):
            scan(trans[:, :, :4].contiguous(), init, dur, emit)
    G1m, G2p, band = hc._band_inputs(pots, lengths.long(), hc._log_scan_plain(
        trans, init, dur, emit)[0])
    with pytest.raises(TypeError):
        hc.hsmm_band_grad(G1m.double(), G2p, band)
    with pytest.raises(ValueError):
        hc.hsmm_band_grad(G1m, G2p.cpu(), band)
    with pytest.raises(ValueError):
        hc.hsmm_band_grad(G1m, G2p[:, :17].contiguous(), band)
    with pytest.raises(ValueError):
        hc.hsmm_band_grad(G1m.transpose(1, 2).contiguous().transpose(1, 2), G2p, band)


def test_wide_class_tables_raise_on_the_card(cuda):
    """A model of 1,025 classes, past the 1,024 that the wide kernels once
    took, no longer raises on the card: decode, the training loss and the
    marginals run through the wide kernels (no narrow one), the labels
    equal to the plain spans chain's and the marginals to the plain
    Function's, both over centred emissions."""
    from argparse import Namespace

    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data.batching import pad_length_to_bucket
    from action_segmentation_torch.models.semimarkov import GaussianHsmm, SemiMarkovModel

    C, D, T = 1025, 4, 8
    args = Namespace(sm_max_span_length=4)
    model = SemiMarkovModel(args, C, D, GaussianHsmm(args, C, D, device=cuda), cuda)
    with torch.no_grad():
        model.module.gaussian_means.normal_(generator=torch.Generator(cuda).manual_seed(2))
    feats = torch.randn((1, T, D), generator=torch.Generator(cuda).manual_seed(3), device=cuda)
    lengths = torch.full((1,), T, device=cuda)
    vc = torch.arange(C, device=cuda)
    cons, ends = torch.zeros((1, T, C), device=cuda), torch.zeros((1, C), device=cuda)
    before, narrow = launches(WIDE_KERNELS), launches(NARROW_KERNELS)
    labels, _ = model._decode(feats, lengths, vc, cons, ends)
    with torch.no_grad():
        pots, _, _ = model.module.compute_potentials(feats, lengths, vc, cons, ends)
    spans, _ = hc.hsmm_viterbi_spans_plain(pots, lengths)
    assert torch.equal(labels, spans_to_labels(spans))
    loss, _ = model._loss(feats, lengths, vc, None, None, cons, ends,
                          torch.ones(1, device=cuda), use_labels=False)
    assert torch.isfinite(loss)
    seg = Segmenter(model)
    _, marg = seg.segment_with_marginals(feats[0].cpu().numpy())
    # the Segmenter's potentials: its length bucket and its end row
    x = torch.zeros((1, pad_length_to_bucket(T), D), device=cuda)
    x[:, :T] = feats
    with torch.no_grad():
        pots, _, _ = model.module.compute_potentials(
            x, lengths, vc, torch.zeros((1, x.shape[1], C), device=cuda),
            torch.from_numpy(seg._end_rows([T])).to(cuda))
    # centred as the Segmenter centres them
    want = hg.hsmm_frame_marginals_fast(hg.centre_emissions(pots, lengths)[0], lengths,
                                        hg.PLAIN)[0, :T]
    torch.testing.assert_close(torch.from_numpy(marg).to(cuda), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert [a - b for a, b in zip(launches(WIDE_KERNELS), before)] == [2, 2, 0, 2]
    assert launches(NARROW_KERNELS) == narrow


# the exact-spans kernels: K = 2 is the model's K = 1 table
VITERBI_SHAPES = [(3, 50, 5, 4), (18, 1024, 19, 20), (4, 300, 128, 20), (5, 200, 19, 2)]


@pytest.mark.parametrize("B,T,C,K", VITERBI_SHAPES)
def test_viterbi_kernels_match_plain(cuda, B, T, C, K):
    """K6's scan (alphas, codes) and the traceback against their plain
    versions on the same inputs, and the whole spans chain."""
    pots, lengths = random_pots(np.random.RandomState(11 * B + T), B, T, C, K, cuda)
    L = lengths.long()
    scan_in = (pots.trans.contiguous(), pots.init.contiguous(),
               th._durations(pots.lens).contiguous(), pots.emit.contiguous())
    before = (hc.hsmm_viterbi_scan.launches, hc.hsmm_viterbi_traceback.launches)
    alphas, bp = hc.hsmm_viterbi_scan(*scan_in)
    want_alphas, want_bp = hc._viterbi_scan_plain(*scan_in)
    torch.cuda.synchronize()
    torch.testing.assert_close(alphas, want_alphas, rtol=RTOL, atol=ATOL)
    assert torch.equal(bp, want_bp)
    c_last = th._finals(alphas, L, pots.end_mask).argmax(dim=-1)
    spans = hc.hsmm_viterbi_traceback(bp, L, c_last)
    assert (hc.hsmm_viterbi_scan.launches, hc.hsmm_viterbi_traceback.launches) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(spans, hc._traceback_plain(bp, L, c_last))
    got, got_scores = hc.hsmm_viterbi_spans(pots, lengths)
    want, want_scores = hc.hsmm_viterbi_spans_plain(pots, lengths)
    torch.testing.assert_close(got_scores, want_scores, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, want)


def test_viterbi_kernels_reject_what_they_do_not_take(cuda):
    pots, lengths = random_pots(np.random.RandomState(2), 2, 16, 5, 4, cuda)
    scan_in = (pots.trans.contiguous(), pots.init.contiguous(),
               th._durations(pots.lens).contiguous(), pots.emit.contiguous())
    with pytest.raises(TypeError):
        hc.hsmm_viterbi_scan(*scan_in[:3], scan_in[3].double())
    with pytest.raises(ValueError):
        hc.hsmm_viterbi_scan(scan_in[0].cpu(), *scan_in[1:])
    _, bp = hc.hsmm_viterbi_scan(*scan_in)
    L, c = lengths.long(), torch.zeros(2, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError):
        hc.hsmm_viterbi_traceback(bp, L.int(), c)
    with pytest.raises(ValueError):
        hc.hsmm_viterbi_traceback(bp, L[:1].contiguous(), c)
    # a row of codes wider than a slot of W2's ring of 4 (past 14,521 classes)
    with pytest.raises(ValueError, match="14522"):
        hc.hsmm_viterbi_traceback(torch.zeros((2, 8, 14522), dtype=torch.int32, device=cuda),
                                  L.clamp(max=8), c)


# the traceback (csrc/hsmm_viterbi.cu): codes staged in shared memory in
# tiles of rows from the top down, walked one shared-memory load a segment.
# Every case holds the spans equal to the plain version's.


def assert_traceback_equal_plain(bp, L, c_last, max_rows=None):
    """The kernel's spans, in the wrapper's tiles or in tiles of at most
    `max_rows` rows, equal to the plain traceback's; returns them."""
    N, T, C = bp.shape
    before = hc.hsmm_viterbi_traceback.launches
    if max_rows is None:
        spans = hc.hsmm_viterbi_traceback(bp, L, c_last)
        assert hc.hsmm_viterbi_traceback.launches == before + 1
    else:
        spans = hc._launch_traceback(bp, L, c_last, hc.traceback_tile(T, C, max_rows))
    want = hc._traceback_plain(bp, L, c_last)
    torch.cuda.synchronize()
    assert torch.equal(spans, want), "spans differ at {} frames".format(
        int((spans != want).sum()))
    return spans


@pytest.mark.parametrize("case,B,T,C,K,max_rows", [
    ("K=1", 18, 1024, 19, 2, None),  # the model's K = 1: every segment one frame
    ("C=128", 4, 1024, 128, 20, None),  # 5 tiles of 226 rows
    ("T=12000", 2, 12000, 19, 20, None),  # 8 tiles of 1,528 rows
    ("global tail", 2, 64, 1, 28901, None),
    ("global tail, 7-row tiles", 2, 64, 1, 28901, 7),  # Km > R
    ("ragged", 18, 1056, 19, 20, None),
    ("Km=100, 32-row tiles", 5, 600, 19, 101, 32),
    ("serving, 1-row tiles", 18, 1024, 19, 20, 1),
])
def test_traceback_kernel_matches_plain(cuda, case, B, T, C, K, max_rows):
    """On the plain scan's codes: one tile a video, several, and tiles
    shorter than the longest duration, with ragged lengths down to 1."""
    pots, lengths = random_pots(np.random.RandomState(T + C + K), B, T, C, K, cuda)
    if case == "T=12000":
        lengths = torch.tensor([12000, 7001], device=cuda)
    elif B > 2:
        lengths[1] = 1
    L = lengths.long()
    alphas, bp = hc._viterbi_scan_plain(pots.trans.contiguous(), pots.init.contiguous(),
                                        th._durations(pots.lens).contiguous(),
                                        pots.emit.contiguous())
    c_last = th._finals(alphas, L, pots.end_mask).argmax(dim=-1)
    spans = assert_traceback_equal_plain(bp, L, c_last, max_rows)
    if case == "K=1":
        assert (spans[0] >= 0).all()  # 1,024 segments in one video


@pytest.mark.parametrize("C,Km,max_rows", [(1, 600, 7), (19, 100, 16), (128, 40, 3),
                                           (5, 1000, 50), (33, 20, None)])
def test_traceback_kernel_on_random_codes(cuda, C, Km, max_rows):
    """Codes with uniform random durations and classes: jumps that land
    several tiles below, and walks that end before frame 0 (wrapped or
    dropped), at lengths T, 1, 2 and around a tile's edge."""
    rng = np.random.RandomState(C + Km)
    N, T = 8, 500
    codes = rng.randint(0, Km, size=(N, T, C)) * hc.CODE_RADIX + rng.randint(0, C, size=(N, T, C))
    rows = max_rows or T
    lengths = np.minimum([T, 1, 2, rows, rows + 1, 2 * rows + 1, T - 1, T // 2], T)
    bp = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    c_last = torch.from_numpy(rng.randint(0, C, size=N)).to(cuda)
    assert_traceback_equal_plain(bp, torch.from_numpy(lengths).to(cuda), c_last, max_rows)


def test_traceback_kernel_wraps_an_impossible_start(cuda):
    """A segment that starts before frame 0 (only an impossible, BIG_NEG
    path gives one) is written at its index + T and ends the walk; one
    that starts before -T is dropped. At the first segment and mid-walk,
    in one tile and in 4-row tiles."""
    T, C = 40, 3
    codes = np.zeros((4, T, C), np.int64)  # one-frame segments, class 0
    codes[0, 9, 2] = 12 * hc.CODE_RADIX  # length 10: starts at -3 -> frame 37
    codes[1, 9, 1] = (10 + T + 4) * hc.CODE_RADIX  # starts at -T - 5: dropped
    codes[2, 29, 0] = 1  # before frame 30 comes class 1 ...
    codes[2, 29, 1] = 31 * hc.CODE_RADIX  # ... whose span starts at -2 -> frame 38
    bp = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    L = torch.tensor([10, 10, T, 1], device=cuda)
    c_last = torch.tensor([2, 1, 0, 1], device=cuda)
    for max_rows in (None, 4):
        spans = assert_traceback_equal_plain(bp, L, c_last, max_rows)
        assert spans[0, T - 3] == 2 and int((spans[0] >= 0).sum()) == 1
        assert int((spans[1] >= 0).sum()) == 0
        assert spans[2, T - 2] == 1 and (spans[2, 30:T - 2] == 0).all()
        assert (spans[2, :30] == -1).all()
        assert spans[3].tolist() == [1] + [-1] * (T - 1)


def test_traceback_launch_refuses_too_little_shared_memory(cuda):
    """The launch takes the wrapper's tile; shared memory that cannot hold
    two tiles of its rows is refused, not run."""
    bp = torch.zeros((2, 64, 19), dtype=torch.int32, device=cuda)
    L = torch.full((2,), 64, device=cuda)
    c = torch.zeros(2, dtype=torch.long, device=cuda)
    spans = torch.empty((2, 64), dtype=torch.long, device=cuda)
    tile = hc.traceback_tile(64, 19)
    for rows, smem in ((tile.rows, tile.smem_bytes - 16), (0, tile.smem_bytes)):
        err = hc._call("hsmm_viterbi", "hsmm_viterbi_traceback", [bp, L, c, spans],
                       [2, 64, 19, rows, smem], bp)
        assert err != 0, (rows, smem)
    err = hc._call("hsmm_viterbi", "hsmm_viterbi_traceback", [bp, L, c, spans],
                   [2, 64, 19, *tile], bp)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(spans, hc._traceback_plain(bp, L, c))


def test_wide_model_with_a_narrow_task_runs_on_the_card(cuda):
    """A 342-class model (18 CrossTask tasks of 19 classes) whose batch is
    one task, 20 classes wide after the class bucket: decode takes the
    exact-spans kernels, and the unsupervised loss the training kernels,
    with no NotImplementedError."""
    from argparse import Namespace

    from action_segmentation_torch.models.semimarkov import GaussianHsmm, SemiMarkovModel

    C, D, T, B = 342, 6, 96, 3
    args = Namespace(sm_max_span_length=10)
    model = SemiMarkovModel(args, C, D, GaussianHsmm(args, C, D, device=cuda), cuda)
    with torch.no_grad():
        model.module.gaussian_means.normal_(generator=torch.Generator(cuda).manual_seed(0))
    vc = torch.cat([torch.arange(19, 38, device=cuda), torch.full((1,), -1, device=cuda)])
    feats = torch.randn((B, T, D), generator=torch.Generator(cuda).manual_seed(1),
                        device=cuda)
    lengths = torch.tensor([T, 50, 1], device=cuda)
    cons, ends = torch.zeros((B, T, 20), device=cuda), torch.zeros((B, 20), device=cuda)
    ends[:, -1] = -1e9
    kernels = (hc.hsmm_viterbi_scan, hc.hsmm_viterbi_traceback, hc.hsmm_gamma_scan,
               hc.hsmm_band_max, hc.hsmm_log_scan, hc.hsmm_band_grad)
    before = [k.launches for k in kernels]
    labels, scores = model._decode(feats, lengths, vc, cons, ends)
    with torch.no_grad():
        pots, _, _ = model.module.compute_potentials(feats, lengths, vc, cons, ends)
    spans, want_scores = hc.hsmm_viterbi_spans_plain(pots, lengths)
    torch.testing.assert_close(scores, want_scores, rtol=RTOL, atol=ATOL)
    real = labels[labels >= 0]
    assert ((real >= 19) & (real < 38)).all()
    assert (labels[2, 1:] == -1).all() and (labels[1, 50:] == -1).all()
    loss, _ = model._loss(feats, lengths, vc, None, None, cons, ends,
                          torch.ones(B, device=cuda), use_labels=False)
    loss.backward()
    assert torch.isfinite(loss)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0, 1, 1]


def test_card_pickle_loads_on_either_device(cuda, tmp_path):
    """A model trained on the card pickles onto the CPU (no device, no
    optimizer); checkpoint.load_pickle puts it back on the card by
    default and on the CPU when asked, and the three decode equal labels
    (the card's through the labels kernels)."""
    from argparse import Namespace

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    args = Namespace(sm_max_span_length=8, sm_class_shape_bucket=4, batch_size=5, lr=1e-2,
                     epochs=1, batch_accumulation=1, max_grad_norm=10, print_every=0,
                     no_reduce_plateau=False, reduce_plateau_factor=0.2,
                     reduce_plateau_patience=1, reduce_plateau_min_lr=1e-4, train_limit=None,
                     seed=1, sm_supervised_method="gradient-based",
                     sm_supervised_state_smoothing=1e-2, sm_supervised_length_smoothing=1e-1)
    train = SyntheticDatasplit(num_videos=10, n_classes=3, max_len=30, span_k=4, seed=0)
    model = SemiMarkovModel.from_args(args, train, device=cuda)
    model.fit(train, use_labels=True)
    path = str(tmp_path / "model.pkl")
    checkpoint.save_pickle(model, path)
    on_card, on_cpu = checkpoint.load_pickle(path), checkpoint.load_pickle(path, device="cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    for k, v in model.module.state_dict().items():
        assert torch.equal(on_card.module.state_dict()[k], v)
        assert torch.equal(on_cpu.module.state_dict()[k], v.cpu())
    feats = [train._samples[n]["features"] for n in sorted(train._samples)]
    before = hc.hsmm_band_max.launches
    want = Segmenter(model).segment_many(feats)
    assert hc.hsmm_band_max.launches > before
    for seg in (Segmenter(on_card), Segmenter.load(path, device="cpu")):
        for got, w in zip(seg.segment_many(feats), want):
            np.testing.assert_array_equal(got, w)


# ---- the baselines: fp32 emissions, Cholesky and GEMMs on the card ----------


def _gaussian_stats(rng, D=64, C=6, few=8):
    """Moments of a labelled corpus at scale 10: class C - 1 has `few` < D
    frames, so its fp32 full covariance is not positive definite."""
    from action_segmentation_torch.ops.stats import semimarkov_sufficient_stats

    feats = [(10 * rng.randn(200, D) + 5).astype(np.float32) for _ in range(3)]
    labels = [rng.randint(0, C - 1, 200) for _ in range(3)]
    labels[2][:few] = C - 1
    return {kind: semimarkov_sufficient_stats(feats, labels, C, covariance_type=kind)
            for kind in ("tied_diag", "full", "tied")}


@pytest.mark.parametrize("kind", ["diag", "tied", "full"])
def test_baseline_emissions_on_the_card(cuda, kind):
    """The per-class diagonal and the full-covariance emissions (cuSOLVER's
    Cholesky, the triangular solve and the GEMMs) on the card against the
    CPU at rtol 1e-5 / atol 1e-4, NaN columns in the same places (the
    few-frame class's failed factor) and equal argmax labels."""
    from action_segmentation_torch.ops import distributions as td

    rng = np.random.RandomState(0)
    stats = _gaussian_stats(rng)
    key = {"diag": ("tied_diag", "gaussian_cov_diag"), "tied": ("tied", "gaussian_cov_tied"),
           "full": ("full", "gaussian_cov_full")}[kind]
    means, cov = stats[key[0]]["gaussian_means"], stats[key[0]][key[1]]
    fn = (td.gaussian_emission_log_probs_diag if kind == "diag"
          else td.gaussian_emission_log_probs_fullcov)
    x = (10 * rng.randn(2, 300, means.shape[1]) + 5).astype(np.float32)
    out = [fn(*(torch.from_numpy(a).to(dev) for a in (x, means, cov))).cpu()
           for dev in ("cpu", cuda)]
    nan = [torch.isnan(o) for o in out]
    assert torch.equal(nan[0], nan[1])
    if kind == "full":
        failed = [td.cholesky_or_nan(torch.from_numpy(cov).to(d))[1].cpu() for d in ("cpu", cuda)]
        assert torch.equal(failed[0] != 0, failed[1] != 0) and bool(failed[0][-1])
        assert nan[0][..., -1].all()
    torch.testing.assert_close(out[1][~nan[1]], out[0][~nan[0]], rtol=RTOL, atol=ATOL)
    assert torch.equal(out[0].argmax(-1), out[1].argmax(-1))


def _baseline_args(**overrides):
    import argparse

    from action_segmentation_torch.models.base import add_training_args
    from action_segmentation_torch.models.framewise import (
        FramewiseDiscriminative,
        FramewiseGaussianMixture,
    )
    from action_segmentation_torch.models.sequential import SequentialDiscriminative

    parser = argparse.ArgumentParser()
    for cls in (FramewiseDiscriminative, FramewiseGaussianMixture, SequentialDiscriminative):
        cls.add_args(parser)
    add_training_args(parser)
    parser.add_argument("--batch_size", type=int, default=4)
    args = parser.parse_args([])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def test_taggers_live_on_the_card(cuda):
    """Both taggers' parameters are on the card after from_args, and one
    epoch keeps them and Adam's state there."""
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.framewise import FramewiseDiscriminative
    from action_segmentation_torch.models.sequential import SequentialDiscriminative

    train = SyntheticDatasplit(num_videos=4, n_classes=3, max_len=20, span_k=4, seed=0)
    args = _baseline_args(epochs=1, ff_hidden_layers=1, seq_hidden_size=8)
    for cls, attr in ((FramewiseDiscriminative, "mlp"), (SequentialDiscriminative, "tagger")):
        model = cls.from_args(args, train)
        assert model.device.type == "cuda"
        params = list(getattr(model, attr).parameters())
        assert params and all(p.is_cuda for p in params)
        model.fit(train, use_labels=True)
        assert all(p.is_cuda for p in getattr(model, attr).parameters())
        preds = model.predict(train)
        assert len(preds) == 4


def test_baseline_pickle_loads_on_either_device(cuda, tmp_path):
    """A Gaussian mixture fitted on the card pickles onto the CPU (no
    device); checkpoint.load_pickle puts it on the card by default and
    on the CPU when asked, and all three predict equal labels."""
    from action_segmentation_torch import checkpoint
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.framewise import FramewiseGaussianMixture

    train = SyntheticDatasplit(num_videos=10, n_classes=3, max_len=30, span_k=4, seed=0)
    model = FramewiseGaussianMixture.from_args(_baseline_args(gm_covariance="full"), train)
    model.fit(train, use_labels=True)
    assert model.cov.is_cuda
    path = str(tmp_path / "gmm.pkl")
    checkpoint.save_pickle(model, path)
    on_card, on_cpu = checkpoint.load_pickle(path), checkpoint.load_pickle(path, device="cpu")
    assert on_card.cov.is_cuda and on_cpu.cov.device.type == "cpu"
    assert torch.equal(on_cpu.cov, model.cov.cpu()) and torch.equal(on_card.cov, model.cov)
    want = model.predict(train)
    for loaded in (on_card, on_cpu):
        got = loaded.predict(train)
        assert all(np.array_equal(got[k], want[k]) for k in want)


# ---- the scan template's instances (csrc/hsmm_scan_core.cuh) ----------------
# C and Km at every instance boundary: one warp a chain with its trans row
# in 24 or 32 registers, two and four warps; the carry's 24 register rows,
# one past them (a one-row shared-memory tail) and longer tails. Kernel
# and plain version do the same float32 operations in the same order, so
# every output is held equal.

CLASS_EDGES = (1, 2, 24, 25, 31, 32, 33, 64, 65, 128)
KM_EDGES = (1, 19, 24, 25, 64, 100)


@pytest.mark.parametrize("use_labels", [False, True], ids=["unsupervised", "discriminative"])
def test_resident_fit_and_predict_on_the_card(cuda, use_labels):
    """The resident corpus on the card: the fit's epoch stats, parameters
    and the decode's labels bit-equal to --sm_device_resident_mb 0 on a
    ragged corpus (several length buckets, a partial batch), the corpus
    and every gathered batch on the card, and the kernels launched once a
    batch on both paths (K2-log and K4 a training batch, K2-max and K3 a
    decode batch)."""
    import argparse

    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.base import add_training_args
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    train = SyntheticDatasplit(num_videos=14, n_classes=4, max_len=150, min_len=8, span_k=5,
                               feature_dim=6, seed=3)
    kernels = (hc.hsmm_log_scan, hc.hsmm_band_grad, hc.hsmm_gamma_scan, hc.hsmm_band_max)
    runs = []
    for budget in (1024, 0):
        parser = argparse.ArgumentParser()
        SemiMarkovModel.add_args(parser)
        add_training_args(parser)
        parser.add_argument("--batch_size", type=int, default=4)
        args = parser.parse_args(["--sm_max_span_length", "8", "--epochs", "2", "--lr", "1e-2",
                                  "--seed", "3", "--sm_device_resident_mb", str(budget),
                                  "--sm_supervised_method", "gradient-based",
                                  "--sm_train_discriminatively"])
        model = SemiMarkovModel.from_args(args, train, device=cuda)
        for k in kernels:
            k.launches = 0
        stats = []
        model.fit(train, use_labels=use_labels, callback_fn=lambda e, s: stats.append(s))
        trained = [k.launches for k in kernels]
        preds = model.predict(train)
        runs.append((model, stats, preds, trained, [k.launches for k in kernels]))
    (res_model, *res), (str_model, *streamed) = runs
    corpus = res_model._get_resident(train, False)
    assert corpus is not None and corpus.feat.is_cuda and corpus.length.is_cuda
    assert not getattr(str_model, "_resident_cache", None)
    assert res[0] == streamed[0]
    for k, v in res_model.module.state_dict().items():
        assert torch.equal(v, str_model.module.state_dict()[k]), k
    assert list(res[1]) == list(streamed[1])
    for name in res[1]:
        np.testing.assert_array_equal(res[1][name], streamed[1][name])
    train_batches = 2 * sum(-(-len(v) // 4) for v in train.videos_by_task.values())
    decode_batches = train_batches // 2
    assert res[2] == streamed[2] == [train_batches, train_batches, 0, 0]
    assert res[3] == streamed[3] == [train_batches, train_batches, decode_batches,
                                     decode_batches]


def scan_inputs(rng, N, T, C, Km, device):
    """(trans, init, dur, emit) at the D=300 emission scale, with some
    BIG_NEG durations and transitions."""
    trans = np.log(rng.dirichlet(np.ones(C), size=(N, C)).astype(np.float32))
    trans[rng.rand(N, C, C) < 0.1] = -1e9
    init = rng.randn(N, C).astype(np.float32)
    dur = rng.randn(N, Km, C).astype(np.float32)
    dur[rng.rand(N, Km, C) < 0.1] = -1e9
    emit = (rng.randn(N, T, C) * 3 - 400).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (trans, init, dur, emit))


def assert_scans_equal_plain(scan_in):
    """The four scan entry points against their plain versions, equal."""
    gamma, alphas = hc.hsmm_gamma_scan(*scan_in, with_alphas=True)
    gamma_only, none = hc.hsmm_gamma_scan(*scan_in)
    log_gamma, log_alphas, log_offsets = hc.hsmm_log_scan(*scan_in)
    fwd, fwd_offsets = hc.hsmm_forward_scan(*scan_in)
    vit_alphas, bp = hc.hsmm_viterbi_scan(*scan_in)
    want = hc._gamma_scan_plain(*scan_in, with_alphas=True)
    want_log = hc._log_scan_plain(*scan_in)
    want_vit = hc._viterbi_scan_plain(*scan_in)
    torch.cuda.synchronize()
    assert none is None
    for name, got, exp in (("gamma", gamma, want[0]), ("alphas", alphas, want[1]),
                           ("gamma only", gamma_only, want[0]),
                           ("log gamma", log_gamma, want_log[0]),
                           ("log alphas", log_alphas, want_log[1]),
                           ("log offsets", log_offsets, want_log[2]),
                           ("forward alphas", fwd, want_log[1]),
                           ("forward offsets", fwd_offsets, want_log[2]),
                           ("viterbi alphas", vit_alphas, want_vit[0]),
                           ("codes", bp, want_vit[1])):
        assert torch.equal(got, exp), "{}: {} of {} differ".format(
            name, int((got != exp).sum()), got.numel())
    return bp


@pytest.mark.parametrize("C", CLASS_EDGES)
@pytest.mark.parametrize("Km", KM_EDGES)
def test_scan_instances_bit_exact_with_plain(cuda, C, Km):
    scan_in = scan_inputs(np.random.RandomState(131 * C + Km), 3, 40, C, Km, cuda)
    kernels = (hc.hsmm_gamma_scan, hc.hsmm_log_scan, hc.hsmm_forward_scan,
               hc.hsmm_viterbi_scan)
    before = [k.launches for k in kernels]
    assert_scans_equal_plain(scan_in)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 1, 1, 1]


@pytest.mark.parametrize("case,C,Km", [
    ("ragged", 19, 19), ("ragged", 128, 65), ("end_mask", 19, 19), ("end_mask", 33, 64),
    ("ragged", 30, 28), ("all_tie", 19, 19), ("all_tie", 25, 25), ("all_tie", 65, 100),
    ("all_tie", 1, 33), ("short", 19, 19), ("short", 128, 100),
    ("global_tail", 1, 28900), ("global_tail", 9, 3222),
])
def test_scan_instances_edge_cases(cuda, case, C, Km):
    """Ragged lengths down to 1 and a BIG_NEG end mask (the stacked
    forward and reversed chains, as decode and training build them), and
    constant inputs, where every transition term ties and the duration
    terms tie from the first row: the first maximum is code 0. And three
    steps, fewer than the emission window stages ahead. And bands so long
    that the tail reads its durations from global memory."""
    B, T = 5, 60
    if case == "global_tail":
        assert hc.scan_instance(C, Km).tail == 2
        assert_scans_equal_plain(scan_inputs(np.random.RandomState(C), 2, 30, C, Km, cuda))
        return
    if case == "short":
        assert_scans_equal_plain(scan_inputs(np.random.RandomState(C), B, 3, C, Km, cuda))
        return
    if case == "all_tie":
        zeros = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
        bp = assert_scans_equal_plain((zeros(B, C, C), zeros(B, C), zeros(B, Km, C),
                                       zeros(B, T, C)))
        assert (bp == 0).all()
        return
    pots, lengths = random_pots(np.random.RandomState(C + Km), B, T, C, Km + 1, cuda)
    lengths[1] = 1
    if case == "end_mask":
        lengths[:] = T
        assert (pots.end_mask < -1e8).any()
    scan_in = hc._stack_fwd_rev(pots, lengths.long())
    assert_scans_equal_plain(scan_in)


@pytest.mark.parametrize("C", CLASS_EDGES)
@pytest.mark.parametrize("Km", (19, 40))
def test_log_scans_fold_bit_exact_with_plain(cuda, C, Km):
    """Past SCAN_FOLD steps (folds after steps 63, 127 and 191; at -400
    nats a frame each class also folds on its own past SCAN_FOLD_LIMIT,
    every 10-11 steps) on every instance, the tail's ring included: K2
    log's gamma, alphas and offsets
    and K1's alphas and offsets equal to the plain version's. A chain with
    no live alpha at a fold (init masked: every alpha near BIG_NEG) folds
    cum alone: its offsets 0, its planes below BIG_NEG / 2."""
    scan_in = list(scan_inputs(np.random.RandomState(17 * C + Km), 3, 200, C, Km, cuda))
    scan_in[1] = scan_in[1].clone()
    scan_in[1][1] = -1e9
    before = (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches)
    got = hc.hsmm_log_scan(*scan_in)
    fwd = hc.hsmm_forward_scan(*scan_in)
    assert (hc.hsmm_log_scan.launches, hc.hsmm_forward_scan.launches) == (
        before[0] + 1, before[1] + 1)
    want = hc._log_scan_plain(*scan_in)
    torch.cuda.synchronize()
    for name, g, w in zip(("gamma", "alphas", "offsets", "forward alphas", "forward offsets"),
                          (*got, *fwd), (*want, *want[1:])):
        assert torch.equal(g, w), "{}: {} of {} differ".format(name, int((g != w).sum()),
                                                              g.numel())
    offsets = got[2]
    assert offsets.shape == (3, 4) and (offsets[[0, 2], 1:] < -1e3).all()
    assert (offsets[1] == 0).all() and (got[1][1] < -5e8).all()


@pytest.mark.parametrize("C,Km", [(1, 28900), (9, 3222)])
def test_log_scans_fold_the_global_tail(cuda, C, Km):
    """The tail whose durations are read from global memory folds its ring
    too: 200 steps, K2 log and K1 equal to the plain versions."""
    assert hc.scan_instance(C, Km).tail == 2
    scan_in = scan_inputs(np.random.RandomState(C), 2, 200, C, Km, cuda)
    got, fwd = hc.hsmm_log_scan(*scan_in), hc.hsmm_forward_scan(*scan_in)
    want = hc._log_scan_plain(*scan_in)
    torch.cuda.synchronize()
    for g, w in zip((*got, *fwd), (*want, *want[1:])):
        assert torch.equal(g, w)


def test_scan_launch_refuses_an_instance_too_small(cuda):
    """The launch takes the instance the wrapper picked; one whose threads
    or trans row cannot hold the shape, or whose tail does not match Km,
    is refused, not run."""
    scan_in = scan_inputs(np.random.RandomState(7), 2, 8, 33, 25, cuda)
    gamma = torch.empty_like(scan_in[3])
    inst = hc.scan_instance(33, 25)
    for warps, row, tail in ((1, 32, 1), (2, 0, 0), (2, 32, 1)):
        err = hc._call("hsmm_scan", "hsmm_gamma_scan_max", [*scan_in, gamma, None],
                       [2, 8, 33, 25, warps, row, tail, inst.smem_bytes], gamma)
        assert err != 0, (warps, row, tail)
    err = hc._call("hsmm_scan", "hsmm_gamma_scan_max", [*scan_in, gamma, None],
                   [2, 8, 33, 25, inst.warps, inst.row, inst.tail, inst.smem_bytes], gamma)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(gamma, hc._gamma_scan_plain(*scan_in)[0])


# ---- a DP wider than 128 classes: the wide scans (csrc/hsmm_scan_wide.cu),
# the traceback's wide instance and K4, each equal to its plain version

WIDE_CLASSES = (129, 342, 1024, 1025, 1577, 2048)
WIDE_KMS = (1, 19, 25, 64)
WIDE_KERNELS = (hc.hsmm_viterbi_scan_wide, hc.hsmm_log_scan_wide, hc.hsmm_forward_scan_wide,
                hc.hsmm_viterbi_traceback_wide)
NARROW_KERNELS = (hc.hsmm_gamma_scan, hc.hsmm_log_scan, hc.hsmm_forward_scan,
                  hc.hsmm_viterbi_scan, hc.hsmm_viterbi_traceback, hc.hsmm_band_max,
                  hc.hsmm_band_grad)


def launches(kernels):
    return [k.launches for k in kernels]


def assert_wide_scans_equal_plain(scan_in):
    """The three wide instances through the public wrappers, each launched
    once, against their plain versions: equal."""
    before, narrow = launches(WIDE_KERNELS), launches(NARROW_KERNELS)
    vit_alphas, bp = hc.hsmm_viterbi_scan(*scan_in)
    log_gamma, log_alphas, log_offsets = hc.hsmm_log_scan(*scan_in)
    fwd, fwd_offsets = hc.hsmm_forward_scan(*scan_in)
    assert [a - b for a, b in zip(launches(WIDE_KERNELS), before)] == [1, 1, 1, 0]
    assert launches(NARROW_KERNELS) == narrow
    want_vit = hc._viterbi_scan_plain(*scan_in, radix=hc.code_radix(scan_in[3].shape[-1]))
    want_log = hc._log_scan_plain(*scan_in)
    torch.cuda.synchronize()
    for name, got, exp in (("viterbi alphas", vit_alphas, want_vit[0]),
                           ("codes", bp, want_vit[1]),
                           ("log gamma", log_gamma, want_log[0]),
                           ("log alphas", log_alphas, want_log[1]),
                           ("log offsets", log_offsets, want_log[2]),
                           ("forward alphas", fwd, want_log[1]),
                           ("forward offsets", fwd_offsets, want_log[2])):
        assert torch.equal(got, exp), "{}: {} of {} differ".format(
            name, int((got != exp).sum()), got.numel())
    return bp


@pytest.mark.parametrize("C", WIDE_CLASSES)
@pytest.mark.parametrize("Km", WIDE_KMS)
def test_wide_scans_bit_exact_with_plain(cuda, C, Km):
    """Each layout: the ring in shared memory and (C = 1024, Km = 64; past
    1,024 classes from Km = 25) in global memory; past 1,024 classes two
    classes a thread."""
    T = 24 if C > 342 else 40  # the plain log scan is a Python loop over C
    assert_wide_scans_equal_plain(scan_inputs(np.random.RandomState(C + Km), 2, T, C, Km, cuda))


@pytest.mark.parametrize("case,C,Km", [("ragged", 129, 19), ("ragged", 342, 19),
                                       ("all_tie", 342, 19), ("all_tie", 1024, 64),
                                       ("short", 200, 25)])
def test_wide_scans_edge_cases(cuda, case, C, Km):
    """The stacked forward and reversed chains with ragged lengths down to
    1; constant inputs, where every term ties and the first maximum is
    code 0; and three steps."""
    if case == "all_tie":
        zeros = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
        bp = assert_wide_scans_equal_plain((zeros(3, C, C), zeros(3, C), zeros(3, Km, C),
                                            zeros(3, 8, C)))
        assert (bp == 0).all()
        return
    if case == "short":
        assert_wide_scans_equal_plain(scan_inputs(np.random.RandomState(C), 3, 3, C, Km, cuda))
        return
    pots, lengths = random_pots(np.random.RandomState(C + Km), 3, 30, C, Km + 1, cuda)
    lengths[1] = 1
    assert_wide_scans_equal_plain(hc._stack_fwd_rev(pots, lengths.long()))


def assert_wide_traceback_equal_plain(bp, L, c_last, tile=None):
    """W2's spans, through the wrapper (its launch counted) or in `tile`
    (a ``wide_traceback_tile``), equal to the plain traceback's; returns
    them."""
    before = hc.hsmm_viterbi_traceback_wide.launches
    if tile is None:
        spans = hc.hsmm_viterbi_traceback(bp, L, c_last)
        assert hc.hsmm_viterbi_traceback_wide.launches == before + 1
    else:
        spans = hc._launch_traceback(bp, L, c_last, tile)
    want = hc._traceback_plain(bp, L, c_last)
    torch.cuda.synchronize()
    assert torch.equal(spans, want), "spans differ at {} frames".format(
        int((spans != want).sum()))
    return spans


def wide_random_codes(rng, N, T, C, Km, device):
    """Codes at ``code_radix(C)`` (1024 up to 1,024 classes) with uniform
    random durations (up to Km rows) and classes."""
    codes = rng.randint(0, Km, size=(N, T, C)) * hc.code_radix(C) + rng.randint(
        0, C, size=(N, T, C))
    return torch.from_numpy(codes.astype(np.int32)).to(device)


@pytest.mark.parametrize("C", WIDE_CLASSES)
@pytest.mark.parametrize("max_rows", (None, 3))
def test_wide_traceback_matches_plain(cuda, C, max_rows):
    """W2 on the plain scan's codes (the wrapper's ring, or 3-row tiles)
    and on uniform random codes at ``code_radix(C)`` (2,048 at 1,025 and
    1,577 classes), with lengths down to 1: spans equal."""
    pots, lengths = random_pots(np.random.RandomState(C), 4, 60, C, 20, cuda)
    lengths[1] = 1
    L = lengths.long()
    alphas, bp = hc._viterbi_scan_plain(pots.trans.contiguous(), pots.init.contiguous(),
                                        th._durations(pots.lens).contiguous(),
                                        pots.emit.contiguous())
    c_last = th._finals(alphas, L, pots.end_mask).argmax(dim=-1)
    tile = None if max_rows is None else hc.wide_traceback_tile(60, C, max_rows)
    assert_wide_traceback_equal_plain(bp, L, c_last, tile)
    rng = np.random.RandomState(C + 1)
    N, T, Km = 6, 300, 40
    bp = wide_random_codes(rng, N, T, C, Km, cuda)
    L = torch.tensor([T, 1, 2, 29, T - 1, T // 2], device=cuda)
    c_last = torch.from_numpy(rng.randint(0, C, size=N)).to(cuda)
    assert_wide_traceback_equal_plain(bp, L, c_last, hc.wide_traceback_tile(T, C, max_rows))


def test_wide_traceback_wraps_an_impossible_start(cuda):
    """W2's twin of test_traceback_kernel_wraps_an_impossible_start: a
    segment that starts before frame 0 is written at its index + T and
    ends the walk, one that starts before -T is dropped; at the first
    segment and mid-walk, in the wrapper's ring and in 4-row tiles of 1-3
    slots."""
    T, C, radix = 40, 129, hc.WIDE_CODE_RADIX
    codes = np.zeros((4, T, C), np.int64)  # one-frame segments, class 0
    codes[0, 9, 2] = 12 * radix  # length 10: starts at -3 -> frame 37
    codes[1, 9, 1] = (10 + T + 4) * radix  # starts at -T - 5: dropped
    codes[2, 29, 0] = 128  # before frame 30 comes class 128 ...
    codes[2, 29, 128] = 31 * radix  # ... whose span starts at -2 -> frame 38
    bp = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    L = torch.tensor([10, 10, T, 1], device=cuda)
    c_last = torch.tensor([2, 1, 0, 1], device=cuda)
    tiles = [None] + [hc.wide_traceback_tile(T, C, 4, stages) for stages in (1, 2, 3)]
    for tile in tiles:
        spans = assert_wide_traceback_equal_plain(bp, L, c_last, tile)
        assert spans[0, T - 3] == 2 and int((spans[0] >= 0).sum()) == 1
        assert int((spans[1] >= 0).sum()) == 0
        assert spans[2, T - 2] == 128 and (spans[2, 30:T - 2] == 0).all()
        assert (spans[2, :30] == -1).all()
        assert spans[3].tolist() == [1] + [-1] * (T - 1)


@pytest.mark.parametrize("stages", (1, 2, 4))
def test_wide_traceback_at_tile_and_ring_edges(cuda, stages):
    """Lengths around a tile's edge and the ring's (R - 1, R, R + 1 and
    S R - 1 to S R + 2 rows the walk reads, which is length - 1), on
    one-frame segments (every row walked) and on random codes, in slots
    of 5 rows."""
    C, R, T = 200, 5, 64
    tile = hc.wide_traceback_tile(T, C, R, stages)
    assert (tile.rows, tile.stages) == (R, stages)
    reads = [R - 1, R, R + 1, stages * R - 1, stages * R, stages * R + 1, stages * R + 2,
             2 * stages * R + 1, T - 1]
    L = torch.tensor([r + 1 for r in reads], device=cuda)
    rng = np.random.RandomState(stages)
    c_last = torch.from_numpy(rng.randint(0, C, size=len(reads))).to(cuda)
    ones = torch.from_numpy(rng.randint(0, C, size=(len(reads), T, C)).astype(np.int32)).to(cuda)
    spans = assert_wide_traceback_equal_plain(ones, L, c_last, tile)
    assert all(bool((spans[i, :n] >= 0).all()) for i, n in enumerate(L.tolist()))
    assert_wide_traceback_equal_plain(wide_random_codes(rng, len(reads), T, C, 4, cuda), L,
                                      c_last, tile)


@pytest.mark.parametrize("C,Km,R,stages", [(129, 100, 2, 2), (342, 64, 3, 4), (1024, 64, 14, 4),
                                           (700, 30, 1, 3)])
def test_wide_traceback_jumps_longer_than_a_tile(cuda, C, Km, R, stages):
    """Durations up to Km rows, above the R rows of a slot (and above the
    ring's S R): the walk skips tiles, which are copied all the same."""
    rng = np.random.RandomState(C + Km)
    N, T = 5, 160
    bp = wide_random_codes(rng, N, T, C, Km, cuda)
    L = torch.tensor([T, 1, 2, R + 2, T - 7], device=cuda)
    c_last = torch.from_numpy(rng.randint(0, C, size=N)).to(cuda)
    assert_wide_traceback_equal_plain(bp, L, c_last, hc.wide_traceback_tile(T, C, R, stages))


def test_wide_traceback_at_t12000(cuda):
    """C = 342 at T = 12,000 (a plane of 16 MB a video, 72 tiles of the
    wrapper's ring): the wide scan's codes and random ones."""
    rng = np.random.RandomState(12000)
    scan_in = scan_inputs(rng, 2, 12000, 342, 19, cuda)
    alphas, bp = hc.hsmm_viterbi_scan(*scan_in)
    L = torch.tensor([12000, 7001], device=cuda)
    c_last = alphas[torch.arange(2, device=cuda), L - 1].argmax(dim=-1)
    spans = assert_wide_traceback_equal_plain(bp, L, c_last)
    assert int((spans[0] >= 0).sum()) > 1000
    assert_wide_traceback_equal_plain(wide_random_codes(rng, 2, 12000, 342, 30, cuda), L, c_last)


def test_wide_traceback_launch_refuses_what_it_does_not_take(cuda):
    """W2's entry refuses shared memory that cannot hold the ring, no
    slots or more than 16, C <= 128, a radix below C (1,025 classes at
    1,024) and codes not 16-byte aligned; the wrapper raises on the last,
    and on a row of codes wider than a slot of its ring of 4 (14,522
    classes)."""
    bp = wide_random_codes(np.random.RandomState(3), 2, 64, 200, 5, cuda)
    L = torch.full((2,), 64, device=cuda)
    c = torch.zeros(2, dtype=torch.long, device=cuda)
    spans = torch.empty((2, 64), dtype=torch.long, device=cuda)
    tile = hc.wide_traceback_tile(64, 200, 8, 4)
    for ptr, C, (rows, stages, smem), shift in (
            (bp, 200, (tile.rows, tile.stages, tile.smem_bytes - 16), 10),
            (bp, 200, (tile.rows, 0, tile.smem_bytes), 10),
            (bp, 200, (tile.rows, 17, 1 << 17), 10),
            (bp, 200, (0, tile.stages, tile.smem_bytes), 10), (bp, 128, tile, 10),
            (bp, 1025, (tile.rows, tile.stages, 1 << 17), 10),
            (bp, 200, tile, 7), (bp, 200, tile, 31)):
        err = hc._call("hsmm_viterbi", "hsmm_viterbi_traceback_wide", [ptr, L, c, spans],
                       [2, 64, C, rows, stages, smem, shift], bp)
        assert err != 0, (C, rows, stages, smem, shift)
    flat = wide_random_codes(np.random.RandomState(4), 1, 2 * 64 * 200 + 1, 1, 5, cuda)
    shifted = flat.view(-1)[1:].view(2, 64, 200)  # contiguous, 4 bytes past a line
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    err = hc._call("hsmm_viterbi", "hsmm_viterbi_traceback_wide", [shifted, L, c, spans],
                   [2, 64, 200, *tile, 10], bp)
    assert err != 0
    with pytest.raises(ValueError):
        hc.hsmm_viterbi_traceback(shifted, L, c)
    wide = torch.zeros((1, 8, 14522), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="14522"):
        hc.hsmm_viterbi_traceback(wide, L[:1].clamp(max=8), c[:1])
    err = hc._call("hsmm_viterbi", "hsmm_viterbi_traceback_wide", [bp, L, c, spans],
                   [2, 64, 200, *tile, 10], bp)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(spans, hc._traceback_plain(bp, L, c))


@pytest.mark.parametrize("C", WIDE_CLASSES)
@pytest.mark.parametrize("K", (2, 20, 26, 65))
def test_wide_band_grad_matches_plain(cuda, C, K):
    """K4 at a wide DP (one or a few rows a block), its counters back at
    0 after each launch."""
    band_in = band_grad_inputs(3, 48, C, K, cuda, C + K)
    assert_band_grad_matches_plain(band_in)
    assert int(hc._TICKETS[band_in[0].device].abs().sum()) == 0


# K4's wide kernel past the shapes above: the timed shapes (18 videos of
# 1,024 frames over the S6 model's 342 classes, 664 and the primary +
# related model's 1,577; 2 videos of 12,000 frames over 342), Km = 0, 1,
# 64 and 100 (several slabs), a class past 128 and past 1,024, 3,000
# classes, one frame, a video of a CrossTask fit's bucket, all ragged
WIDE_BAND_GRAD_SHAPES = [
    (18, 1024, 342, 20), (18, 1024, 664, 20), (18, 1024, 1577, 20), (2, 12000, 342, 20),
    (3, 48, 129, 1), (3, 48, 129, 2), (4, 200, 342, 65), (4, 200, 342, 101),
    (3, 200, 1025, 20), (2, 64, 3000, 20), (2, 1, 342, 20), (1, 1056, 342, 20)]


@pytest.mark.parametrize("B,T,C,K", WIDE_BAND_GRAD_SHAPES)
def test_wide_band_grad_route_matches_plain(cuda, B, T, C, K):
    """The wide kernel in the tile ``band_grad_wide_tile`` sizes: qg, sa,
    st equal to the plain version's and lg the same in two runs (within
    the score tolerance of the plain sum), its partials within one plane,
    its counters back at 0."""
    band_in = band_grad_inputs(B, T, C, K, cuda, B + C + K, scan=hc.hsmm_log_scan, chunk=T)
    tile = hc.band_grad_wide_tile(*band_in[0].shape, K - 1, hc._sm_count(cuda.index or 0))
    assert tile.scratch_bytes <= 4 * band_in[0].numel()
    if K == 101:
        assert tile.slab < K - 1  # several slabs
    assert_band_grad_matches_plain(band_in)
    assert int(hc._TICKETS[band_in[0].device].abs().sum()) == 0


def test_wide_band_grad_in_a_cuda_graph(cuda):
    """The wide kernel captured in a CUDA graph (its counters made by a
    launch before the capture), replayed twice: the plain version's
    outputs (lg at the score tolerance), the same bits each replay."""
    band_in = band_grad_inputs(2, 512, 342, 20, cuda, 11, scan=hc.hsmm_log_scan, chunk=512)
    assert hc.band_grad_wide_tile(*band_in[0].shape, 19).tiles > 1  # the ticket runs
    hc.hsmm_band_grad(*band_in)
    torch.cuda.synchronize()
    before = hc.hsmm_band_grad_wide.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = hc.hsmm_band_grad(*band_in)
    assert hc.hsmm_band_grad_wide.launches == before + 1
    want = hc._band_grad_plain(*band_in)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append([x.clone() for x in got])
    for name, a, b, w in zip(("qg", "sa", "st", "lg"), *outs, want):
        assert torch.equal(a, b), name + ": two replays differ"
        if name == "lg":
            torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(a, w), name
    assert int(hc._TICKETS[band_in[0].device].abs().sum()) == 0


def test_wide_band_grad_launch_refuses_a_tile_that_does_not_fit(cuda):
    """The wide launch takes the wrapper's tile; too little shared memory
    for its slab, more than 256 threads, no slab for a band, shared
    memory past a block's, or no partials for more than one run is
    refused, not run."""
    band_in = band_grad_inputs(2, 256, 342, 20, cuda, 12, scan=hc.hsmm_log_scan, chunk=256)
    tile = hc.band_grad_wide_tile(*band_in[0].shape, 19)
    assert tile.tiles > 1
    for bad in (tile._replace(smem_bytes=tile.smem_bytes - 4),
                tile._replace(warps=9, threads=288),
                tile._replace(slab=0, smem_bytes=0),
                tile._replace(smem_bytes=hc.MAX_BLOCK_SMEM + 4),
                tile._replace(scratch_bytes=0)):
        with pytest.raises(RuntimeError, match="hsmm_band_grad_wide"):
            hc._launch_band_grad_wide(*band_in, bad)
    got = hc._launch_band_grad_wide(*band_in, tile)
    want = hc._band_grad_plain(*band_in)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)


def test_wide_launches_refuse_what_they_do_not_take(cuda):
    """Past WIDE_GRID_MAX_CLASSES (one chain's alpha row and its slab's
    state past a grid-route block's shared memory on 132 SMs) the scans
    raise, naming the width, and launch nothing; the wide scan's launch
    refuses too little shared memory, a radix below C, no chains a table
    and, on the grid route, a table slab in shared memory that the
    block's chains do not share."""
    C = hc.WIDE_GRID_MAX_CLASSES + 1
    z = lambda *shape: torch.zeros(shape[-1:], device=cuda).expand(shape)  # noqa: E731
    before = launches(WIDE_KERNELS)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms <= hc.H100_SMS:
        for scan in (hc.hsmm_viterbi_scan, hc.hsmm_log_scan, hc.hsmm_forward_scan):
            with pytest.raises(ValueError, match=str(C)):
                scan(z(1, C, C), z(1, C), z(1, 2, C), z(1, 4, C))
    assert launches(WIDE_KERNELS) == before
    scan_in = scan_inputs(np.random.RandomState(2), 2, 8, 200, 19, cuda)
    alphas = torch.empty_like(scan_in[3])
    bp = torch.empty(alphas.shape, dtype=torch.int32, device=cuda)
    scratch = torch.zeros(1 << 20, device=cuda)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    cl = hc.wide_scan_instance(200, 19)
    grid = hc.wide_grid_instance(200, 19, 2, 2, chains=2)
    assert cl.route == "cluster" and grid.table == "shared"
    for inst, ptrs, code in (
            (cl, [None, None, None], cl.cluster),
            (grid, [scratch, None, counter], 0)):
        for radix, smem, group in ((1024, inst.smem_bytes - 4, 1), (128, inst.smem_bytes, 1),
                                   (1024, inst.smem_bytes, 0)):
            err = hc._call("hsmm_scan_wide", "hsmm_wide_viterbi_scan",
                           [scratch, *scan_in[1:], alphas, bp, *ptrs],
                           [2, 8, 200, 19, radix, code, inst.slab, inst.chains, smem, group],
                           alphas)
            assert err != 0, (inst.route, radix, smem, group)
    # two chains a block on one table slab, but a table a chain
    err = hc._call("hsmm_scan_wide", "hsmm_wide_viterbi_scan",
                   [scratch, *scan_in[1:], alphas, bp, scratch, None, counter],
                   [2, 8, 200, 19, 1024, 0, grid.slab, 2, grid.smem_bytes, 1], alphas)
    assert err != 0


def test_wide_grid_launch_that_cannot_be_resident_raises(cuda, monkeypatch):
    """A grid-route launch whose blocks the card cannot hold at once (one
    class and one chain a block, each asking for most of an SM's shared
    memory) is refused before it runs (cudaErrorCooperativeLaunchTooLarge,
    720): the wrappers raise and count no launch."""
    C, Km, N = 700, 19, 2
    inst = hc.wide_grid_instance(C, Km, N, 1, chains=1)._replace(
        slab=1, blocks=N * C, threads=32, smem_bytes=200000)
    # an SM holds one such block (hc.SM_SMEM), the card its SMs' worth
    assert hc.SM_SMEM // (inst.smem_bytes + hc.SM_SMEM_PER_BLOCK) == 1
    assert inst.blocks > torch.cuda.get_device_properties(cuda).multi_processor_count
    monkeypatch.setattr(hc, "wide_scan_instance", lambda *_: inst)
    scan_in = scan_inputs(np.random.RandomState(5), N, 8, C, Km, cuda)
    before = launches(WIDE_KERNELS)
    for scan in (hc.hsmm_viterbi_scan_wide, hc.hsmm_log_scan_wide, hc.hsmm_forward_scan_wide):
        with pytest.raises(RuntimeError, match="error 720"):
            scan(*scan_in)
    assert launches(WIDE_KERNELS) == before


def test_wide_partition_fb_kernels_match_plain(cuda):
    """The kernel forward/backward at a 160-wide DP (wide log scan, K4)
    against the same Function through the plain versions, and its primal
    through the wide forward scan."""
    pots, lengths = random_pots(np.random.RandomState(160), 3, 64, 160, 12, cuda, unit=True)

    def grads(kernels):
        xs = [x.detach().clone().requires_grad_(True) for x in pots]
        z = hg.hsmm_partition_fb(*xs, lengths, kernels)
        z.sum().backward()
        return [z.detach()] + [x.grad for x in xs]

    before = launches((hc.hsmm_log_scan_wide, hc.hsmm_band_grad_wide, hc.hsmm_log_scan,
                       hc.hsmm_band_grad))
    got = grads(hg.KERNELS)
    assert [a - b for a, b in zip(launches((hc.hsmm_log_scan_wide, hc.hsmm_band_grad_wide,
                                             hc.hsmm_log_scan, hc.hsmm_band_grad)),
                                  before)] == [1, 1, 0, 0]
    for name, g, w in zip(("logZ", "trans", "init", "lens", "emit", "end_mask"), got,
                          grads(hg.PLAIN)):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)
    before = hc.hsmm_forward_scan_wide.launches
    with torch.no_grad():
        primal = hg.hsmm_partition_fb(*pots, lengths)
    assert hc.hsmm_forward_scan_wide.launches == before + 1
    torch.testing.assert_close(primal, got[0], rtol=RTOL, atol=ATOL)


def test_wide_model_decodes_and_trains_on_the_card(cuda):
    """A 160-class model over all its classes: decode through the wide
    scan and traceback (labels equal to the plain spans chain's), the
    unsupervised loss through the wide log scan and K4; no narrow kernel."""
    from argparse import Namespace

    from action_segmentation_torch.models.semimarkov import GaussianHsmm, SemiMarkovModel

    C, D, T, B = 160, 6, 96, 3
    args = Namespace(sm_max_span_length=10)
    model = SemiMarkovModel(args, C, D, GaussianHsmm(args, C, D, device=cuda), cuda)
    with torch.no_grad():
        model.module.gaussian_means.normal_(generator=torch.Generator(cuda).manual_seed(0))
    vc = torch.arange(C, device=cuda)
    feats = torch.randn((B, T, D), generator=torch.Generator(cuda).manual_seed(1),
                        device=cuda)
    lengths = torch.tensor([T, 50, 1], device=cuda)
    cons, ends = torch.zeros((B, T, C), device=cuda), torch.zeros((B, C), device=cuda)
    before, narrow = launches(WIDE_KERNELS), launches(NARROW_KERNELS)
    grad_before = hc.hsmm_band_grad_wide.launches
    labels, scores = model._decode(feats, lengths, vc, cons, ends)
    with torch.no_grad():
        pots, _, _ = model.module.compute_potentials(feats, lengths, vc, cons, ends)
    spans, want_scores = hc.hsmm_viterbi_spans_plain(pots, lengths)
    torch.testing.assert_close(scores, want_scores, rtol=RTOL, atol=ATOL)
    want = torch.where(torch.arange(T, device=cuda)[None, :] < lengths[:, None],
                       spans_to_labels(spans), -1)
    assert torch.equal(labels, want)
    loss, _ = model._loss(feats, lengths, vc, None, None, cons, ends,
                          torch.ones(B, device=cuda), use_labels=False)
    loss.backward()
    assert torch.isfinite(loss)
    assert [a - b for a, b in zip(launches(WIDE_KERNELS), before)] == [1, 1, 0, 1]
    assert hc.hsmm_band_grad_wide.launches == grad_before + 1
    assert launches(NARROW_KERNELS) == narrow


# ---- the wide scans' two routes (csrc/hsmm_scan_wide.cu): the cluster
# route (the table in the shared memory of a chain's blocks) and the grid
# route (one cooperative grid over every SM)

ROUTE_CLASSES = (129, 236, 342, hc.WIDE_CLUSTER_MAX_CLASSES, hc.WIDE_CLUSTER_MAX_CLASSES + 1,
                 1024, 1025, 1577, 2048, 3000)
ROUTE_KMS = (1, 19, 25, 64)
# (symbol, outputs: "a" alphas, "b" codes, "g" gamma, "o" the offsets)
WIDE_SCAN_CALLS = (("hsmm_wide_viterbi_scan", "ab"), ("hsmm_wide_log_scan", "gao"),
                   ("hsmm_wide_forward_scan", "ao"))


def wide_outputs(kind, emit):
    shapes = {"o": (emit.shape[0], hc.fold_blocks(emit.shape[1]))}
    return [torch.empty(emit.shape, dtype=torch.int32, device=emit.device) if k == "b"
            else emit.new_empty(shapes.get(k, emit.shape)) for k in kind]


def grid_variants(C, Km, N, group, sms):
    """The grid route's launches at (C, Km, N, group): the rule's; one
    chain a block; the rule's tiling with its table, and then its ring,
    moved to global memory; and its chains split over two launches."""
    rule = hc.wide_grid_instance(C, Km, N, group, sms)
    out = {rule, hc.wide_grid_instance(C, Km, N, group, sms, chains=1)}
    moved = rule
    for field in ("table", "ring"):
        moved = moved._replace(**{field: "global"})
        out.add(moved._replace(smem_bytes=hc.wide_grid_smem(C, Km, moved.slab, moved.chains,
                                                             moved.table, moved.ring)))
    if N > 1:
        half = -(-N // 2)
        out.add(moved._replace(launch_chains=half, blocks=-(-half // moved.chains) * -(
            -C // moved.slab)))
    return out


def assert_wide_launches_equal_plain(scan_in, insts):
    """Each wide instance on each launch of `insts`, against its plain
    version: equal."""
    want_vit = hc._viterbi_scan_plain(*scan_in)
    want_log = hc._log_scan_plain(*scan_in)
    want = {"hsmm_wide_viterbi_scan": want_vit, "hsmm_wide_log_scan": want_log,
            "hsmm_wide_forward_scan": want_log[1:]}
    for inst in insts:
        for symbol, kind in WIDE_SCAN_CALLS:
            outs = wide_outputs(kind, scan_in[3])
            radix = [hc.code_radix(scan_in[3].shape[-1])] if "b" in kind else []
            hc._launch_wide_scan(symbol, symbol, *scan_in, outs, radix, inst=inst)
            torch.cuda.synchronize()
            for got, exp in zip(outs, want[symbol]):
                assert torch.equal(got, exp), "{} on {}: {} of {} differ".format(
                    symbol, inst, int((got != exp).sum()), got.numel())


@pytest.mark.parametrize("C", ROUTE_CLASSES)
@pytest.mark.parametrize("Km", ROUTE_KMS)
def test_wide_scans_equal_plain_on_each_route(cuda, C, Km):
    """Each wide instance on the route ``wide_scan_instance`` picks and on
    the grid route's launches (``grid_variants``), on the stacked forward
    and reversed chains with ragged lengths down to 1: outputs equal to
    the plain versions'. The widths hold each cluster size the rule gives
    (1 at C = 129, 2 at 236, 3 at 342, 8 at the cluster route's widest C
    at Km = 1) and the grid route past it (the table slab in shared
    memory, in global memory; the ring in each)."""
    T = 24 if C > 342 else 40  # the plain log scan is a Python loop over C
    pots, lengths = random_pots(np.random.RandomState(C + 7 * Km), 3, T, C, Km + 1, cuda)
    lengths[1] = 1
    scan_in = hc._stack_fwd_rev(pots, lengths.long())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    insts = {hc.wide_scan_instance(C, Km, 6, 1, sms)} | grid_variants(C, Km, 6, 1, sms)
    assert_wide_launches_equal_plain(scan_in, insts)


@pytest.mark.parametrize("C,unit", [(129, True), (342, True), (342, False), (665, True),
                                    (665, False), (1577, False)])
def test_wide_scans_fold_on_each_route(cuda, C, unit):
    """Past SCAN_FOLD frames (T = 150, two folds) the wide log and
    forward scans, on the route the rule picks and on the grid route's
    launches, equal their plain versions with the fold, offsets included
    (non-zero past the first column): at unit-scale emissions, where only
    the chain folds, and at the D=300 scale (-400 nats a frame), where
    each class's prefix sum passes SCAN_FOLD_LIMIT every few frames."""
    Km, T = 19, 150
    pots, lengths = random_pots(np.random.RandomState(C + unit), 2, T, C, Km + 1, cuda, unit)
    scan_in = hc._stack_fwd_rev(pots, lengths.long())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    insts = {hc.wide_scan_instance(C, Km, 4, 1, sms)} | grid_variants(C, Km, 4, 1, sms)
    assert_wide_launches_equal_plain(scan_in, insts)
    _, _, offsets = hc.hsmm_log_scan(*scan_in)
    torch.cuda.synchronize()
    assert offsets.shape == (4, 3) and (offsets[:, 1:] != 0).any()


@pytest.mark.parametrize("C", (665, 1577))
@pytest.mark.parametrize("N,group", [(1, 1), (2, 1), (2, 2), (18, 1), (18, 9), (18, 18),
                                     (36, 1), (36, 18), (36, 36)])
def test_wide_grid_chains_and_tables_equal_plain(cuda, C, N, group):
    """The grid route at N = 1, 2, 18 and 36 chains, `group` of them a
    table (a table a chain, the stacked forward and reversed chains' two,
    one for all), ragged lengths down to 1: each instance on each launch
    of ``grid_variants`` equal to its plain version on the same tables
    copied a chain."""
    Km, T = 19, 8
    rng = np.random.RandomState(C + N + group)
    trans1, init, dur, emit = scan_inputs(rng, -(-N // group), T, C, Km, cuda)
    _, init, dur, emit = scan_inputs(rng, N, T, C, Km, cuda)
    G = trans1.shape[0]
    trans = trans1[:, None].expand(G, group, C, C) if group > 1 else trans1
    if group == N:
        trans = trans1.expand(N, C, C)
    lengths = torch.from_numpy(rng.randint(1, T + 1, size=N)).to(cuda)
    lengths[0], lengths[-1] = T, 1
    emit = emit * (torch.arange(T, device=cuda)[None, :, None] < lengths[:, None, None])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    insts = grid_variants(C, Km, N, group, sms)
    assert_wide_launches_equal_plain((trans, init, dur, emit.contiguous()), insts)
    assert torch.equal(hc._dense_trans(trans), trans1.repeat_interleave(group, 0)[:N])


@pytest.mark.parametrize("C", (665, 1577, 3000))
def test_wide_grid_at_one_step(cuda, C):
    """T = 1 on the grid route (one barrier): equal to plain; and the grid
    barrier alone over a full grid (tools/scan_ab.py's probe) counts every
    block's every step."""
    rng = np.random.RandomState(C)
    scan_in = scan_inputs(rng, 4, 1, C, 19, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert_wide_launches_equal_plain(scan_in, grid_variants(C, 19, 4, 1, sms))
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    err = hc._call("hsmm_scan_wide", "hsmm_wide_grid_barrier", [counter], [sms, 256, 64], counter)
    torch.cuda.synchronize()
    assert err == 0 and int(counter) == 64 * sms


def test_wide_scans_at_the_s6_shape_equal_plain(cuda):
    """The S6 shape (342 classes, K = 20, 1,024 frames, 18 videos) on the
    cluster route (3 blocks a chain): the max scan's alphas and codes and
    the forward scan's alphas (the first 64 frames: the plain log scan is
    a Python loop over C) equal to the plain versions'."""
    pots, lengths = random_pots(np.random.RandomState(342), 18, 1024, 342, 20, cuda)
    vit_in = (pots.trans.contiguous(), pots.init.contiguous(),
              th._durations(pots.lens).contiguous(), pots.emit.contiguous())
    assert hc.wide_scan_instance(342, 19)[:2] == ("cluster", 3)
    alphas, bp = hc.hsmm_viterbi_scan(*vit_in)
    want = hc._viterbi_scan_plain(*vit_in)
    fwd_in = (*vit_in[:3], vit_in[3][:, :64].contiguous())
    fwd, _ = hc.hsmm_forward_scan(*fwd_in)
    torch.cuda.synchronize()
    assert torch.equal(alphas, want[0]) and torch.equal(bp, want[1])
    assert torch.equal(fwd, hc._forward_scan_plain(*fwd_in)[0])


@pytest.mark.parametrize("C,Km", [(342, 19), (1577, 19), (1577, 64)])
def test_wide_scans_share_an_expanded_table(cuda, C, Km):
    """A batch whose transition table is one expanded view (batch stride
    0, as a model's potentials give it) goes to the kernel as one table
    that every chain reads: each instance's outputs, on the route
    ``wide_scan_instance`` picks and on the grid route's launches, equal
    to those of the same table copied a chain through the wrappers (a
    table a chain: on the grid route its slab read from global memory)."""
    rng = np.random.RandomState(C + Km)
    N, T = 4, 16
    trans1, init, dur, emit = scan_inputs(rng, 1, T, C, Km, cuda)
    init, dur, emit = (x.expand((N,) + x.shape[1:]).contiguous() + 0.5 * torch.arange(
        N, device=cuda).view((N,) + (1,) * (x.ndim - 1)) for x in (init, dur, emit))
    shared = trans1.expand(N, C, C)
    copied = shared.contiguous()
    want = {"hsmm_wide_viterbi_scan": hc.hsmm_viterbi_scan_wide(copied, init, dur, emit),
            "hsmm_wide_log_scan": hc.hsmm_log_scan_wide(copied, init, dur, emit),
            "hsmm_wide_forward_scan": hc.hsmm_forward_scan_wide(copied, init, dur, emit)}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for inst in {hc.wide_scan_instance(C, Km, N, N, sms)} | grid_variants(C, Km, N, N, sms):
        for symbol, kind in WIDE_SCAN_CALLS:
            radix = [hc.code_radix(C)] if "b" in kind else []
            outs = wide_outputs(kind, emit)
            hc._launch_wide_scan(symbol, symbol, shared, init, dur, emit, outs, radix, inst=inst)
            torch.cuda.synchronize()
            for got, exp in zip(outs, want[symbol]):
                assert torch.equal(got, exp), (symbol, inst)
    alphas, bp = hc.hsmm_viterbi_scan(shared, init, dur, emit)
    want = hc._viterbi_scan_plain(copied, init, dur, emit)
    torch.cuda.synchronize()
    assert torch.equal(alphas, want[0]) and torch.equal(bp, want[1])


def test_wide_cluster_launch_refused_raises(cuda, monkeypatch):
    """A cluster the card does not take (16 blocks, past the portable 8,
    without the non-portable opt-in) is refused at the launch: the wrapper
    raises and counts no launch; the rule never asks for one."""
    C, Km = 342, 19
    slab = -(-C // 16)
    refused = hc.WideScan("cluster", 16, slab, 1, 32, 32 * -(-slab // 32), "shared", "shared",
                          hc.wide_cluster_smem(C, Km, slab), 2)
    monkeypatch.setattr(hc, "wide_scan_instance", lambda *_: refused)
    scan_in = scan_inputs(np.random.RandomState(16), 2, 8, C, Km, cuda)
    before = launches(WIDE_KERNELS)
    for scan in (hc.hsmm_viterbi_scan_wide, hc.hsmm_log_scan_wide, hc.hsmm_forward_scan_wide):
        with pytest.raises(RuntimeError):
            scan(*scan_in)
    assert launches(WIDE_KERNELS) == before


def test_wide_max_active_clusters_at_the_s6_shape(cuda):
    """cudaOccupancyMaxActiveClusters of each instance at the S6 shape: at
    least one cluster of 3, at most one a 3 SMs; the grid route raises."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for scan in hc.WIDE_SCAN_INDEX:
        n = hc.wide_max_active_clusters(scan, 342, 19, cuda.index or 0)
        assert 1 <= n <= sms // 3, (scan, n)
    with pytest.raises(ValueError):
        hc.wide_max_active_clusters("log", 1024, 19)

