"""The pair kernel's algorithm (csrc/pair_grad.cu: the sum over frames as a
float64 tensor-core product of operands scaled by tile and frame, the
tile-frames past theta, or holding a NaN, summed term by term) in its
float64 emulation, ``hsmm_cuda._pair_grad_scaled``, against the plain
version in float64 and, inside the port's backward, against the JAX
package.

The emulation is held to ``_pair_grad_plain`` in float64 within rtol 1e-6
/ atol 1e-10: only the sum's association and the operands' scales differ.
The port's trans cotangent through it is held to JAX's (its kernel
partition in interpret mode up to 128 classes, autodiff of its plain
partition above; tests/test_torch_pair_grad.py's harness) at the JAX
package's gradient tolerance (rtol 2e-3 / atol 2e-4). The kernel itself is
held to the float64 plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg
from tests.test_torch_pair_grad import draw, jax_grads, pair_draw, port_grads
from tests.torch_pair_cases import masked_pair_draw, nan_pair_draw

RTOL64, ATOL64 = 1e-6, 1e-10
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
CPU = torch.device("cpu")


def assert_scaled_matches_plain64(pair_in):
    got = hc._pair_grad_scaled(*pair_in)
    want = hc._pair_grad_plain64(*pair_in)
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL64, atol=ATOL64)


def backward_inputs(arrays, lengths):
    """(X, Y, trans, Z, lengths) as the port's backward forms them from the
    plain log scan and band gradient (``hsmm_grad._pair_inputs``: X =
    alphas, Z = logZ up to 64 frames; anchored per chunk, Z = 0, past
    them)."""
    pots = th.HsmmPotentials(*[torch.from_numpy(a) for a in arrays])
    L = torch.from_numpy(lengths).long()
    B, T = pots.emit.shape[:2]
    gamma, alphas, offsets = hc._log_scan_plain(*hc._stack_fwd_rev(pots, L))
    lse, _ = hg._log_partition(alphas[:B], offsets[:B], L, pots.end_mask)
    gb = hc._grad_band_inputs(pots, L, gamma, offsets, lse)
    qg = hc._band_grad_chunked(hc._band_grad_plain, gb, T)[0]
    X, Y, Z = hg._pair_inputs(pots, gb, qg, alphas[:B], lse)
    return X, Y, pots.trans, Z, L


def constrained(arrays, seed, keep=0.4):
    """The draw with a constraint mask on its transitions: about 1 - keep
    of each table's entries BIG_NEG, the diagonal too, each row keeping one
    entry off it."""
    rng = np.random.RandomState(seed)
    trans = arrays[0].copy()
    B, C, _ = trans.shape
    masked = rng.rand(B, C, C) > keep
    masked[:, np.arange(C), np.arange(C)] = True
    masked[:, np.arange(C), (np.arange(C) + 1) % C] = C == 1
    trans[masked] = BIG_NEG
    return [trans] + list(arrays[1:])


def scaled32(X, Y, trans, Z, lengths):
    """The emulation in the backward's place of the pair sum."""
    return hc._pair_grad_scaled(X, Y, trans, Z, lengths).to(X.dtype)


SCALED = hg.PLAIN._replace(pair_grad=scaled32)


@pytest.mark.parametrize("expanded", [True, False], ids=["expanded", "per-video"])
@pytest.mark.parametrize("T,C,scale", [
    (17, 7, 1.0),  # D=300, unanchored: |X|, |Z| ~ 7e3
    (64, 19, 1.0),  # the fold's period: |X|, |Z| ~ 2.6e4
    (130, 33, 0.01),
    (40, 1, 1.0),  # one class, its only pair masked
    (30, 136, 1.0),  # tiles of 64, 64 and 8 classes a side
    (20, 342, 1.0),
])
def test_scaled_matches_plain64_on_pair_draws(T, C, scale, expanded):
    X, Y, trans, Z, L = pair_draw(T + C, 3, T, C, scale)
    if not expanded:
        trans = trans + torch.from_numpy(
            np.random.RandomState(C).randn(3, 1, C).astype(np.float32) * 0.1)
    assert_scaled_matches_plain64((X, Y, trans, Z, L))


@pytest.mark.parametrize("B,T,C,K,d300", [
    (3, 40, 5, 6, True),  # T <= 64: X = alphas, Z = logZ at the D=300 scale
    (3, 64, 19, 8, True),
    (3, 80, 6, 5, False),  # past 64: anchored per chunk, Z = 0
    (2, 150, 19, 8, True),
    (2, 70, 70, 6, False),
])
def test_scaled_matches_plain64_on_backward_inputs(B, T, C, K, d300):
    arrays, lengths = draw(B * 7 + T + C, B, T, C, K)
    if d300:
        arrays[3] = (arrays[3] * 3 - 400).astype(np.float32)
    assert_scaled_matches_plain64(backward_inputs(arrays, lengths))


@pytest.mark.parametrize("gaps", [(100.0,), (800.0,), (5000.0,), (100.0, 800.0, 5000.0)],
                         ids=["100", "800", "5000", "mixed"])
@pytest.mark.parametrize("C", [1, 19, 70])
def test_scaled_matches_plain64_where_a_masked_pair_dominates(C, gaps):
    pair_in = masked_pair_draw(np.random.RandomState(C), 3, 100, C, gaps, CPU)
    assert_scaled_matches_plain64(pair_in)


@pytest.mark.parametrize("C", [19, 70])
def test_masked_draw_crosses_theta_both_ways(C):
    """A gap of 100 nats stays in the product, 800 and 5,000 take the exact
    path in the tiles that hold the dominant pair; the mixed draw takes
    both within one tile."""
    split = {gaps: hc.pair_grad_split(*masked_pair_draw(np.random.RandomState(C), 3, 100,
                                                         C, gaps, CPU))
             for gaps in ((100.0,), (5000.0,), (100.0, 800.0, 5000.0))}
    assert split[(100.0,)].exact == 0 and split[(100.0,)].product > 0
    assert split[(5000.0,)].exact > 0
    assert split[(100.0, 800.0, 5000.0)].exact > 0 and split[(100.0, 800.0, 5000.0)].product > 0
    if C <= hc.PAIR_TILE:  # one tile: every frame of the 5,000-nat draw past theta
        assert split[(5000.0,)].exact == split[(5000.0,)].frames


@pytest.mark.parametrize("gaps", [(800.0,), (5000.0,)], ids=["800", "5000"])
def test_exact_path_is_what_keeps_the_sum_finite(gaps):
    """Past float64's range the product alone is not finite (a masked
    pair's operand overflows, inf x 0 in its scale); with the exact path
    past theta it is the plain version's sum."""
    pair_in = masked_pair_draw(np.random.RandomState(5), 3, 100, 19, gaps, CPU)
    assert not torch.isfinite(hc._pair_grad_scaled(*pair_in, theta=float("inf"))).all()
    assert_scaled_matches_plain64(pair_in)


def test_scaled_on_a_tile_whose_pairs_are_all_masked():
    """A tile of pairs all BIG_NEG: tau is their largest, every operand
    underflows and the tile's sums are 0, as the plain version's."""
    X, Y, trans, Z, L = pair_draw(3, 3, 40, 70, 0.01)
    trans = trans.clone()
    trans[:, :64, :64] = BIG_NEG
    got = hc._pair_grad_scaled(X, Y, trans, Z, L)
    assert torch.equal(got[:, :64, :64], torch.zeros_like(got[:, :64, :64]))
    assert_scaled_matches_plain64((X, Y, trans, Z, L))


@pytest.mark.parametrize("C", [5, 70])
def test_scaled_under_constraint_masks(C):
    arrays, lengths = draw(C, 3, 60, C, 6)
    arrays = constrained(arrays, C)
    assert_scaled_matches_plain64(backward_inputs(arrays, lengths))


@pytest.mark.parametrize("lengths", [[1, 1, 1], [2, 2, 2], [1, 2, 40]])
def test_scaled_at_lengths_of_one_and_two(lengths):
    """A video of one frame has no interior boundary (its sum is 0), one
    of two frames a single one."""
    X, Y, trans, Z, _ = pair_draw(11, 3, 40, 19, 0.01)
    L = torch.tensor(lengths)
    got = hc._pair_grad_scaled(X, Y, trans, Z, L)
    for b, n in enumerate(lengths):
        if n == 1:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
    assert_scaled_matches_plain64((X, Y, trans, Z, L))


def test_split_counts_every_interior_tile_frame():
    """Each (video, tile, interior frame) goes into the product, the exact
    path or is left out, once."""
    X, Y, trans, Z, L = masked_pair_draw(np.random.RandomState(2), 4, 90, 70,
                                         (100.0, 800.0, 5000.0), CPU)
    split = hc.pair_grad_split(X, Y, trans, Z, L)
    tiles = (-(-70 // hc.PAIR_TILE)) ** 2
    assert split.frames == int((L.clamp(1, 90) - 1).sum()) * tiles
    assert split.product + split.exact + split.dead == split.frames
    assert split.dead > 0 and 0 < split.exact_share < 1


@pytest.mark.parametrize("C", [19, 70, 136])
def test_scaled_propagates_nan_as_plain64(C):
    """A NaN in X, Y, Z or trans (``nan_pair_draw``): NaN where the plain
    version in float64 has it (a column, a row, a video, an entry), its sum
    elsewhere; a NaN at a frame no sum reads, or in a video of one frame,
    reaches nothing."""
    pair_in = nan_pair_draw(np.random.RandomState(C), 60, C, CPU)
    got = hc._pair_grad_scaled(*pair_in)
    want = hc._pair_grad_plain64(*pair_in)
    assert want.isnan().flatten(1).any(1).tolist() == [True] * 4 + [False] * 2
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    torch.testing.assert_close(got, want, rtol=RTOL64, atol=ATOL64, equal_nan=True)


def test_split_sends_nan_tile_frames_to_the_exact_path():
    """A tile-frame whose gap is NaN (a NaN among its X, Y or Z) is summed
    term by term: the column's tiles at video 0's frame 1, the row's at
    video 1's, every tile-frame of video 2; a NaN in trans leaves the
    gaps alone."""
    pair_in = nan_pair_draw(np.random.RandomState(3), 60, 70, CPU)
    _, _, _, gap, interior = hc.pair_scales(*pair_in)
    inside = interior[:, :, None, None].expand_as(gap)
    tiles = (-(-70 // hc.PAIR_TILE)) ** 2
    nan = gap.isnan() & inside
    assert int(nan.sum()) == tiles * (int(pair_in[4][2]) - 1) + 2 + 2
    assert not nan[3].any()
    split = hc.pair_grad_split(*pair_in)
    assert split.exact == int((inside & ((gap > hc.PAIR_THETA) | gap.isnan())).sum())
    assert split.product + split.exact + split.dead == split.frames


@pytest.mark.parametrize("B,T,C,K,end_mask,masks", [
    (3, 20, 5, 6, True, False),  # T <= 64: X = alphas, Z = logZ
    (3, 80, 6, 5, True, False),  # past it: anchored per chunk, Z = 0
    (4, 40, 19, 8, False, False),
    (3, 30, 6, 4, False, True),  # constraint masks on the transitions
])
def test_trans_cotangent_through_scaled_matches_jax(B, T, C, K, end_mask, masks):
    arrays, lengths = draw(B * 11 + T, B, T, C, K, end_mask=end_mask)
    if masks:
        arrays = constrained(arrays, T)
    lengths[1] = 2  # one interior boundary
    want = jax_grads(arrays, lengths, wide=False)
    got = port_grads(arrays, lengths, kernels=SCALED)
    np.testing.assert_allclose(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("T", [24, 72])
def test_expanded_trans_cotangent_through_scaled_matches_jax(T):
    B, C, K = 3, 5, 4
    arrays, lengths = draw(T + 1, B, T, C, K)
    arrays[0] = np.repeat(arrays[0][:1], B, axis=0)
    want = jax_grads(arrays, lengths, wide=False)
    got = port_grads(arrays, lengths, expand_trans=True, kernels=SCALED)
    np.testing.assert_allclose(got[0], want[0].sum(axis=0), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_wide_trans_cotangent_through_scaled_matches_jax():
    """Above 128 classes (tiles of 64, 64 and 2 a side), against autodiff
    of JAX's plain partition."""
    B, T, C, K = 2, 16, 130, 4
    arrays, lengths = draw(C + T + 1, B, T, C, K)
    want = jax_grads(arrays, lengths, wide=True)
    got = port_grads(arrays, lengths, kernels=SCALED)
    np.testing.assert_allclose(got[0], want[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
