"""K4's wide kernel (csrc/band_grad.cu ``band_grad_wide_kernel``) on the CPU:
its launch rule (``hsmm_cuda.band_grad_wide_tile``) against an H100's
limits and the lg scratch's bound, and the wrapper's pick of a kernel by
the class count. The kernel itself runs on the card
(tests/test_torch_gpu.py, chip_smoke.py phases 4i and 4j); the function
it computes is ``_band_grad_plain``'s, held to JAX by
tests/test_torch_hsmm_grad.py and tests/test_torch_wide.py.
"""

import pytest
import torch

from action_segmentation_torch.ops import hsmm_cuda as hc

SMS = 132
WIDE_BAND_CLASSES = (129, 342, 664, 1024, 1025, 1577, 2048, 3000)
VIDEOS_AND_FRAMES = ((18, 1024), (1, 1056), (4, 200), (2, 12000))


@pytest.mark.parametrize("Km", (0, 1, 19, 64, 100))
@pytest.mark.parametrize("B,T", VIDEOS_AND_FRAMES)
@pytest.mark.parametrize("C", WIDE_BAND_CLASSES)
def test_wide_band_grad_tile_fits_the_card(C, B, T, Km):
    """Blocks of 8 warps over 32 classes (at most 256 threads, the
    kernel's launch bound) covering C; runs of whole rows covering T,
    each warp's rows w, w + 8, ... once; a slab of every duration up to
    27 (8 blocks' slabs in an SM), else 27 a pass, none at Km = 0, within
    a block's and an SM's shared memory for the blocks it keeps resident
    by threads and registers; the lg partials (none at one run) within
    one (B, T, C) plane; a block for every resident slot where any
    allowed run count gives one; of the run counts allowed, the fewest
    of those whose rounds of resident blocks times a run's rows and Km
    rows of halo are least."""
    tile = hc.band_grad_wide_tile(B, T, C, Km, SMS)
    assert tile.warps == hc.BAND_GRAD_WIDE_WARPS and tile.threads == 32 * tile.warps <= 256
    assert tile.groups == -(-C // hc.BAND_GRAD_WIDE_CLASSES) and 32 * (tile.groups - 1) < C
    assert 1 <= tile.rows <= T and tile.tiles == -(-T // tile.rows)
    walked = sorted(run * tile.rows + w + tile.warps * j
                    for run in range(tile.tiles) for w in range(tile.warps)
                    for j in range(-(-tile.rows // tile.warps))
                    if w + tile.warps * j < tile.rows and run * tile.rows + w + tile.warps * j < T)
    assert walked == list(range(T))
    assert tile.slab == min(Km, 27)
    assert tile.smem_bytes == 4 * tile.slab * tile.threads <= hc.MAX_BLOCK_SMEM
    assert tile.blocks_per_sm == 8
    assert tile.blocks_per_sm * (tile.smem_bytes + hc.SM_SMEM_PER_BLOCK) <= hc.SM_SMEM
    assert tile.blocks_per_sm * tile.threads <= hc.SM_THREADS
    assert tile.blocks_per_sm * tile.threads * hc.BAND_GRAD_WIDE_REGS <= hc.SM_REGS
    plane = 4 * B * T * C
    assert tile.scratch_bytes == (4 * B * tile.tiles * Km * C if tile.tiles > 1 else 0)
    assert tile.scratch_bytes <= plane
    lines, slots = B * tile.groups, SMS * tile.blocks_per_sm
    assert tile.waves == -(-lines * tile.tiles // slots) and 0 < tile.filling <= 1
    # the run counts that whole runs of rows give
    allowed = sorted({-(-T // -(-T // n)) for n in range(1, T + 1)
                      if n == 1 or (n * Km <= T and n * 8 <= T)})
    if any(lines * n >= slots for n in allowed):
        assert lines * tile.tiles >= slots
        allowed = [n for n in allowed if lines * n >= slots]
    cost = lambda n: -(-lines * n // slots) * (-(-T // n) + Km)  # noqa: E731
    best = min(cost(n) for n in allowed)
    assert tile.tiles == min(n for n in allowed if cost(n) == best)


def test_wide_band_grad_tile_at_the_timed_shapes():
    """18 videos of 1,024 frames, Km = 19: over the S6 model's 342 classes
    10 runs of 103 rows a video (1,980 blocks, two rounds of the card's
    1,056 slots; 4.68 MB of partials against the narrow kernel's 239.5
    MB and a 25.2 MB plane); over 1,577 classes 7 runs of 147 rows (6,300
    blocks, 15.1 MB against 2,209 MB and a 116.3 MB plane); 2 videos of
    12,000 frames over 342 classes 48 runs of 250 rows (one full round,
    2.50 MB)."""
    s6 = hc.band_grad_wide_tile(18, 1024, 342, 19, SMS)
    assert (s6.rows, s6.tiles, s6.groups, s6.slab, s6.waves) == (103, 10, 11, 19, 2)
    assert s6.scratch_bytes == 4 * 18 * 10 * 19 * 342 == 4678560
    wide = hc.band_grad_wide_tile(18, 1024, 1577, 19, SMS)
    assert (wide.rows, wide.tiles, wide.groups, wide.waves) == (147, 7, 50, 6)
    assert wide.scratch_bytes == 4 * 18 * 7 * 19 * 1577 == 15101352 < 4 * 18 * 1024 * 1577
    long = hc.band_grad_wide_tile(2, 12000, 342, 19, SMS)
    assert (long.rows, long.tiles, long.scratch_bytes, long.filling) == (250, 48, 2495232, 1.0)
    # the narrow kernel's tile at the same shapes, for the record
    assert hc.band_grad_tile(18, 1024, 342, 19).tiles == 512
    assert hc.band_grad_tile(18, 1024, 1577, 19).tiles == 1024
    # the rule follows the card's SM count
    assert hc.band_grad_wide_tile(18, 1024, 342, 19, sms=66).tiles != s6.tiles


@pytest.mark.parametrize("C,blocks", [(129, 5760), (342, 12672), (1577, 57600)])
def test_wide_band_grad_tile_on_the_backwards_chunks(C, blocks):
    """The backward's band inputs at every width are a video's chunks of
    BAND_CHUNK rows, each a video of its own rows and a halo of Km (18
    videos of 1,024 frames at Km = 19: 1,152 of 35 rows): one run a
    chunk, every duration in the slab, no partials and no ticket, and a
    block for every resident slot of the card many times over."""
    n = -(-1024 // hc.BAND_CHUNK)
    tile = hc.band_grad_wide_tile(18 * n, hc.BAND_CHUNK + 19, C, 19, SMS)
    assert (tile.rows, tile.tiles, tile.slab, tile.scratch_bytes) == (35, 1, 19, 0)
    assert 18 * n * tile.groups == blocks and tile.waves == -(-blocks // (SMS * 8))


@pytest.mark.parametrize("C", (19, 128, 129, 342, 1577))
def test_band_grad_picks_its_kernel_by_the_class_count(monkeypatch, C):
    """``hsmm_band_grad`` on card tensors (the card stood in for) launches
    the narrow kernel in ``band_grad_tile``'s tile up to 128 classes and
    the wide one in ``band_grad_wide_tile``'s past them, each counting
    its own launch; on CPU tensors it runs the plain version and counts
    none."""
    B, T, Km = 2, 40, 5
    launched = []
    monkeypatch.setattr(hc, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(hc, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(hc, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(hc, "_launch_band_grad",
                        lambda *a: launched.append(("narrow", a[-1])) or "narrow")
    monkeypatch.setattr(hc, "_launch_band_grad_wide",
                        lambda *a: launched.append(("wide", a[-1])) or "wide")
    G1m, G2p, dur = torch.zeros(B, T, C), torch.zeros(B, T + Km, C), torch.zeros(B, Km, C)
    before = (hc.hsmm_band_grad.launches, hc.hsmm_band_grad_wide.launches)
    out = hc.hsmm_band_grad(G1m, G2p, dur)
    after = (hc.hsmm_band_grad.launches, hc.hsmm_band_grad_wide.launches)
    if C <= hc.MAX_CLASSES:
        assert launched == [("narrow", hc.band_grad_tile(B, T, C, Km, SMS))] and out == "narrow"
        assert after == (before[0] + 1, before[1])
    else:
        assert launched == [("wide", hc.band_grad_wide_tile(B, T, C, Km, SMS))] and out == "wide"
        assert after == (before[0], before[1] + 1)
    monkeypatch.undo()
    got = hc.hsmm_band_grad(G1m, G2p, dur)
    want = hc._band_grad_plain(G1m, G2p, dur)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (hc.hsmm_band_grad.launches, hc.hsmm_band_grad_wide.launches) == after
