"""The scan kernels' instances, the traceback's tile, the band max's
and the band gradient's tiles, and the build cache's key, on the CPU.

``hsmm_cuda.scan_instance(C, Km)`` picks the instance of the scan
template (csrc/hsmm_scan_core.cuh) that a shape launches and sizes its
shared memory; the launch passes both on. These tests check the picks
against an H100 block's limits at every instance boundary and at every
shape the earlier shared-memory scans (one layout for every shape:
C*C + 2*Km*C + 2*C floats within the block's shared memory) took.
"""

import pytest

from action_segmentation_torch.ops import _build
from action_segmentation_torch.ops import hsmm_cuda as hc


def test_instances_fit_the_block_limits():
    """Every (C, Km) the earlier kernels took, at each bucket's edge, one
    past it and the longest band, launches an instance whose threads and
    trans row cover C, with the shared-memory tail exactly when Km passes
    the carry's registers, and which fits 1,024 threads and 232,448
    bytes. The tail's durations leave shared memory only where staging
    them would not fit: at C <= 9 with bands of thousands of rows."""
    for C in range(1, hc.MAX_CLASSES + 1):
        km_max = (hc.MAX_BLOCK_SMEM // 4 - C * C - 2 * C) // (2 * C)
        for Km in sorted({1, 2, 19, 24, 25, 32, 33, 64, 65, 100, km_max - 1, km_max}):
            if not 1 <= Km <= km_max:
                continue
            inst = hc.scan_instance(C, Km)
            where = (C, Km, inst)
            assert C <= inst.threads == 32 * inst.warps <= hc.MAX_BLOCK_THREADS, where
            assert inst.warps == 1 or inst.threads // 2 < C, where  # the fewest warps
            assert inst.row == 0 or inst.row >= C, where
            assert (inst.tail > 0) == (Km > hc.SCAN_CARRY), where
            assert 0 < inst.smem_bytes <= hc.MAX_BLOCK_SMEM, where
            staged = inst.smem_bytes + 4 * (Km - hc.SCAN_CARRY) * C
            assert inst.tail != 2 or (staged > hc.MAX_BLOCK_SMEM and C <= 9), where


def test_serving_shape_takes_the_register_instance():
    """The serving width (C=19, Km=19) and the CrossTask tasks' (20 wide)
    take one warp with the trans row in 24 registers, no tail, and two
    shared alpha rows beside the emission window; a row past the carry's
    registers adds a tail row and its durations, 2 * C floats."""
    serving = 4 * (hc.SCAN_WINDOW * 32 + 2 * 32)
    assert hc.scan_instance(19, 19) == (1, 24, 0, 32, serving)
    assert hc.scan_instance(20, 19) == (1, 24, 0, 32, serving)
    assert hc.scan_instance(19, 25) == (1, 24, 1, 32, serving + 4 * 2 * 19)


@pytest.mark.parametrize("C", (1, 19, 20, 128))
@pytest.mark.parametrize("T", (1, 19, 100, 834, 1024, 12000, 28900))
def test_traceback_tile_fits_the_block(C, T):
    """The traceback's tile (``hsmm_cuda.traceback_tile``) at the widths
    and lengths the kernels take (T up to the longest band, Km = 28,900,
    since the walk handles a jump of any length): at least one row and
    at most T, two buffers of rows * C codes (each up to 3 words in, for
    the bulk copy's alignment) beside the 16-byte header within 232,448
    bytes, with as many rows as fit."""
    tile = hc.traceback_tile(T, C)
    words = hc._tile_words(tile.rows, C)  # one buffer
    assert 1 <= tile.rows <= T
    assert words >= tile.rows * C + 3 and words % 4 == 0
    assert tile.smem_bytes == hc.TRACEBACK_HEADER + 2 * 4 * words <= hc.MAX_BLOCK_SMEM
    if tile.rows < T:  # the most rows that fit
        assert hc.TRACEBACK_HEADER + 8 * hc._tile_words(tile.rows + 1, C) > hc.MAX_BLOCK_SMEM
    assert hc.traceback_tile(T, C, max_rows=7).rows == min(7, tile.rows)


def test_serving_and_crosstask_planes_are_one_tile():
    """A serving video (T=1024, C=19) and a CrossTask batch's (T up to
    1056 after the bucket, C=20) walk one tile staged in one copy."""
    assert hc.traceback_tile(1024, 19) == (1024, 16 + 2 * 4 * (1024 * 19 + 4))
    assert hc.traceback_tile(1056, 20).rows == 1056
    assert hc.traceback_tile(12000, 19).rows == 1528


@pytest.mark.parametrize("Km", (0, 1, 19, 64, 100))
@pytest.mark.parametrize("T", (1, 19, 100, 1024, 12000))
@pytest.mark.parametrize("C", (1, 19, 20, 33, 128))
def test_band_grad_tile_fits_the_block(C, T, Km):
    """K4's tile (``hsmm_cuda.band_grad_tile``) for 18 videos on 132 SMs:
    at least one row and at most T, at most 1,024 threads, a slab of M
    (slab x threads floats) within a block's 232,448 bytes and, beside a
    KB each, within an SM's shared memory for the blocks it keeps
    resident, which fit its 64 warps and its registers at the kernel's
    32 a thread. The slab covers the band: all of it, or as many
    durations as that room holds (no slab at Km = 0). The tile's rows
    leave the busiest SM the fewest warps of any allowed rows."""
    B, sms = 18, 132
    tile = hc.band_grad_tile(B, T, C, Km, sms)
    warps = -(-tile.threads // 32)
    assert 1 <= tile.rows <= T
    assert tile.threads == tile.rows * C <= hc.MAX_BLOCK_THREADS
    assert tile.tiles == -(-T // tile.rows)
    assert tile.smem_bytes == 4 * tile.slab * tile.threads <= hc.MAX_BLOCK_SMEM
    assert tile.blocks_per_sm * (tile.smem_bytes + hc.SM_SMEM_PER_BLOCK) <= hc.SM_SMEM
    assert tile.blocks_per_sm * warps <= 64
    assert tile.blocks_per_sm * warps * 32 * hc.BAND_GRAD_REGS <= hc.SM_REGS
    room = min(hc.MAX_BLOCK_SMEM,
               hc.SM_SMEM // tile.blocks_per_sm - hc.SM_SMEM_PER_BLOCK) // (4 * tile.threads)
    assert (tile.slab >= 1) == (Km > 0)
    assert tile.slab == Km or tile.slab == room < Km
    assert tile.waves == -(-B * tile.tiles // (sms * tile.blocks_per_sm))
    assert 0 < tile.filling <= 1 and 0 < tile.balance <= 1
    lo = min(T, -(-hc.BAND_GRAD_MIN_THREADS // C))
    busiest = [-(-B * -(-T // rows) // sms) * -(-rows * C // 32)
               for rows in range(lo, min(T, hc.MAX_BLOCK_THREADS // C) + 1)]
    assert -(-B * tile.tiles // sms) * warps == min(busiest)


def test_band_grad_tile_at_the_serving_shape_and_crosstask_fit():
    """At the serving shape (B=18, T=1024, C=19, Km=19) one slab holds
    every duration, so a block crosses two barriers in its sweep, and the
    launch fills its waves and spreads its warps at least as well as the
    earlier kernel's 512 // C = 26 rows (720 blocks of 494 threads, 4 an
    SM: 2 waves of 528 slots, 0.68 filled; the busiest SM 6 blocks of 16
    warps). At the CrossTask fit's batches (5 videos of up to 1,056 frames,
    C=20; a batch of 1) the tile leaves no SM more than one block."""
    serving = hc.band_grad_tile(18, 1024, 19, 19)
    assert serving.slab == 19 and serving.smem_bytes == 4 * 19 * serving.threads
    ideal = 18 * 1024 * 19 / 32 / 132
    assert serving.filling >= 720 / (2 * 528)
    assert serving.balance >= ideal / (6 * 16)
    assert serving == (47, 893, 19, 67868, 22, 2, 2, 0.75, ideal / (3 * 28), 19)
    for B, T in ((5, 1056), (5, 808), (1, 1056)):
        fit = hc.band_grad_tile(B, T, 20, 19)
        assert fit.slab == 19 and fit.waves == 1 and B * fit.tiles <= 132, (B, T, fit)
    assert hc.band_grad_tile(0, 0, 19, 19).filling == 0  # an empty plane launches nothing
    # the rule follows the card's SM count
    assert hc.band_grad_tile(5, 1056, 20, 19, sms=66).tiles != hc.band_grad_tile(
        5, 1056, 20, 19).tiles


@pytest.mark.parametrize("Km", (0, 1, 19, 64, 100))
@pytest.mark.parametrize("T", (1, 5, 19, 100, 1024, 12000))
@pytest.mark.parametrize("C", (1, 19, 20, 33, 128))
def test_band_max_tile_fits_the_block(C, T, Km):
    """K3's tile (``hsmm_cuda.band_max_tile``) for 18 videos on 132 SMs:
    at least one row and at most T, at most 1,024 threads, a slab of span
    terms (slab x threads floats) and, where the slab is short of the
    band, the carry of the starts' running maxima (min(rows + Km - 1, T)
    x C floats) within a block's 232,448 bytes and, beside a KB each,
    within an SM's shared memory for the blocks it keeps resident, which
    fit its 64 warps and its registers at the kernel's 32 a thread. The
    slab covers the band, or is the most durations that fit beside the
    carry, a whole number of them a pass (none at Km = 0)."""
    B, sms = 18, 132
    tile = hc.band_max_tile(B, T, C, Km, sms)
    warps = -(-tile.threads // 32)
    assert 1 <= tile.rows <= T
    assert tile.threads == tile.rows * C <= hc.MAX_BLOCK_THREADS
    assert tile.tiles == -(-T // tile.rows)
    carry = min(tile.rows + Km - 1, T) * C if tile.slab < Km else 0
    assert tile.smem_bytes == 4 * (tile.slab * tile.threads + carry) <= hc.MAX_BLOCK_SMEM
    assert tile.blocks_per_sm * (tile.smem_bytes + hc.SM_SMEM_PER_BLOCK) <= hc.SM_SMEM
    assert tile.blocks_per_sm * warps <= 64
    assert tile.blocks_per_sm * warps * 32 * hc.BAND_MAX_REGS <= hc.SM_REGS
    room = min(hc.MAX_BLOCK_SMEM,
               hc.SM_SMEM // tile.blocks_per_sm - hc.SM_SMEM_PER_BLOCK) // 4
    assert (tile.slab >= 1) == (Km > 0)
    assert tile.slab == Km <= room // tile.threads or (
        1 <= tile.slab == (room - carry) // tile.threads < Km)
    assert tile.waves == -(-B * tile.tiles // (sms * tile.blocks_per_sm))
    assert 0 < tile.filling <= 1 and 0 < tile.balance <= 1


def test_band_max_tile_at_the_serving_shape():
    """At the serving shape (B=18, T=1024, C=19, Km=19) K3 takes 47 rows
    (893 threads, 28 warps), 22 tiles a video, 396 blocks, 2 resident an
    SM, the busiest SM 3 blocks; one slab holds every duration, so a block
    crosses two barriers where the earlier kernel crossed 38 (684 blocks
    of 512 threads). A band longer than the room takes several slabs with
    the carry beside them; a band too long for even one duration beside
    the carry asks for more than a block's shared memory (the wrapper
    raises), as the earlier kernel's (Km - 1) x C halo did. Where a
    video has several tiles, the halo's share moves the pick off the rows
    that count warps alone, to the rows timed faster on the card
    (tools/scan_ab.py --kernels band_max)."""
    serving = hc.band_max_tile(18, 1024, 19, 19)
    assert serving == (47, 893, 19, 4 * 19 * 893, 22, 2, 2, 0.75,
                       18 * 1024 * 19 / 32 / 132 / (3 * 28), 19)
    assert serving == hc.band_max_tile(18, 1024, 19, 19, halo_share=0)
    for shape, rows, warps_alone in (((2, 12000, 19, 19), 47, 37), ((9, 1024, 19, 19), 37, 5),
                                     ((18, 1024, 48, 19), 21, 4), ((4, 360, 128, 19), 6, 1)):
        assert hc.band_max_tile(*shape).rows == rows
        assert hc.band_max_tile(*shape, halo_share=0).rows == warps_alone
    long_band = hc.band_max_tile(18, 1024, 19, 100)
    assert long_band.slab < 100 and long_band.smem_bytes == 4 * (
        long_band.slab * long_band.threads + (long_band.rows + 99) * 19)
    assert hc.band_max_tile(18, 1024, 19, 0).smem_bytes == 0
    assert hc.band_max_tile(4, 1024, 128, 600).smem_bytes > hc.MAX_BLOCK_SMEM
    # a batch shorter than the band: one tile, no halo
    assert hc.band_max_tile(2, 5, 4, 19).tiles == 1


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A change to any csrc/*.cuh header, or a new one, moves every
    library's content key; a change elsewhere does not."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "scan.cu").write_text('#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text("// v1\n")
    first = _build.library_path("scan")
    assert _build.library_path("scan") == first
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert _build.library_path("scan") == first
    (tmp_path / "core.cuh").write_text("// v2\n")
    second = _build.library_path("scan")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.library_path("scan") not in (first, second)
    (tmp_path / "scan.cu").write_text('#include "core.cuh"\n// edit\n')
    assert _build.library_path("scan").name.startswith("libscan-")
