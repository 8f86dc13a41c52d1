"""The scan kernels' instances, the traceback's tile, and the build
cache's key, on the CPU.

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
