"""The port's native edit distance.

``evaluation/editdistance.eval`` runs ``csrc/editdistance.cpp``, which
g++ builds into the port's ``build/`` directory at first use: equal to
its numpy row DP (``_eval_plain``) and to the JAX package's
``editdistance.eval`` on drawn integer sequences, empty ones included;
built from the port's own copy of the source (``native/`` untouched);
and raising, with no fallback, when the compiler is missing.
"""

import os
import shutil
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from action_segmentation_torch.evaluation import editdistance as ted
from action_segmentation_torch.ops import _build
from action_segmentation_tpu.evaluation import editdistance as jed

ROOT = Path(__file__).resolve().parent.parent
SEQS = st.lists(st.integers(min_value=-3, max_value=12), max_size=24)


@given(SEQS, SEQS)
@settings(max_examples=200, deadline=None)
def test_native_matches_plain_and_jax(a, b):
    want = ted._eval_plain(a, b)
    assert ted.eval(a, b) == want == jed.eval(a, b)
    assert ted.eval(b, a) == want  # symmetric
    assert (want == 0) == (a == b)


def test_known_distances():
    assert ted.eval([], []) == 0
    assert ted.eval([], [1, 2, 3]) == 3 and ted.eval([4, 5], []) == 2
    assert ted.eval([1, 2, 3, 4], [1, 3, 4, 5]) == 2  # kitten/sitting-style
    assert ted.eval(list(range(300)), list(range(1, 301))) == 2


def _native_snapshot():
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in (ROOT / "native").iterdir())


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no cached handle; the caches are
    cleared again afterwards, so later calls load the real build."""
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    _build.load_host_library.cache_clear()
    ted._native.cache_clear()
    yield tmp_path / "build"
    _build.load_host_library.cache_clear()
    ted._native.cache_clear()


def test_library_builds_from_the_ports_source(fresh_build):
    before = _native_snapshot()
    assert ted.eval([1, 2, 2], [2, 2]) == 1
    so = _build.host_library_path("editdistance")
    assert so.parent == fresh_build and so.exists()
    assert so.name.startswith("libeditdistance-")
    assert not [p for p in fresh_build.iterdir() if p.suffix == ".tmp"]
    assert _native_snapshot() == before
    # the real build directory is the package's own
    assert _build.CSRC == ROOT / "action_segmentation_torch" / "csrc"
    assert (_build.CSRC / "editdistance.cpp").exists()


def test_eval_raises_without_a_compiler(fresh_build, monkeypatch):
    which = shutil.which
    monkeypatch.setattr(_build.shutil, "which",
                        lambda name, *a, **k: None if name == "g++" else which(name, *a, **k))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        ted.eval([1], [2])
    assert not fresh_build.exists() or not os.listdir(fresh_build)


def test_eval_raises_when_the_build_fails(fresh_build, monkeypatch):
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ["-DNO_SUCH_FLAG", "-x",
                                                                   "no-such-language"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for editdistance"):
        ted.eval([1], [2])
