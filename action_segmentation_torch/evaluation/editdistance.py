"""Levenshtein distance over integer token sequences.

Plain unit-cost edit distance, matching the reference's
``editdistance.eval``. ``eval`` runs the native two-row DP of
``csrc/editdistance.cpp``, which ``g++`` builds into the package's
``build/`` directory at first use (``ops/_build.py``); it raises if that
build or load fails. ``_eval_plain`` is the numpy row DP it is held
against.
"""

import ctypes
import functools

import numpy as np

from action_segmentation_torch.ops import _build

_INT64_P = ctypes.POINTER(ctypes.c_int64)


@functools.cache
def _native():
    fn = _build.load_host_library("editdistance").edit_distance
    fn.restype = ctypes.c_int64
    fn.argtypes = [_INT64_P, ctypes.c_int64, _INT64_P, ctypes.c_int64]
    return fn


def eval(a, b):
    """Edit distance between two integer sequences."""
    fn = _native()
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    return int(fn(a.ctypes.data_as(_INT64_P), len(a), b.ctypes.data_as(_INT64_P), len(b)))


def _eval_plain(a, b):
    """The numpy row DP: the same distance, a Python loop per cell."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        # cur[j] depends on cur[j - 1], so the row runs cell by cell
        for j in range(1, len(b) + 1):
            cur[j] = min(sub[j - 1], prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])
