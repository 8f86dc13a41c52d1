"""Levenshtein distance over integer token sequences.

Plain unit-cost edit distance, matching the reference's
``editdistance.eval``. The sequences are segment label runs (tens of
tokens), so a numpy row DP is enough.
"""

import numpy as np


def eval(a, b):
    """Edit distance between two integer sequences."""
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
        # running dependency on cur[j-1] forces a scalar loop; arrays here
        # are short segment sequences so this is cheap
        for j in range(1, len(b) + 1):
            cur[j] = min(sub[j - 1], prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])
