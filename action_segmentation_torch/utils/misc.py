"""Small host-side helpers."""

import pickle
import time


def all_equal(xs):
    xs = list(xs)
    return all(x == xs[0] for x in xs[1:])


def nested_dict_map(nested_dict, value_map):
    """Apply ``value_map(outer_key, inner_key, value)`` over a 2-level dict."""
    return {
        outer_key: {
            inner_key: value_map(outer_key, inner_key, value)
            for inner_key, value in inner_dict.items()
        }
        for outer_key, inner_dict in nested_dict.items()
    }


def load_pickle(fname):
    with open(fname, "rb") as f:
        return pickle.load(f)


def host_ms(fn, n, warmup=3):
    """Host ms of one call of fn: n calls enqueued back to back on the
    host clock, without waiting for the card (its queue holds them)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds * 1e3 / n
