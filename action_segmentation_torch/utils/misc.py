"""Small host-side helpers."""

import pickle


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
