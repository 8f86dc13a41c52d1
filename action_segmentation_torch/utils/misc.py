"""Small host-side helpers."""


def all_equal(xs):
    xs = list(xs)
    return all(x == xs[0] for x in xs[1:])
