"""Span <-> frame-label codec.

Encoding: a "spans" array holds the class index at each span start and -1
for span continuations (BIO-style). Runs of equal labels longer than
``max_k - 1`` frames are split into multiple spans of at most ``max_k - 1``
frames each: with ``sm_max_span_length = K``, every span covers at most
K-1 frames, which is the longest duration the semi-Markov DP can score.

The tensor functions run on any device; the ``_np`` / ``rle`` helpers
are host-side numpy for sufficient statistics and evaluation.
"""

import numpy as np
import torch


def cummax(x, dim=0):
    """Cumulative max along `dim` (values only)."""
    return torch.cummax(x, dim=dim).values


def labels_to_spans(labels, max_k):
    """Convert per-frame labels (b, T) int to span encoding (b, T).

    Span starts keep their label; continuations become -1. Runs are split
    so no span exceeds ``max_k - 1`` frames (``max_k=None`` disables
    splitting; ``max_k <= 1`` makes every frame its own span).
    """
    b, T = labels.shape
    t_idx = torch.arange(T, device=labels.device)
    change = torch.cat(
        [
            torch.ones((b, 1), dtype=torch.bool, device=labels.device),
            labels[:, 1:] != labels[:, :-1],
        ],
        dim=1,
    )
    if max_k is None:
        start = change
    elif max_k <= 1:
        start = torch.ones_like(change)
    else:
        # position within the current run of equal labels
        run_start = cummax(
            torch.where(change, t_idx[None, :], torch.full_like(labels, -1)), dim=1
        )
        pos_in_run = t_idx[None, :] - run_start
        start = change | (pos_in_run % (max_k - 1) == 0)
    return torch.where(start, labels, torch.full_like(labels, -1))


def spans_to_labels(spans):
    """Invert `labels_to_spans`: forward-fill span-start labels over -1s."""
    b, T = spans.shape
    t_idx = torch.arange(T, device=spans.device)[None, :].expand(b, T)
    # index of the most recent span start at or before t
    last_start = cummax(torch.where(spans >= 0, t_idx, torch.zeros_like(t_idx)), dim=1)
    return torch.gather(spans, 1, last_start)


def labels_to_spans_np(labels, max_k):
    """Pure-numpy labels_to_spans for host-side code paths (sufficient
    statistics, evaluation)."""
    labels = np.asarray(labels)
    b, T = labels.shape
    t_idx = np.arange(T)
    change = np.concatenate(
        [np.ones((b, 1), bool), labels[:, 1:] != labels[:, :-1]], axis=1
    )
    if max_k is None:
        start = change
    elif max_k <= 1:
        start = np.ones_like(change)
    else:
        run_start = np.maximum.accumulate(
            np.where(change, t_idx[None, :], -1), axis=1
        )
        pos_in_run = t_idx[None, :] - run_start
        start = change | (pos_in_run % (max_k - 1) == 0)
    return np.where(start, labels, -1)


def rle_spans(spans, lengths):
    """Run-length encode span arrays into [(symbol, count), ...] per row.

    Host-side (returns Python lists); counts continuation (-1) frames as
    part of the preceding span.
    """
    spans = np.asarray(spans)
    lengths = np.asarray(lengths)
    all_rle = []
    for i in range(spans.shape[0]):
        row = spans[i, : int(lengths[i])]
        starts = np.flatnonzero(row != -1)
        assert len(starts) == 0 or starts[0] == 0, "row must begin with a span start"
        bounds = np.append(starts, len(row))
        this_rle = [
            (int(row[s]), int(e - s)) for s, e in zip(bounds[:-1], bounds[1:])
        ]
        assert sum(c for _, c in this_rle) == len(row)
        all_rle.append(this_rle)
    return all_rle
