"""Banded semi-Markov dynamic programs (log / max semirings), plain torch.

The reference DP of the port: a banded time scan whose per-step working
set is O(K*C), the gold-span score, and frame marginals by autograd.
The kernels in ``ops/hsmm_cuda.py`` and the partition gradient of
``ops/hsmm_grad.py`` are held against it.

Model (durations d in [1, K-1], classes c in [0, C)):

  score(spans) = init[c_1]
               + sum_i  lens[d_i, c_i]
               + sum_i  sum_{t in span_i} emit[t, c_i]
               + sum_{i>1} trans[c_i, c_{i-1}]
               + end_mask[c_M]

``end_mask`` folds the EOS augmentation into a per-class additive mask
on the final span's class: 0 for allowed end classes, BIG_NEG otherwise.

All public entry points take batched tensors:
  trans:    (B, C, C)  log p(to | from), indexed [to, from]
  init:     (B, C)
  lens:     (B, K, C)  duration log-probs, row d scores a d-frame span
                       (row 0 is unused and should be BIG_NEG)
  emit:     (B, T, C)  per-frame log-likelihoods (padded arbitrarily
                       beyond each instance's length)
  lengths:  (B,) int, each >= 1 (entry points clamp to 1 defensively —
                       a 0 would otherwise read the last padded row
                       via negative indexing)
  end_mask: (B, C)
"""

from typing import NamedTuple

import torch

from action_segmentation_torch import BIG_NEG


class HsmmPotentials(NamedTuple):
    """Batched HSMM factor bundle."""

    trans: torch.Tensor  # (B, C, C) [to, from]
    init: torch.Tensor  # (B, C)
    lens: torch.Tensor  # (B, K, C)
    emit: torch.Tensor  # (B, T, C)
    end_mask: torch.Tensor  # (B, C)


def _emission_cumsum(emit):
    """(B, T, C) -> (B, T+1, C) exclusive prefix sums of frame
    log-likelihoods."""
    zero = torch.zeros_like(emit[:, :1])
    return torch.cat([zero, torch.cumsum(emit, dim=1)], dim=1)


def reverse_within_length(x, lengths):
    """Reverse each (B, T, ...) row's first `length` steps (padding beyond
    each length stays put), as one batch-uniform gather."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    lens = lengths.to(x.device).long()[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)  # (B, T)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def _durations(lens):
    """(B, K, C) -> (B, Km, C) duration rows 1..K-1; a single BIG_NEG row
    when K == 1 (no representable duration)."""
    dur = lens[:, 1:, :]
    if dur.shape[1] == 0:  # K == 1 degenerate guard
        dur = torch.full_like(lens[:, :1, :], BIG_NEG)
    return dur


def _forward_scan(trans, init, lens, emit, semiring):
    """Run the banded forward recurrence for a batch.

    Returns ``alphas`` (B, T, C): alphas[:, t-1, c] = semiring-sum over
    all segmentations of frames [0, t) whose final span has class c. For
    the max semiring additionally returns backpointers (bp_d, bp_c),
    each (B, T, C) int64, otherwise None.

    The carry holds the last K-1 boundary scores with the emission prefix
    sum pre-subtracted, so each step is a (K-1, C) elementwise add plus a
    (C, C) reduction.
    """
    B, T, C = emit.shape
    cum = _emission_cumsum(emit)  # (B, T+1, C)
    dur = _durations(lens)  # (B, Km, C), row j scores duration j+1
    Km = dur.shape[1]
    is_max = semiring == "max"

    w = torch.full((B, Km, C), BIG_NEG, dtype=emit.dtype, device=emit.device)
    w[:, 0] = init  # g~[0] = init - cum[0] = init
    alphas, bp_ds, bp_cs = [], [], []
    for t in range(1, T + 1):
        # span ending at boundary t, duration j+1, class c:
        # w[:, j, c] already holds gamma[t-1-j, c] - cum[t-1-j, c]
        span_scores = w + dur
        if is_max:
            best, bp_d = span_scores.max(dim=1)
            alpha = best + cum[:, t]
        else:
            alpha = torch.logsumexp(span_scores, dim=1) + cum[:, t]
        # next-boundary scores: gamma[t, c_to] = sr-sum_c' alpha[c'] + trans
        arrivals = trans + alpha[:, None, :]  # (B, C_to, C_from)
        if is_max:
            gamma, bp_c = arrivals.max(dim=2)
            bp_ds.append(bp_d)
            bp_cs.append(bp_c)
        else:
            gamma = torch.logsumexp(arrivals, dim=2)
        w = torch.cat([(gamma - cum[:, t])[:, None], w[:, :-1]], dim=1)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)
    if is_max:
        return alphas, (torch.stack(bp_ds, dim=1), torch.stack(bp_cs, dim=1))
    return alphas, None


def _clamped(lengths, device):
    """Lengths as int64 on `device`, clamped to >= 1."""
    return torch.as_tensor(lengths, device=device).long().clamp(min=1)


def _finals(alphas, lengths, end_mask):
    """(B, C) final boundary scores at t = length, plus the end mask."""
    idx = (lengths - 1)[:, None, None].expand(-1, 1, alphas.shape[2])
    return torch.gather(alphas, 1, idx)[:, 0] + end_mask


def hsmm_partition(pots: HsmmPotentials, lengths):
    """Log partition function per batch element: (B,) float."""
    lengths = _clamped(lengths, pots.emit.device)
    alphas, _ = _forward_scan(pots.trans, pots.init, pots.lens, pots.emit, "log")
    return torch.logsumexp(_finals(alphas, lengths, pots.end_mask), dim=-1)


def hsmm_frame_marginals(pots: HsmmPotentials, lengths):
    """Posterior per-frame class marginals by autograd of the partition:
    d logZ / d emit[t, c] = E[frame t has class c]; (B, T, C)."""
    pots = HsmmPotentials(*(x.detach() for x in pots))
    emit = pots.emit.requires_grad_(True)
    with torch.enable_grad():
        total = hsmm_partition(pots._replace(emit=emit), lengths).sum()
        return torch.autograd.grad(total, emit)[0]


def hsmm_gold_score(pots: HsmmPotentials, lengths, spans):
    """Joint score of gold span sequences (the DP's factors): (B,) float.

    spans (B, T) int: the class at each span start, -1 on continuations.
    A gold span longer than the band (K - 1 frames) scores BIG_NEG, not
    a clipped finite value: the DP gives it zero probability. Includes
    the end-mask term of the last span's class.
    """
    B, T, C = pots.emit.shape
    K = pots.lens.shape[1]
    device = pots.emit.device
    lengths = _clamped(lengths, device)
    spans = spans.to(device).long()
    b_idx = torch.arange(B, device=device)[:, None]
    t_idx = torch.arange(T, device=device)[None, :]
    cum = _emission_cumsum(pots.emit)  # (B, T+1, C)

    start = (spans >= 0) & (t_idx < lengths[:, None])
    # class of the span covering each frame (forward fill of the starts)
    filled_idx = torch.cummax(torch.where(start, t_idx, 0), dim=1).values
    filled = torch.gather(spans, 1, filled_idx)

    # next span start strictly after t, or the length if none
    start_pos = torch.where(start, t_idx, T + 1)
    suffix_min = torch.cummin(start_pos.flip(1), dim=1).values.flip(1)
    next_start = torch.minimum(
        torch.cat([suffix_min[:, 1:], torch.full_like(suffix_min[:, :1], T + 1)], dim=1),
        lengths[:, None],
    )
    dur_raw = next_start - t_idx
    dur = dur_raw.clamp(0, K - 1)
    over_band = start & (dur_raw > K - 1)

    cls = spans.clamp(0, C - 1)
    span_emit = (
        cum[b_idx, next_start.clamp(max=T), cls] - cum[b_idx, t_idx.clamp(max=T), cls]
    )
    len_term = pots.lens[b_idx, dur, cls]
    prev_cls = torch.where(t_idx > 0, filled[:, (t_idx[0] - 1).clamp(min=0)], 0)
    trans_term = pots.trans[b_idx, cls, prev_cls]
    first = torch.where(t_idx > 0, trans_term, pots.init[b_idx, cls])
    per_start = span_emit + len_term + first
    per_start = torch.where(over_band, torch.full_like(per_start, BIG_NEG), per_start)
    total = torch.where(start, per_start, torch.zeros_like(per_start)).sum(dim=1)
    last_cls = filled[torch.arange(B, device=device), lengths - 1]
    return total + pots.end_mask[torch.arange(B, device=device), last_cls]


def hsmm_log_prob(pots: HsmmPotentials, lengths, spans):
    """log p(spans | features) = gold score - partition (discriminative)."""
    return hsmm_gold_score(pots, lengths, spans) - hsmm_partition(pots, lengths)


def hsmm_viterbi(pots: HsmmPotentials, lengths):
    """Batched Viterbi decode: (spans (B, T) int64, scores (B,)).

    spans holds the class at each span start and -1 on continuations;
    frames at/after each length are -1. The traceback walks the
    backpointers on the host (one copy of the (B, T, C) planes).
    """
    B, T, C = pots.emit.shape
    device = pots.emit.device
    lengths = _clamped(lengths, device)
    alphas, (bp_d, bp_c) = _forward_scan(
        pots.trans, pots.init, pots.lens, pots.emit, "max"
    )
    scores, c_last = _finals(alphas, lengths, pots.end_mask).max(dim=-1)
    bp_d, bp_c = bp_d.cpu().numpy(), bp_c.cpu().numpy()
    lengths_np = lengths.cpu().numpy()
    c_last = c_last.cpu().numpy()
    spans = torch.full((B, T), -1, dtype=torch.long)
    for b in range(B):
        t, c = int(lengths_np[b]), int(c_last[b])
        while t > 0:
            d = int(bp_d[b, t - 1, c]) + 1  # duration of span ending at t
            s = t - d
            spans[b, s] = c
            if s > 0:
                c = int(bp_c[b, s - 1, c])
            t = s
    return spans.to(device), scores
