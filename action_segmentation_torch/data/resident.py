"""Device-resident corpus: a datasplit uploaded to the card once, its
batches gathered there by row index.

Twin of ``action_segmentation_tpu/data/resident.py``. The streaming path
reads, collates and pads every batch on the host, expands its narration
constraints and end masks, and copies it to the card, every epoch and
every per-epoch decode. A corpus does not change during a fit, so
``build_resident_corpus`` reads the split once, lays every video out at
the widest length bucket (features, lengths, ground truth, the scaled
narration penalties and the end masks, each exactly as the streaming
collation builds it) and copies it to the card in one transfer. A batch
is then a host decision, the seeded shuffle and bucketing of
``iter_batches`` (``ResidentCorpus.make_plan``), and a gather on the card
(``gather_resident_rows``).

Size is gated by ``--sm_device_resident_mb`` (``SemiMarkovModel``
caches the corpora and shares the budget among them); over it, a split
streams.

The JAX package's ``build_epoch_scan_fn`` and ``build_decode_scan_fn``
build ``lax.scan`` programs over a plan's batches, and ``resident_views``
unpacks their tuple; they have no port. The port's fit and predict loop
over the plan in Python (``SemiMarkovModel._train_epoch`` and
``_predict_resident``), so a batch keeps its own length bucket and its
task's class width, and each gathered batch is ``torch.equal`` to the
streaming path's tensors for the same batch (JAX pads a scan group to its
widest bucket because a scan needs one shape).
"""

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.data.batching import (
    make_batch_keys,
    pad_class_width,
    pad_length_to_bucket,
)
from action_segmentation_torch.ops.hsmm_cuda import MAX_CLASSES
from action_segmentation_torch.utils import logger


class PlanBatch(NamedTuple):
    """One batch of a plan: its original epoch index, its row in the plan's
    matrices (``EpochPlan.table``), its true size, real frames, length
    bucket, padded class width, true class count and (task, video) keys."""

    bix: int
    row: int
    size: int
    frames: int
    t_width: int
    c_width: int
    n_sub: int
    keys: List[Tuple[str, str]]


@dataclass
class PlanGroup:
    """Batches sharing one padded length bucket, in epoch order."""

    t_width: int                 # the group's length bucket (its widest batch's)
    idxs: np.ndarray             # (n, Bp) int32 corpus rows, -1 = pad row
    vcs: np.ndarray              # (n, Cmax) int32 valid classes, -1 = pad
    invs: np.ndarray             # (n, C) int32 global->subset map
    bixs: np.ndarray             # (n,) int32 original epoch batch index
    keys: List[List[Tuple[str, str]]]  # per batch: (task, video) keys
    batch_sizes: List[int]       # true B per batch
    batch_frames: List[int]      # real frames per batch
    t_widths: List[int]          # each batch's own length bucket
    c_widths: List[int]          # each batch's task's padded class width
    n_subs: List[int]            # each batch's task's class count

    @property
    def n(self):
        return int(self.idxs.shape[0])


@dataclass
class EpochPlan:
    groups: List[PlanGroup]
    videos: int
    frames: int

    @property
    def n(self):
        return sum(g.n for g in self.groups)

    def table(self):
        """(n, Bp + Cmax + C) int64: every batch's rows, valid classes and
        inverse map, the groups in order; the one array a plan sends to
        the card."""
        return np.concatenate(
            [np.concatenate([g.idxs, g.vcs, g.invs], axis=1) for g in self.groups]
        ).astype(np.int64)

    def batches(self):
        """The plan's batches in their original epoch order (the streaming
        order), each with its row in ``table()``."""
        out, row = [], 0
        for g in self.groups:
            for i in range(g.n):
                out.append(PlanBatch(
                    int(g.bixs[i]), row, g.batch_sizes[i], g.batch_frames[i],
                    g.t_widths[i], g.c_widths[i], g.n_subs[i], g.keys[i]))
                row += 1
        return sorted(out, key=lambda b: b.bix)


@dataclass
class ResidentCorpus:
    """Card tensors + host-side batch planning for one datasplit."""

    feat: torch.Tensor             # (N, t_max, D) float32
    length: torch.Tensor           # (N,) int32
    gt: torch.Tensor               # (N, t_max) int32
    cons: Any                      # (N, t_max, c_max) float32 or None
    end: Any                       # (N, c_max) float32 or None
    with_cons: bool
    with_end: bool
    t_max: int
    c_max: int
    n_classes: int
    nbytes: int
    build_s: float
    row_of: Dict[Tuple[str, str], int]
    host_len: np.ndarray           # (N,) int32
    task_vc: Dict[str, np.ndarray]   # task -> (Cmax,) int32 padded vc
    task_inv: Dict[str, np.ndarray]  # task -> (C,) int32 inv map
    task_width: Dict[str, int]       # task -> padded class width
    videos_by_task: Dict[str, Any]
    datasplit: Any = field(repr=False, default=None)  # keeps id() stable

    def _length_of(self, key):
        # missing (unloadable) videos sort as 0, the same convention as
        # iter_batches' exact-length fallback (data/batching.py)
        row = self.row_of.get(key)
        return int(self.host_len[row]) if row is not None else 0

    def make_plan(self, batch_size, shuffle, seed, limit=None,
                  sort_by_length=False, pad_rows_to=1,
                  global_order=False) -> EpochPlan:
        """The same batch composition as iter_batches (make_batch_keys
        chunking + seeded batch-granularity shuffle), as index-matrix
        groups: with `global_order` one group of every batch in epoch
        order, else one group a length bucket, by width. A batch whose
        videos are all missing is skipped without taking a batch index,
        as iter_batches yields nothing for it; `limit` counts the rest.
        `pad_rows_to` rounds the row width Bp up to its multiple (a data
        axis); pad rows carry idx -1."""
        # sort-key parity with iter_batches: the datasplit's
        # annotation-based approx_length where it has one
        length_of = None
        if sort_by_length:
            length_of = getattr(self.datasplit, "approx_length", None)
            if length_of is None:
                length_of = self._length_of
        keys_batches = make_batch_keys(
            self.videos_by_task, batch_size, batch_by_task=True,
            shuffle=shuffle, seed=seed, length_of=length_of,
        )
        entries = []  # (bix, task, rows, fsum, t_width, keys) in epoch order
        videos = 0
        frames = 0
        bix = -1
        for keys in keys_batches:
            present = [k for k in keys if k in self.row_of]
            if not present:
                continue
            rows = [self.row_of[k] for k in present]
            bix += 1
            if limit and bix >= limit:
                break
            lens = self.host_len[rows]
            t_width = pad_length_to_bucket(int(lens.max()))
            task = keys[0][0]
            entries.append((bix, task, rows, int(lens.sum()), t_width, present))
            videos += len(rows)
            frames += int(lens.sum())

        def _make_group(t_width, grp_entries):
            n = len(grp_entries)
            Bp = -(-batch_size // max(pad_rows_to, 1)) * max(pad_rows_to, 1)
            idxs = np.full((n, Bp), -1, np.int32)
            vcs = np.zeros((n, self.c_max), np.int32)
            invs = np.zeros((n, self.n_classes), np.int32)
            bixs = np.zeros(n, np.int32)
            group = PlanGroup(t_width=t_width, idxs=idxs, vcs=vcs, invs=invs, bixs=bixs,
                              keys=[], batch_sizes=[], batch_frames=[], t_widths=[],
                              c_widths=[], n_subs=[])
            for i, (bix, task, rows, fsum, tw, keys_b) in enumerate(grp_entries):
                idxs[i, : len(rows)] = rows
                vcs[i] = self.task_vc[task]
                invs[i] = self.task_inv[task]
                bixs[i] = bix
                group.keys.append(keys_b)
                group.batch_sizes.append(len(rows))
                group.batch_frames.append(fsum)
                group.t_widths.append(tw)
                group.c_widths.append(self.task_width[task])
                group.n_subs.append(int((self.task_vc[task] >= 0).sum()))
            return group

        if global_order:
            groups = (
                [_make_group(max(e[4] for e in entries), entries)]
                if entries else []
            )
        else:
            by_width: "OrderedDict[int, list]" = OrderedDict()
            for e in entries:
                by_width.setdefault(e[4], []).append(e)
            groups = [_make_group(w, by_width[w]) for w in sorted(by_width)]
        return EpochPlan(groups=groups, videos=videos, frames=frames)

    def upload_plan(self, plan):
        """The plan's matrices on the corpus's device (one copy), or None
        for a plan without batches."""
        if not plan.n:
            return None
        return torch.from_numpy(plan.table()).to(self.feat.device)


def gather_resident_rows(res, table, b, with_gt=True, rows=None):
    """Batch `b` of a plan gathered on the card from the resident corpus
    `res`, with `table` the plan's matrices there (``upload_plan``):
    (features, lengths, vc, inv_map, gt, cons, end_allowed, weights), the
    tensors ``SemiMarkovModel._training_batch`` builds for the same batch
    and equal to them: the batch's own length bucket and its task's padded
    class width, rows padded to Bp with the streaming dummies (zero
    features, cons and end row, length 1, weight 0). gt is None when not
    `with_gt` (a decode). `rows` (start, stop) gathers only those rows of
    the plan's Bp, a rank's slice under data parallelism (JAX replicates
    the corpus and each device gathers its rows the same way). Every
    tensor is fresh: none aliases the corpus. Slice widths are host
    integers; nothing waits for the card."""
    Tw, Cw = b.t_width, b.c_width
    c_max = res.c_max
    Bp = table.shape[1] - c_max - res.n_classes
    start, stop = (0, Bp) if rows is None else rows
    row = table[b.row]
    # the plan puts a batch's real rows first
    B = min(max(b.size - start, 0), stop - start)
    real = row[start: start + B]
    pad = stop - start - B

    def padded(x, fill=0):
        if not pad:
            return x
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    features = padded(res.feat[:, :Tw].index_select(0, real))
    lengths = padded(res.length.index_select(0, real), fill=1)
    gt = padded(res.gt[:, :Tw].index_select(0, real).long()) if with_gt else None
    if res.with_cons:
        cons = padded(res.cons[:, :Tw, :Cw].index_select(0, real))
    else:
        cons = res.feat.new_zeros((stop - start, Tw, Cw))
    if res.with_end:
        end = padded(res.end[:, :Cw].index_select(0, real))
    else:
        end = res.feat.new_zeros((stop - start, Cw))
        end[:B, b.n_sub:] = BIG_NEG
    vc = row[Bp: Bp + Cw]
    inv_map = row[Bp + c_max:]
    weights = (row[start:stop] >= 0).float()
    return features, lengths, vc, inv_map, gt, cons, end, weights


def build_resident_corpus(model, datasplit, use_narration, budget_mb, reason_out=None):
    """The resident tensors of `datasplit` on `model.device`, or None when
    they exceed `budget_mb` (the caller streams).

    Each video row holds what the streaming collation builds: features and
    gt zero-padded to the widest length bucket, narration constraints
    expanded to task-local class columns and scaled by
    --sm_constrain_narration_weight (``SemiMarkovModel._batch_device_args``,
    with the penalty row the streaming path gives the frames past a
    video's length), end masks 0/BIG_NEG over the padded class width
    with BIG_NEG beyond the task's class count.

    `reason_out` (a dict, optional) receives why a build returned None:
    'budget' (may succeed once other entries free the budget) or
    'inherent' (an empty split, or narration on some videos and not
    others: no budget helps). Errors, the card's out-of-memory included,
    raise."""

    def _why(why, msg):
        logger.debug("resident corpus: {}; streaming".format(msg))
        if reason_out is not None:
            reason_out["why"] = why

    if budget_mb <= 0:
        # before the corpus read: a build over the budget would read the
        # whole split only to return None
        _why("budget", "no budget left ({:.1f} MB)".format(budget_mb))
        return None

    t0 = time.perf_counter()
    args = model.args
    C = model.n_classes
    bucket = getattr(args, "sm_class_shape_bucket", 1)

    # one pass over the datasplit: rows in (task, video) order; missing
    # samples are skipped as collate() skips them
    rows = []
    per_task_vc = {}
    for task in sorted(datasplit.videos_by_task.keys()):
        for name in sorted(datasplit.videos_by_task[task]):
            sample = datasplit[(task, name)]
            if sample is None:
                continue
            if task not in per_task_vc:
                per_task_vc[task] = np.asarray(sample["task_indices"], np.int32)
            rows.append((task, name, sample))
    if not rows:
        _why("inherent", "an empty split")
        return None

    c_max = max(pad_class_width(len(vc), bucket, MAX_CLASSES) for vc in per_task_vc.values())
    lengths = np.array([s["features"].shape[0] for _, _, s in rows], np.int32)
    t_max = pad_length_to_bucket(int(lengths.max()))
    N = len(rows)
    D = rows[0][2]["features"].shape[1]

    have_cons = [s.get("constraints") is not None for _, _, s in rows]
    with_cons = bool(use_narration and all(have_cons))
    if use_narration and any(have_cons) and not all(have_cons):
        # the streaming path penalizes batch by batch; a resident build
        # would drop every video's penalties
        _why("inherent", "{}/{} videos lack narration constraints".format(
            len(have_cons) - sum(have_cons), len(have_cons)))
        return None
    with_end = model.module.allowed_ends is not None

    nbytes = N * t_max * (D + 1) * 4 + N * 4
    if with_cons:
        nbytes += N * t_max * c_max * 4
    if with_end:
        nbytes += N * c_max * 4
    if nbytes > budget_mb * (1 << 20):
        _why("budget", "{:.1f} MB over the {:.1f} MB left".format(nbytes / 2**20, budget_mb))
        return None

    # every tensor a view of one host buffer, so the corpus crosses to the
    # card in one copy
    host = np.zeros(nbytes, np.uint8)
    f32, i32 = (np.float32, torch.float32), (np.int32, torch.int32)
    layout = [("feat", f32, (N, t_max, D)), ("length", i32, (N,)), ("gt", i32, (N, t_max))]
    if with_cons:
        layout.append(("cons", f32, (N, t_max, c_max)))
    if with_end:
        layout.append(("end", f32, (N, c_max)))
    views, off = {}, 0
    for name, dtypes, shape in layout:
        size = int(np.prod(shape)) * 4
        views[name] = (off, size, dtypes, shape)
        off += size
    assert off == nbytes, (off, nbytes)

    def host_view(name):
        o, size, (dtype, _), shape = views[name]
        return host[o: o + size].view(dtype).reshape(shape)

    feat, gt = host_view("feat"), host_view("gt")
    host_view("length")[:] = lengths
    cons = host_view("cons") if with_cons else None
    end = host_view("end") if with_end else None
    if with_end:
        end[:] = BIG_NEG
    row_of, task_vc, task_inv, task_width, task_pad_row = {}, {}, {}, {}, {}
    for task, vc in per_task_vc.items():
        vcp = np.full(c_max, -1, np.int32)
        vcp[: len(vc)] = vc
        task_vc[task] = vcp
        inv = np.zeros(C, np.int32)
        inv[vc] = np.arange(len(vc), dtype=np.int32)
        task_inv[task] = inv
        task_width[task] = pad_class_width(len(vc), bucket, MAX_CLASSES)

    for i, (task, name, sample) in enumerate(rows):
        L = int(lengths[i])
        row_of[(task, name)] = i
        feat[i, :L] = sample["features"]
        if "gt_single" in sample:
            gt[i, :L] = np.asarray(sample["gt_single"], np.int32)
        vc = per_task_vc[task]
        if with_cons:
            expanded = model._expand_constraints(
                datasplit, task, vc, sample["constraints"][None]
            )[0]
            cons[i, :L, : len(vc)] = expanded * args.sm_constrain_narration_weight
            # collate zero-pads the constraints past a video's length
            # before the expansion, which puts 1 - 0 = 1 at every step
            # column of those frames; the row depends on the task only
            pad_row = task_pad_row.get(task)
            if pad_row is None:
                pad_row = model._expand_constraints(
                    datasplit, task, vc,
                    np.zeros((1, 1, sample["constraints"].shape[1]), np.float32),
                )[0, 0]
                task_pad_row[task] = pad_row
            cons[i, L:, : len(vc)] = pad_row * args.sm_constrain_narration_weight
        if with_end:
            end[i, : len(vc)] = model._end_mask_row(vc, task, L)

    dev = torch.from_numpy(host).to(model.device)  # the one copy

    def dev_view(name):
        o, size, (_, dtype), shape = views[name]
        return dev[o: o + size].view(dtype).view(shape)

    out = ResidentCorpus(
        feat=dev_view("feat"),
        length=dev_view("length"),
        gt=dev_view("gt"),
        cons=dev_view("cons") if with_cons else None,
        end=dev_view("end") if with_end else None,
        with_cons=with_cons,
        with_end=with_end,
        t_max=t_max,
        c_max=c_max,
        n_classes=C,
        nbytes=nbytes,
        build_s=time.perf_counter() - t0,
        row_of=row_of,
        host_len=lengths,
        task_vc=task_vc,
        task_inv=task_inv,
        task_width=task_width,
        videos_by_task=datasplit.videos_by_task,
        datasplit=datasplit,
    )
    logger.debug("resident corpus: {} videos, {:.1f} MB on {} in {:.3f} s".format(
        N, nbytes / 2**20, model.device, out.build_s))
    return out
