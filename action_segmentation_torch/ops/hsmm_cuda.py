"""The banded semi-Markov DP's hand-written CUDA kernels and their chains.

Twin of ``action_segmentation_tpu/ops/hsmm_pallas.py``. Seven kernels,
from four sources, for a DP of at most 128 classes, and one of any width:

  * ``hsmm_gamma_scan`` (csrc/hsmm_scan.cu, max semiring) — the forward
    scan over the forward model and the time-reversed model stacked on
    the batch axis, emitting each step's transition combine (the gamma
    plane); decode;
  * ``hsmm_log_scan`` (csrc/hsmm_scan.cu, log semiring) — the same scan
    with the alphas plane; the training forward;
  * ``hsmm_forward_scan`` (csrc/hsmm_scan.cu, log semiring, no gamma
    store) — the alphas-only scan behind the partition's primal;
  * ``hsmm_band_max`` (csrc/band_max.cu) — the duration-band combine
    that turns the two directions' gamma planes into per-frame
    max-marginals; decode;
  * ``hsmm_band_grad`` (csrc/band_grad.cu) — the log-semiring band sweep
    that turns them into the span posteriors' start, stop and duration
    masses; the training backward (ops/hsmm_grad.py);
  * ``hsmm_viterbi_scan`` (csrc/hsmm_viterbi.cu) — the max scan that
    writes packed backpointer codes, and ``hsmm_viterbi_traceback``
    (the same source), which walks them into spans on the card; the
    exact-spans decode;
  * ``hsmm_pair_grad`` (csrc/pair_grad.cu, any C) — the transition
    cotangent, the pair posteriors of the interior boundaries summed over
    frames with no (B, T, C, C) exponent held; the training backward. It
    replaces no Pallas kernel: XLA fuses the same broadcast into its sum.

The three scans (both gamma scans and the backpointer scan) are
instances of one template, csrc/hsmm_scan_core.cuh, compiled for buckets
of C and Km; ``scan_instance`` picks the instance a shape launches. The
two log scans, narrow and wide, fold their carry every SCAN_FOLD steps
(``_scan_plain``): their planes are relative to each chain's running
offset, which they return beside them (``offsets``), so that no float32
value of the scan grows with the video's length.

A DP wider than 128 classes, of any width, takes the wide kernels, which
the same wrappers launch by C: the three instances of
csrc/hsmm_scan_wide.cu (``hsmm_viterbi_scan_wide``, ``hsmm_log_scan_wide``,
``hsmm_forward_scan_wide``, on one of two routes that ``wide_scan_instance``
picks by shape: up to WIDE_CLUSTER_MAX_CLASSES a cluster of 1-8 blocks a
chain holding its transition table in shared memory, one thread a class;
past it one cooperative grid over every SM, each block a slab of classes
of a group of chains, its slab of the table in shared memory where the
card's shared memory holds the batch's tables, one grid barrier a step),
the wide traceback
(``hsmm_viterbi_traceback_wide``, W2, codes at ``code_radix(C)``, passed
to the launch: two warps a video, one walking the raw codes with two
shared-memory loads a segment, the other streaming the plane from the top
down through a ring of tiles that ``wide_traceback_tile`` sizes, one bulk
copy a tile) and the wide band gradient (``hsmm_band_grad_wide``, its
own kernel in csrc/band_grad.cu: blocks of 32 classes walking runs of
time rows, enough runs a video to keep every resident block slot busy,
``band_grad_wide_tile``). Each wide kernel counts its own launches. What
bounds the width: the codes' int32 (``_scan_radix``, on both devices) and, on the card, a block's shared memory, which holds one
chain's alpha row on the grid route up to WIDE_GRID_MAX_CLASSES (57,220
on 132 SMs) and W2's 4 slots a row of up to 14,521 codes; past those the
wrappers raise. The
max gamma scan and the band max stay at <= 128 classes: the labels chain
never sees a wide DP (``kernel_path``).

Each wrapper takes its kernel's plain PyTorch version (``_gamma_scan_plain``
and its log forms, ``_band_max_plain``, ``_band_grad_plain``,
``_viterbi_scan_plain``, ``_traceback_plain``, ``_pair_grad_plain``) only
for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. ``launches`` on
each wrapper counts the kernel launches, so a run can show that its path
went through them.

Decode has two chains, chosen as the JAX package's ``_decode_core``
chooses, by the model's class count (``kernel_path``):

  * the labels chain (``hsmm_viterbi_labels``, <= 128 classes). In the
    max semiring the "marginal" of a span is the score of the best path
    through it; the best path's spans attain the global best, so
    labels[t] = argmax_c (best span score covering t with class c). No
    traceback, so decode cost does not grow with the segment count;
  * the spans chain (``hsmm_viterbi_spans``, above 128 classes, where
    each task's DP stays narrow): the backpointer scan, the finals, and
    the traceback.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from action_segmentation_torch import BIG_NEG
from action_segmentation_torch.ops._build import load_library
from action_segmentation_torch.ops.hsmm import (
    HsmmPotentials,
    _clamped,
    _durations,
    _emission_cumsum,
    _finals,
    reverse_within_length,
)

# The kernels put one class per thread of a block (in the scans at most
# four warps a chain), so they take C <= 128 classes; a wider DP takes the
# wide kernels (csrc/hsmm_scan_wide.cu, the traceback's wide instance and
# the band gradient's wide kernel).
MAX_CLASSES = 128

# The scans' instances: csrc/hsmm_scan_core.cuh's template is compiled for
# warps per chain by C, one warp's trans row in ROW_BUCKETS registers, and
# the carry's newest SCAN_CARRY rows in registers with (Km > SCAN_CARRY)
# or without a shared-memory tail for the older rows. ``scan_instance``
# picks one and the launch passes it on. SCAN_WINDOW is the emission
# window's slot count.
SCAN_WINDOW = 16
# the log scans' fold period at every width (csrc/hsmm_scan_core.cuh's and
# csrc/hsmm_scan_wide.cu's kFold): every SCAN_FOLD steps the carry takes in
# the emission prefix sum and gives up the step's best alpha, which the
# chain's offsets keep. At 64 the model's marginals meet
# tests/test_torch_long_video.py's float64 bounds up to 12,000 frames and
# tests/test_torch_wide_long_video.py's past 128 classes; PERF.md §6
# compares 32 and 128
SCAN_FOLD = 64
# and within a block each class on its own (kFoldLimit): where its prefix
# sum leaves [-SCAN_FOLD_LIMIT, SCAN_FOLD_LIMIT], its carry rows take it in
# after the step's alpha and before the push, so that emissions of 1e4
# nats a frame (the compound model's) reach no carry row through a long
# prefix sum (tools/fold_sweep.py; PERF.md §6)
SCAN_FOLD_LIMIT = 4096.0
# the band gradient's chunk at every width (K4 and its wide kernel): the
# training backward's band inputs are anchored per chunk of BAND_CHUNK rows
# from a video's first frame, so that the float32 values K4 reads span one
# chunk's path score, not the video's, and a video's anchors do not depend
# on its batch or on the kernel that takes it. 16 rows hold the compound
# model's first steps within 2.1e-4 of float64 (1,024: 0.058;
# tools/fold_sweep.py)
BAND_CHUNK = 16
SCAN_CARRY = 24
ROW_BUCKETS = (24, 32)
# an H100 block's limits: threads, and dynamic shared memory once opted in;
# the card's SMs
MAX_BLOCK_THREADS = 1024
MAX_BLOCK_SMEM = 232448
H100_SMS = 132


class ScanInstance(NamedTuple):
    """The scan kernel instance a (C, Km) launches."""

    warps: int  # per chain (one block)
    row: int  # one warp: its trans row's register bucket; else 0
    # Km > SCAN_CARRY: the carry's older rows in a shared-memory tail, their
    # duration scores staged in shared memory (1) or, where that would not
    # fit a block, read from global memory (2); else 0
    tail: int
    threads: int
    smem_bytes: int


def scan_instance(C, Km):
    """The instance of the scan template (K1, K2 max and log, K6) that C
    classes and Km duration rows launch, and its dynamic shared memory
    (the kernel's layout): one warp at C <= 32, its trans row in 24 or 32
    registers and alpha exchanged through two shared rows of 32; two warps
    at <= 64 and four at <= 128, with trans and alpha in shared memory.
    Every instance holds the carry's newest 24 rows in registers and
    stages the emissions in a shared window; the rows past 24 take a
    shared-memory ring, beside their duration scores where both fit."""
    warps = 1 if C <= 32 else 2 if C <= 64 else 4
    row = next(b for b in ROW_BUCKETS if C <= b) if warps == 1 else 0
    floats = 2 * 32 if row else C * C + 2 * C  # alpha rows; or trans and alpha
    floats += SCAN_WINDOW * 32 * warps
    tail = 0
    if Km > SCAN_CARRY:
        floats += (Km - SCAN_CARRY) * C  # the ring
        tail = 1 if 4 * (floats + (Km - SCAN_CARRY) * C) <= MAX_BLOCK_SMEM else 2
        floats += (Km - SCAN_CARRY) * C if tail == 1 else 0  # the staged durations
    return ScanInstance(warps, row, tail, 32 * warps, 4 * floats)


def kernels_supported(n_classes):
    """True when the kernels take this class count (C <= 128)."""
    return n_classes <= MAX_CLASSES


class KernelPath(NamedTuple):
    """The chains a model-level call takes."""

    decode: str  # "labels" (K2-max + K3) or "spans" (K6 + traceback)
    partition: str  # "kernels" (HsmmPartitionFB) or "autograd" (of hsmm_partition)


def kernel_path(n_classes, width, device):
    """The chains a model-level call on `device` takes, for a model of
    `n_classes` classes whose DP is `width` classes wide (the padded
    valid-class count, ``pots.emit.shape[-1]``).

    Decode chooses by the model's class count on both devices, as JAX's
    ``_decode_core``: the labels chain at <= 128 classes, the spans chain
    above. A DP is never wider than its model, so the labels chain (K2-max,
    K3) never sees one wider than 128; the spans chain and the partition
    launch the narrow kernels or, above 128 classes, the wide ones. The
    partition runs its kernel forward/backward on the card at any width
    (no plain version runs there); on the CPU it keeps the JAX package's
    lane gate (the kernels' plain versions at <= 128 classes, autograd of
    ``hsmm_partition`` above). `width` chooses nothing: the wrappers
    launch by the tensors' C."""
    narrow_model = kernels_supported(n_classes)
    return KernelPath(
        "labels" if narrow_model else "spans",
        "kernels" if narrow_model or device.type == "cuda" else "autograd",
    )


def _stream_args(t):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, tensors, shapes, dtypes=None):
    """Device, dtype (float32 unless `dtypes` says), shape and contiguity
    checks before a launch."""
    device = tensors[0].device
    for t, shape, dtype in zip(tensors, shapes, dtypes or (torch.float32,) * len(tensors)):
        if t.device != device:
            raise ValueError("{}: tensors on {} and {}".format(name, device, t.device))
        if t.dtype != dtype:
            raise TypeError("{}: the kernel takes {}, got {}".format(name, dtype, t.dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("{}: shape {} != {}".format(name, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("{}: the kernel takes contiguous tensors".format(name))


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError("{}: CUDA launch failed with error {}".format(name, err))


def _device_type(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("no kernel for tensors on {}".format(t.device))
    return t.device.type


@functools.cache
def _bound(lib_name, symbol, argtypes):
    """csrc/<lib_name>.cu's C function `symbol`, its signature bound once."""
    fn = getattr(load_library(lib_name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _call(lib_name, symbol, pointers, ints, stream_of):
    """One call of csrc/<lib_name>.cu's C function `symbol`: pointer
    arguments (tensors, or None for a null pointer), int arguments, then
    the device and stream of `stream_of`. Returns the CUDA error code."""
    argtypes = (
        (ctypes.c_void_p,) * len(pointers) + (ctypes.c_int,) * (len(ints) + 1)
        + (ctypes.c_void_p,)
    )
    return _bound(lib_name, symbol, argtypes)(
        *[None if p is None else p.data_ptr() for p in pointers], *ints,
        *_stream_args(stream_of),
    )


# ---- (a) the scan: max and log semirings -----------------------------------


def _reduce(x, dim, semiring):
    """JAX's ``_semiring_reduce`` over `dim`: the max, or in the log
    semiring m + log(sum(exp(x - m))) with the sum taken in index order,
    as the kernel takes it."""
    m = x.amax(dim=dim)
    if semiring == "max":
        return m
    e = torch.exp(x - m.unsqueeze(dim))
    s = e.select(dim, 0)
    for j in range(1, x.shape[dim]):
        s = s + e.select(dim, j)
    return m + torch.log(s)


def fold_blocks(T):
    """The columns of a T-step log scan's offsets: ceil(T / SCAN_FOLD)."""
    return -(-T // SCAN_FOLD)


def _scan_plain(trans, init, dur, emit, semiring, fold=False):
    """Plain PyTorch version of the scan (any device, any float dtype).

    trans (N, C, C) [to, from]; init (N, C); dur (N, Km, C), row j scoring
    duration j+1; emit (N, T, C). Returns (gamma (N, T, C), alphas (N, T,
    C), offsets (N, ``fold_blocks(T)``)): alphas[:, t] is the semiring
    mass (max: the best score) of frames [0, t] whose last span ends at t,
    gamma[:, t, c] = reduce_c' trans[c, c'] + alpha[:, t, c']. The same
    operations in the same order as the kernel.

    With `fold` (the log scans, at every width), after each step t with
    t % SCAN_FOLD == SCAN_FOLD - 1 and t + 1 < T the carry takes in the
    emission prefix sum and gives up s, the step's max alpha (0 where no
    class has one above BIG_NEG / 2): W = (W + cum) - s, cum = 0, and
    offsets[:, (t + 1) // SCAN_FOLD] = s. Row t of the planes is then
    relative to the chain's offset, the sum of offsets[:, :t // SCAN_FOLD
    + 1] (``chain_offsets``); without `fold` the offsets are 0. Within a
    block, after step t's alpha and before its push, each class whose |cum|
    exceeds SCAN_FOLD_LIMIT takes it into its own carry rows: W += cum,
    cum = 0.
    """
    N, T, C = emit.shape
    Km = dur.shape[1]
    trans = _dense_trans(trans)
    W = torch.full((N, Km, C), BIG_NEG, dtype=emit.dtype, device=emit.device)
    W[:, 0] = init
    cum = torch.zeros((N, C), dtype=emit.dtype, device=emit.device)
    offsets = emit.new_zeros((N, fold_blocks(T)))
    gammas, alphas = [], []
    for t in range(T):
        cum = cum + emit[:, t]
        alpha = _reduce(W + dur, 1, semiring) + cum
        gamma = _reduce(trans + alpha[:, None, :], 2, semiring)
        if fold:
            big = cum.abs() > SCAN_FOLD_LIMIT
            W = torch.where(big[:, None, :], W + cum[:, None, :], W)
            cum = torch.where(big, torch.zeros_like(cum), cum)
        W = torch.cat([(gamma - cum)[:, None], W[:, :-1]], dim=1)
        gammas.append(gamma)
        alphas.append(alpha)
        if fold and t % SCAN_FOLD == SCAN_FOLD - 1 and t + 1 < T:
            s = alpha.amax(dim=1)
            s = torch.where(s > BIG_NEG / 2, s, torch.zeros_like(s))
            W = (W + cum[:, None]) - s[:, None, None]
            cum = torch.zeros_like(cum)
            offsets[:, (t + 1) // SCAN_FOLD] = s
    if not T:
        return emit.new_empty((N, 0, C)), emit.new_empty((N, 0, C)), offsets
    return torch.stack(gammas, dim=1), torch.stack(alphas, dim=1), offsets


def _gamma_scan_plain(trans, init, dur, emit, with_alphas=False):
    """The max gamma scan's plain version (``_scan_plain`` in the max
    semiring): (gamma, alphas or None)."""
    gamma, alphas, _ = _scan_plain(trans, init, dur, emit, "max")
    return gamma, alphas if with_alphas else None


def _log_scan_plain(trans, init, dur, emit):
    """Plain version of ``hsmm_log_scan`` and ``hsmm_log_scan_wide``:
    (gamma, alphas, offsets), folded."""
    return _scan_plain(trans, init, dur, emit, "log", fold=True)


def _forward_scan_plain(trans, init, dur, emit):
    """Plain version of ``hsmm_forward_scan`` and
    ``hsmm_forward_scan_wide``: (alphas, offsets)."""
    return _log_scan_plain(trans, init, dur, emit)[1:]


def chain_offsets(offsets, t):
    """Each chain's offset at step t, in float64: the sum of a log scan's
    `offsets` (N, blocks) over the blocks up to t's. t: (N,) or (N, M)
    int64 steps in [0, T); returns the same shape."""
    total = torch.cumsum(offsets, dim=1, dtype=torch.float64)
    return torch.gather(total, 1, (t // SCAN_FOLD).reshape(t.shape[0], -1)).reshape(t.shape)


def _launch_scan(name, symbol, trans, init, dur, emit, outputs, lib="hsmm_scan"):
    """Checks, then one launch of csrc/<lib>.cu's `symbol` (one block per
    chain, the instance ``scan_instance(C, Km)`` picks) writing `outputs`
    (tensors, or None where not stored)."""
    N, T, C = emit.shape
    Km = dur.shape[1]
    if not kernels_supported(C):
        raise ValueError("{}: C={} > {}".format(name, C, MAX_CLASSES))
    if Km < 1:  # the carry needs a row (see _durations)
        raise ValueError("{}: dur needs at least one row".format(name))
    inst = scan_instance(C, Km)
    if inst.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError("{}: Km={} at C={} overflows the shared-memory carry".format(
            name, Km, C))
    _check_cuda(
        name, (emit, trans, init, dur), ((N, T, C), (N, C, C), (N, C), (N, Km, C))
    )
    err = _call(lib, symbol, [trans, init, dur, emit, *outputs],
                [N, T, C, Km, inst.warps, inst.row, inst.tail, inst.smem_bytes], emit)
    _raise_on_error(name, err)


def hsmm_gamma_scan(trans, init, dur, emit, with_alphas=False):
    """Max-semiring gamma scan (decode): (gamma (N, T, C), alphas or None).

    See ``_gamma_scan_plain`` for the function. On CUDA tensors (float32,
    contiguous, C <= 128) it launches csrc/hsmm_scan.cu, one block per
    chain; on CPU tensors it runs the plain version."""
    if _device_type(emit) == "cpu":
        return _gamma_scan_plain(trans, init, dur, emit, with_alphas)
    gamma = torch.empty_like(emit)
    alphas = torch.empty_like(emit) if with_alphas else None
    _launch_scan("hsmm_gamma_scan", "hsmm_gamma_scan_max", trans, init, dur, emit,
                 [gamma, alphas])
    hsmm_gamma_scan.launches += 1
    return gamma, alphas


hsmm_gamma_scan.launches = 0


def hsmm_log_scan(trans, init, dur, emit):
    """Log-semiring scan with the alphas plane (the training forward):
    (gamma (N, T, C), alphas (N, T, C), offsets (N, ``fold_blocks(T)``)),
    the planes relative to each chain's offsets (``_scan_plain``).

    Same inputs and checks as ``hsmm_gamma_scan``; above 128 classes it
    launches the wide kernel (``hsmm_log_scan_wide``, which folds the
    same way); on CPU tensors it runs ``_log_scan_plain``."""
    if _device_type(emit) == "cpu":
        return _log_scan_plain(trans, init, dur, emit)
    if emit.shape[-1] > MAX_CLASSES:
        return hsmm_log_scan_wide(trans, init, dur, emit)
    N, T, _ = emit.shape
    gamma, alphas = torch.empty_like(emit), torch.empty_like(emit)
    offsets = emit.new_empty((N, fold_blocks(T)))
    _launch_scan("hsmm_log_scan", "hsmm_gamma_scan_log", trans, init, dur, emit,
                 [gamma, alphas, offsets])
    hsmm_log_scan.launches += 1
    return gamma, alphas, offsets


hsmm_log_scan.launches = 0


def hsmm_forward_scan(trans, init, dur, emit):
    """Forward-only log scan (the partition's primal): (alphas (N, T, C),
    offsets (N, ``fold_blocks(T)``)).

    The kernel of ``hsmm_log_scan`` with the gamma store skipped; above
    128 classes the wide kernel (``hsmm_forward_scan_wide``, which gives
    the chains of an expanded trans one table). trans may be an expanded
    view. On CPU tensors it runs ``_forward_scan_plain``."""
    if _device_type(emit) == "cpu":
        return _forward_scan_plain(trans, init, dur, emit)
    if emit.shape[-1] > MAX_CLASSES:
        return hsmm_forward_scan_wide(trans, init, dur, emit)
    N, T, _ = emit.shape
    alphas, offsets = torch.empty_like(emit), emit.new_empty((N, fold_blocks(T)))
    _launch_scan("hsmm_forward_scan", "hsmm_forward_scan_log", trans.contiguous(), init, dur,
                 emit, [alphas, offsets])
    hsmm_forward_scan.launches += 1
    return alphas, offsets


hsmm_forward_scan.launches = 0


# ---- (a') the wide scans: C > 128 ---------------------------------------


class WideScan(NamedTuple):
    """A wide scan's launch (csrc/hsmm_scan_wide.cu). `route` "cluster":
    `cluster` blocks a chain (N * cluster `blocks`), each holding the
    transition table's rows of its `slab` classes in shared memory for the
    whole scan, the ring beside them. "grid" (past the cluster route): one
    cooperative grid of `blocks` blocks over the card's SMs, each the pairs
    of `chains` chains and `slab` classes, its slab's table rows in shared
    memory (`table` "shared") or read from global memory ("global"), the
    pairs' ring in shared memory or in a global scratch (`ring`), a batch
    of more chains than one grid holds split into launches of
    `launch_chains`. `threads` a block (a thread a class of the slab, or a
    pair, in whole warps; on the grid route at most GRID_THREADS, each
    thread then its pairs in turn) and `smem_bytes` a block's dynamic
    shared memory."""

    route: str
    cluster: int
    slab: int
    chains: int
    blocks: int
    threads: int
    table: str
    ring: str
    smem_bytes: int
    launch_chains: int


# the cluster route's largest cluster (the portable size) and block
# (csrc/hsmm_scan_wide.cu's __launch_bounds__)
WIDE_MAX_CLUSTER = 8
WIDE_SLAB_THREADS = 256
# the widest C the cluster route takes, at any Km: a portable cluster of 8
# blocks of 83 classes at Km = 1 (the least ring), 230,092 bytes a block;
# at 665 a slab of 84 takes 232,832 (``wide_scan_instance``)
WIDE_CLUSTER_MAX_CLASSES = 664
# the grid route's largest block (csrc/hsmm_scan_wide.cu's __launch_bounds__)
GRID_THREADS = 512


def _alpha_stride(C):
    """The alpha row's stride in floats: C rounded up to 16 bytes."""
    return -(-C // 4) * 4


def _table_stride(C):
    """A class's row of the table in shared memory, in floats: the alpha
    stride rounded up to 4 past a multiple of 32 (its 16-byte loads free
    of bank conflicts); on the grid route also the stride of the alpha
    rows, of the exchange rows and of the table's rows in global memory."""
    return _alpha_stride(C) + (36 - _alpha_stride(C) % 32) % 32


def wide_cluster_smem(C, Km, slab):
    """A cluster-route block's shared memory in bytes (the kernel's
    layout): the two alpha rows' mbarriers (16 bytes), two alpha rows of
    every class, the table's row of each of the slab's classes and the
    ring's Km rows of the slab."""
    return 4 * (4 + 2 * _alpha_stride(C) + min(slab, C) * _table_stride(C) + Km * slab)


def wide_grid_smem(C, Km, slab, chains, table, ring):
    """A grid-route block's shared memory in bytes (the kernel's layout):
    its slab's table rows (`table` "shared"), its chains' alpha rows, each
    pair's prefix sum and duration argmax, and (`ring` "shared") the
    pairs' Km ring rows."""
    pairs = chains * slab
    return 4 * ((slab * _table_stride(C) if table == "shared" else 0)
                + chains * _table_stride(C) + 2 * pairs
                + (Km * pairs if ring == "shared" else 0))


def _grid_tiling(C, Km, n, group, N, sms, chains):
    """The cheapest grid tiling of n chains (of the batch's N, `group` a
    table), or None: for each chains-a-block g (or `chains`), ceil(n / g)
    chain groups times the most slabs that leave at most one block an SM;
    the table slab in shared memory where every block's chains read one
    table and it fits, else in global memory; the ring in shared memory
    where it fits beside. Its cost: a block's terms a step (pairs x C)
    plus the floats it reads from L2 a step x 4 (its chains' alpha rows,
    a global table slab's rows, a global ring's rows read and written),
    both at about 64 a clock an SM."""
    rs = _table_stride(C)
    best = None
    for g in ([chains] if chains else range(1, n + 1)):
        groups = -(-n // g)
        if groups > sms:
            continue
        slab = -(-C // (sms // groups))
        pairs = g * slab
        one_table = n == N and (group >= N or group % g == 0)
        for table in ("shared", "global") if one_table else ("global",):
            smem = wide_grid_smem(C, Km, slab, g, table, "global")
            if smem > MAX_BLOCK_SMEM:
                continue
            ring = "shared" if wide_grid_smem(C, Km, slab, g, table, "shared") \
                <= MAX_BLOCK_SMEM else "global"
            reads = g * rs + (slab * rs if table == "global" else 0) + (
                2 * Km * pairs if ring == "global" else 0)
            cost = pairs * C + 4 * reads
            if best is None or cost < best[0]:
                blocks = groups * -(-C // slab)
                best = (cost, WideScan(
                    "grid", 0, slab, g, blocks, min(GRID_THREADS, 32 * -(-pairs // 32)), table,
                    ring, wide_grid_smem(C, Km, slab, g, table, ring), n))
            break  # the table in shared memory where it fits
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def wide_grid_instance(C, Km, N=1, group=1, sms=H100_SMS, chains=None):
    """The grid route's launch for N chains (chain n reading table n //
    `group`) of C classes and Km duration rows on a card of `sms` SMs
    (``_grid_tiling``; `chains` fixes the chains a block), all N in one
    launch where a tiling holds them, else the most chains a launch that
    one holds (the table then read from global memory). Raises where not
    even one chain fits a block: one alpha row and a slab's state past a
    block's shared memory (WIDE_GRID_MAX_CLASSES at 132 SMs)."""
    n = N
    while n >= 1:
        inst = _grid_tiling(C, Km, n, group, N, sms, chains)
        if inst is not None:
            return inst
        n = n // 2 if chains is None else 0
    raise ValueError("C={} at Km={} over {} chains: no grid-route block holds one chain's "
                     "alpha row and its slab's state in {} bytes of shared memory".format(
                         C, Km, N, MAX_BLOCK_SMEM))


# the widest C the grid route takes on 132 SMs: one chain's alpha row and
# the state of its slab of ceil(C / 132) classes in a block
WIDE_GRID_MAX_CLASSES = 57220


def wide_scan_instance(C, Km, N=1, group=1, sms=H100_SMS):
    """The launch of csrc/hsmm_scan_wide.cu for N chains (`group` a table)
    of C classes and Km duration rows: the cluster route with the smallest
    cluster (1 to 8 blocks) whose blocks each hold their slab's table, its
    ring and the alpha rows within a block's shared memory, the slab in
    whole warps where that fits, else C split evenly; past that (above
    WIDE_CLUSTER_MAX_CLASSES, or a ring too deep) the grid route
    (``wide_grid_instance``)."""
    for cluster in range(1, WIDE_MAX_CLUSTER + 1):
        even = -(-C // cluster)
        for slab in (32 * -(-even // 32), even):
            smem = wide_cluster_smem(C, Km, slab)
            if smem <= MAX_BLOCK_SMEM and slab <= WIDE_SLAB_THREADS:
                cluster = -(-C // slab)
                return WideScan("cluster", cluster, slab, 1, N * cluster, 32 * -(-slab // 32),
                                "shared", "shared", smem, N)
    return wide_grid_instance(C, Km, N, group, sms)


# the wide scans' instances in csrc/hsmm_scan_wide.cu's order
WIDE_SCAN_INDEX = {"viterbi": 0, "log": 1, "forward": 2}


def wide_max_active_clusters(scan, C, Km, device=0):
    """cudaOccupancyMaxActiveClusters of the wide `scan` instance
    ("viterbi", "log" or "forward") on the cluster route at (C, Km): the
    chains the card runs at once. Raises on the grid route or a CUDA error."""
    inst = wide_scan_instance(C, Km)
    if inst.route != "cluster":
        raise ValueError("C={} Km={} takes the grid route".format(C, Km))
    fn = _bound("hsmm_scan_wide", "hsmm_wide_max_active_clusters",
                (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    out = ctypes.c_int(0)
    err = fn(WIDE_SCAN_INDEX[scan], inst.cluster, inst.slab, inst.smem_bytes, device,
             ctypes.byref(out))
    _raise_on_error("wide_max_active_clusters", err)
    return out.value


def _wide_tables(name, trans, N, C):
    """(tables (G, C, C) [to][from], chains a table) of a wide scan's
    trans: (N, C, C), one table a chain or, where its chains share one
    (batch stride 0, as a model's expanded table), that table for all N;
    or (G, N / G, C, C) with the second axis expanded (``_stack_fwd_rev``'s
    two tables of a wide expanded model), table g for N / G chains."""
    if trans.dim() == 4:
        G, group = trans.shape[:2]
        if (G * group, *trans.shape[2:]) != (N, C, C) or (group > 1 and trans.stride(1) != 0):
            raise ValueError("{}: trans shape {} is no (G, N / G, C, C) of expanded tables "
                             "for N={} C={}".format(name, tuple(trans.shape), N, C))
        return trans[:, 0], group
    if tuple(trans.shape) != (N, C, C):
        raise ValueError("{}: trans shape {} != {}".format(name, tuple(trans.shape), (N, C, C)))
    group = N if N > 1 and trans.stride(0) == 0 else 1
    return trans[::group], group


def _grid_chunks(N, G, group, per_launch):
    """The grid route's launches: (first chain, end, first table, end,
    chains a table) of each. All N chains in one where `per_launch` holds
    them; else at most `per_launch` chains a launch, none across a table
    that several chains share."""
    if per_launch >= N:
        return [(0, N, 0, G, group)]
    out, a = [], 0
    while a < N:
        b = min(a + per_launch, N)
        if group == 1:
            out.append((a, b, a, b, 1))
        else:  # chains of one table, at most to its last
            g = a // group
            b = min(b, (g + 1) * group)
            out.append((a, b, g, g + 1, b - a))
        a = b
    return out


def _launch_wide_scan(name, symbol, trans, init, dur, emit, outputs, ints=(), inst=None):
    """Checks, then the launches of csrc/hsmm_scan_wide.cu's `symbol` on
    the route `inst` gives (by default ``wide_scan_instance``) writing
    `outputs`; `ints` (the code radix) follow the shape's. trans may be
    any (N, C, C) view, or ``_stack_fwd_rev``'s (G, N / G, C, C) tables
    (``_wide_tables``): where chains share a table the kernel gets it
    once. The cluster route takes the tables transposed ([from][to]), the
    grid route their rows padded to ``_table_stride(C)``. Returns the
    launches made (one unless the grid route splits the batch)."""
    N, T, C = emit.shape
    Km = dur.shape[1]
    if C <= MAX_CLASSES:
        raise ValueError("{}: C={} <= {}".format(name, C, MAX_CLASSES))
    if Km < 1:  # the carry needs a row (see _durations)
        raise ValueError("{}: dur needs at least one row".format(name))
    tables, group = _wide_tables(name, trans, N, C)
    if inst is None:
        sms = _sm_count(emit.device.index) if emit.is_cuda else H100_SMS
        inst = wide_scan_instance(C, Km, N, group, sms)
    if inst.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError("{}: C={} at Km={}: a block takes {} bytes of shared memory, past a "
                         "block's {}".format(name, C, Km, inst.smem_bytes, MAX_BLOCK_SMEM))
    G = tables.shape[0]
    if inst.route == "cluster":
        trans_t = tables.transpose(1, 2).contiguous()  # [from][to]: a c' row's classes contiguous
        _check_cuda(name, (emit, trans_t, init, dur), ((N, T, C), (G, C, C), (N, C), (N, Km, C)))
        err = _call("hsmm_scan_wide", symbol,
                    [trans_t, init, dur, emit, *outputs, None, None, None],
                    [N, T, C, Km, *ints, inst.cluster, inst.slab, 1, inst.smem_bytes, group], emit)
        _raise_on_error(name, err)
        return 1
    rs = _table_stride(C)
    table = emit.new_empty((G, C, rs))  # [to][from], each row padded
    table[..., :C] = tables
    _check_cuda(name, (emit, table, init, dur), ((N, T, C), (G, C, rs), (N, C), (N, Km, C)))
    n_max = inst.launch_chains
    xchg = emit.new_empty((n_max, 2, rs))
    blocks = -(-n_max // inst.chains) * -(-C // inst.slab)
    ring = emit.new_empty((blocks, Km, inst.chains * inst.slab)) if inst.ring == "global" \
        else None
    counter = torch.empty((1,), dtype=torch.int32, device=emit.device)
    chunks = _grid_chunks(N, G, group, n_max)
    for a, b, ta, tb, grp in chunks:
        err = _call("hsmm_scan_wide", symbol,
                    [table[ta:tb], init[a:b], dur[a:b], emit[a:b], *(o[a:b] for o in outputs),
                     xchg, ring, counter],
                    [b - a, T, C, Km, *ints, 0 if inst.table == "shared" else -1, inst.slab,
                     inst.chains, inst.smem_bytes, grp], emit)
        _raise_on_error(name, err)
    return len(chunks)


def hsmm_log_scan_wide(trans, init, dur, emit):
    """``hsmm_log_scan`` for a DP of C > 128 classes: (gamma, alphas,
    offsets), folded as the narrow scan folds (``_scan_plain``). On CUDA
    tensors it launches csrc/hsmm_scan_wide.cu's log instance on the route
    ``wide_scan_instance`` picks; on CPU tensors it runs
    ``_log_scan_plain``."""
    if _device_type(emit) == "cpu":
        return _log_scan_plain(trans, init, dur, emit)
    gamma, alphas = torch.empty_like(emit), torch.empty_like(emit)
    offsets = emit.new_empty((emit.shape[0], fold_blocks(emit.shape[1])))
    hsmm_log_scan_wide.launches += _launch_wide_scan(
        "hsmm_log_scan_wide", "hsmm_wide_log_scan", trans, init, dur, emit,
        [gamma, alphas, offsets])
    return gamma, alphas, offsets


hsmm_log_scan_wide.launches = 0


def hsmm_forward_scan_wide(trans, init, dur, emit):
    """``hsmm_forward_scan`` for a DP of C > 128 classes: (alphas,
    offsets), folded. On CUDA tensors it launches csrc/hsmm_scan_wide.cu's
    forward instance on the route ``wide_scan_instance`` picks; on CPU
    tensors it runs ``_forward_scan_plain``."""
    if _device_type(emit) == "cpu":
        return _forward_scan_plain(trans, init, dur, emit)
    alphas = torch.empty_like(emit)
    offsets = emit.new_empty((emit.shape[0], fold_blocks(emit.shape[1])))
    hsmm_forward_scan_wide.launches += _launch_wide_scan(
        "hsmm_forward_scan_wide", "hsmm_wide_forward_scan", trans, init, dur, emit,
        [alphas, offsets])
    return alphas, offsets


hsmm_forward_scan_wide.launches = 0


# ---- (b) the band max ------------------------------------------------------


def _band_max_plain(G1, G2p, dur):
    """Plain PyTorch version of the band max (any device, any float dtype).

    G1 (B, T, C); G2p (B, T2, C) with T2 >= T + Km; dur (B, Km, C).
    fm[t, c] = max over spans (s, d) covering t (s <= t < s + d,
    1 <= d <= Km) of G1[s, c] + dur[d-1, c] + G2p[s + d, c], in the
    running form H_r[s] = max_{j >= r} dur[j] + G2p[s+j+1],
    fm[t] = max_r G1[t-r] + H_r[t-r] — the kernel's operations.
    """
    B, T, C = G1.shape
    Km = dur.shape[1]
    H = torch.full_like(G1, BIG_NEG)
    fm = torch.full_like(G1, BIG_NEG)
    for r in range(Km - 1, -1, -1):
        H = torch.maximum(H, dur[:, r : r + 1] + G2p[:, r + 1 : r + 1 + T])
        if r < T:
            fm[:, r:] = torch.maximum(fm[:, r:], (G1 + H)[:, : T - r])
    return fm


def _band_shapes(name, G1, G2p, dur):
    B, T, C = G1.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    if T2 < T + Km:
        raise ValueError("{}: G2p has {} rows < T + Km = {}".format(name, T2, T + Km))
    _check_cuda(name, (G1, G2p, dur), ((B, T, C), (B, T2, C), (B, Km, C)))
    return B, T, T2, C, Km


class BandTile(NamedTuple):
    """A band kernel's tile (K3, K4): time rows and classes (`chunk`: all
    C, or for K4 past 1,024 classes an even split of them) a block (one
    thread a (row, class)), the durations a shared slab holds and the
    launch's shared memory, and where the launch's blocks land (for the
    record)."""

    rows: int
    threads: int
    slab: int
    smem_bytes: int
    tiles: int  # a video's (each chunk's)
    blocks_per_sm: int  # resident at once
    waves: int  # B * tiles over the card's resident blocks
    filling: float  # the launch's blocks over the waves' resident slots
    balance: float  # the mean SM's warps over the busiest SM's
    chunk: int  # classes a block


# an H100 SM's limits, and the registers csrc/band_max.cu's and
# csrc/band_grad.cu's launch bounds allow a thread
SM_THREADS = 2048
SM_BLOCKS = 32
SM_REGS = 65536
SM_SMEM = 233472  # 228 KB, of which each resident block also holds 1 KB
SM_SMEM_PER_BLOCK = 1024
BAND_MAX_REGS = 32
BAND_GRAD_REGS = 32
# the fewest threads a block of K4 takes (where the video has them): the
# block that comes last sums its video's tile partials with its threads
BAND_GRAD_MIN_THREADS = 256


def _blocks_per_sm(threads, regs):
    """Blocks of `threads` that an SM keeps resident by threads, block
    count and registers (`regs` a thread, allocated 8 at a time)."""
    reg_warps = SM_REGS // (32 * -(-regs // 8) * 8)
    return min(SM_BLOCKS, SM_THREADS // threads, reg_warps // -(-threads // 32))


def _band_tile(B, T, C, rows, busiest, slab, smem_bytes, per_sm, sms):
    # B the planes (videos, or for K4 video chunks) and C their classes
    tiles = -(-T // rows)
    resident = sms * per_sm
    waves = max(1, -(-B * tiles // resident))
    return BandTile(rows, rows * C, slab, smem_bytes, tiles, per_sm, waves,
                    B * tiles / (waves * resident), B * T * C / (32 * sms * busiest), C)


def _fewest_rows(B, T, C, sms, lo_threads, cost):
    """A band tile's rows: of the rows allowed (at most 1,024 threads a
    block, at least `lo_threads` where T allows), those for which the
    busiest SM, given ceil(blocks / sms) of the launch's blocks, costs
    the least, a block costing cost(warps, tiles); among equals the
    fewest tiles. Returns the rows and the busiest SM's warps."""
    C = max(C, 1)
    hi = max(1, min(T, MAX_BLOCK_THREADS // C))
    best = None
    for rows in range(min(hi, -(-lo_threads // C)), hi + 1):
        tiles, warps = -(-T // rows), -(-rows * C // 32)
        blocks = max(1, -(-B * tiles // sms))
        key = (blocks * cost(warps, tiles), tiles)
        if best is None or key < best[0]:
            best = (key, rows, blocks * warps)
    return best[1:]


# a halo start's issue against a tile row's in K3: a start runs its span
# terms through every duration (10 instructions a duration in the SASS
# that tools/scan_floor.py reads) and an output folds them (3.75); a halo
# start runs Km / 2 durations on average and folds nothing
BAND_MAX_HALO_SHARE = 3 / 8


@functools.cache
def band_max_tile(B, T, C, Km, sms=H100_SMS, halo_share=BAND_MAX_HALO_SHARE):
    """The tile K3 (csrc/band_max.cu) launches a (B, T, C) plane with Km
    duration rows on `sms` SMs.

    A block costs its warps and, where a video has more than one tile,
    `halo_share` of the warps that hold its halo, the starts of the Km - 1
    rows before the tile; the rows are those that leave the busiest SM
    the least (``_fewest_rows``; a halo share of 0 counts warps alone, as
    K4's rule does). The slab holds every duration (Km) where that leaves
    room for the blocks an SM keeps resident by threads and registers;
    else the most that does beside the carry of the starts' running
    maxima, min(rows + Km - 1, T) * C floats. Where not even one duration
    fits beside the carry, the tile says so by a shared memory past an
    H100 block's (the wrapper raises)."""
    C = max(C, 1)
    halo_warps = -(-min(max(Km - 1, 0), T) * C // 32)
    rows, busiest = _fewest_rows(
        B, T, C, sms, 1, lambda warps, tiles: warps + halo_share * halo_warps * (tiles > 1))
    threads = rows * C
    per_sm = _blocks_per_sm(threads, BAND_MAX_REGS)
    room = min(MAX_BLOCK_SMEM, SM_SMEM // per_sm - SM_SMEM_PER_BLOCK) // 4  # floats
    carry = 0
    if Km * threads > room:
        carry = min(rows + Km - 1, T) * C
        slab = max(1, (room - carry) // threads)
    else:
        slab = Km
    return _band_tile(B, T, C, rows, busiest, slab, 4 * (slab * threads + carry), per_sm,
                      sms)


def _launch_band_max(G1, G2p, dur, tile):
    """One launch of csrc/band_max.cu in `tile`; returns fm."""
    B, T, C = G1.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    fm = torch.empty_like(G1)
    err = _call("band_max", "hsmm_band_max", [G1, G2p, dur, fm],
                [B, T, T2, C, Km, tile.rows, tile.slab, tile.smem_bytes], G1)
    _raise_on_error("hsmm_band_max", err)
    return fm


def hsmm_band_max(G1, G2p, dur):
    """Per-frame max-marginals fm (B, T, C); see ``_band_max_plain``.

    On CUDA tensors (float32, contiguous, C <= 128) it launches
    csrc/band_max.cu once, in the tile ``band_max_tile`` sizes, which
    streams T in tiles of whole rows (one kernel for any T) and gives the
    plain version's bits; on CPU tensors it runs the plain version."""
    if _device_type(G1) == "cpu":
        return _band_max_plain(G1, G2p, dur)
    B, T, T2, C, Km = _band_shapes("hsmm_band_max", G1, G2p, dur)
    if not kernels_supported(C):
        raise ValueError("hsmm_band_max: C={} > {}".format(C, MAX_CLASSES))
    tile = band_max_tile(B, T, C, Km, _sm_count(G1.device.index))
    if tile.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError("hsmm_band_max: Km={} at C={} overflows the shared-memory carry".format(
            Km, C))
    fm = _launch_band_max(G1, G2p, dur, tile)
    hsmm_band_max.launches += 1
    return fm


hsmm_band_max.launches = 0


# ---- (c) the band gradient -------------------------------------------------


def _band_grad_plain(G1m, G2p, dur):
    """Plain PyTorch version of the band sweep (any device, any float dtype).

    G1m (B, T, C) = G1 - logZ; G2p (B, T2, C) with T2 >= T + Km;
    dur (B, Km, C). With M[s, j] = exp(G1m[s] + dur[j] + G2p[s+j+1]) the
    span posteriors, returns (qg, sa, st (B, T, C), lg (B, Km, C)):
    qg[s] = LSE_j dur[j] + G2p[s+j+1], sa[s] = sum_j M[s, j],
    st[i] = sum_j M[i-j-1, j], lg[j] = sum_s M[s, j]. The kernel's
    operations in its order (r descending, qg by jnp.logaddexp's formula);
    lg's sum over T is associated otherwise on the card: per thread
    block (C <= 128), or per thread, block and run (``band_grad_wide_tile``).
    """
    B, T, C = G1m.shape
    Km = dur.shape[1]
    qg = torch.full_like(G1m, BIG_NEG)
    sa = torch.zeros_like(G1m)
    st = torch.zeros_like(G1m)
    lg = G1m.new_zeros((B, Km, C))
    for r in range(Km - 1, -1, -1):
        x = dur[:, r : r + 1] + G2p[:, r + 1 : r + 1 + T]
        qg = torch.maximum(qg, x) + torch.log1p(torch.exp(-(qg - x).abs()))
        M = torch.exp(G1m + x)
        sa = sa + M
        lg[:, r] = M.sum(dim=1)
        if r + 1 < T:
            st[:, r + 1 :] = st[:, r + 1 :] + M[:, : T - r - 1]
    return qg, sa, st, lg


@functools.cache
def band_grad_tile(B, T, C, Km, sms=H100_SMS):
    """The tile K4's narrow kernel (csrc/band_grad.cu `band_grad_kernel`,
    which ``hsmm_band_grad`` launches up to 128 classes) takes for a (B,
    T, C) plane with Km duration rows on `sms` SMs. The kernel takes any
    C, as it did for every width before the wide kernel; tools/scan_ab.py
    launches an earlier source's kernel at wide C in this tile.

    The classes go in chunks of at most 1,024 (one chunk up to 1,024
    classes, else C split evenly over ceil(C / 1,024)), each chunk a
    plane of its own for the rule below. A block runs every duration of
    its rows, so a block's time follows its warps, and an SM's the warps
    it is given: the rule takes the rows
    (at most 1,024 threads a block, at least BAND_GRAD_MIN_THREADS where
    T allows) for which the busiest SM, given ceil(blocks / sms) of the
    launch's blocks, holds the fewest warps; among equals the fewest
    tiles. The slab holds every duration (Km) where that leaves room for
    the blocks an SM keeps resident by threads and registers, else the
    most that does. ``filling`` is the launch's blocks over the resident
    slots of the waves it takes, ``balance`` the mean SM's warps over the
    busiest SM's."""
    chunks = max(1, -(-C // MAX_BLOCK_THREADS))
    chunk = -(-C // chunks)
    rows, busiest = _fewest_rows(B * chunks, T, chunk, sms, BAND_GRAD_MIN_THREADS,
                                 lambda warps, tiles: warps)
    threads = rows * chunk
    per_sm = _blocks_per_sm(threads, BAND_GRAD_REGS)
    room = min(MAX_BLOCK_SMEM, SM_SMEM // per_sm - SM_SMEM_PER_BLOCK) // (4 * threads)
    slab = min(Km, max(1, room))
    return _band_tile(B * chunks, T, chunk, rows, busiest, slab, 4 * slab * threads, per_sm,
                      sms)


class WideBandTile(NamedTuple):
    """K4's wide tile (C > 128, csrc/band_grad.cu `band_grad_wide_kernel`):
    a block owns 32 classes (a group) and a run of `rows` time rows of one
    video, which its `warps` warps walk a row each at a time; a pass
    stages `slab` durations of each thread's lg column in shared memory."""

    rows: int  # a run's time rows
    warps: int
    threads: int
    slab: int
    smem_bytes: int
    tiles: int  # a video's runs
    groups: int  # a video's blocks of 32 classes
    blocks_per_sm: int  # resident at once
    waves: int  # B * groups * tiles over the card's resident blocks
    filling: float  # the launch's blocks over the waves' resident slots
    scratch_bytes: int  # the lg partials: B * tiles * Km * C floats past one run


BAND_GRAD_WIDE_CLASSES = 32
BAND_GRAD_WIDE_WARPS = 8
BAND_GRAD_WIDE_REGS = 32


@functools.cache
def band_grad_wide_tile(B, T, C, Km, sms=H100_SMS):
    """The tile K4's wide kernel takes for a (B, T, C) plane with Km
    duration rows on `sms` SMs.

    Blocks of 8 warps over 32 classes, at most 32 registers a thread, so
    that 8 blocks fit an SM by threads and registers; the slab holds
    every duration where 8 blocks' slabs still fit an SM's shared memory
    (Km <= 27), else as many as do (the kernel walks its run once a
    slab). The runs a video: of the counts that keep the lg partials
    within one plane (runs * Km <= T, so that B * runs * Km * C floats
    are at most B * T * C), give every warp a row and, where any does,
    give every resident block slot of the card a block (the duration loop
    is latency-bound: an SM that holds fewer blocks runs each row
    slower), the one whose launch costs the least, a launch costing its
    rounds of resident blocks (ceil(blocks / slots)) times a run's rows
    plus the Km rows of halo its windows of G1m and G2p reach past them;
    among equals the fewest runs. One run needs no partials and no
    ticket."""
    groups = -(-C // BAND_GRAD_WIDE_CLASSES)
    warps = BAND_GRAD_WIDE_WARPS
    threads = 32 * warps
    per_sm = _blocks_per_sm(threads, BAND_GRAD_WIDE_REGS)
    room = (SM_SMEM // per_sm - SM_SMEM_PER_BLOCK) // (4 * threads)
    slab = min(Km, max(1, room))
    smem = 4 * slab * threads
    per_sm = min(per_sm, SM_SMEM // (smem + SM_SMEM_PER_BLOCK))
    resident = sms * per_sm
    lines = max(B * groups, 1)
    # the run counts that whole runs of rows give: ceil(T / ceil(T / n))
    Tr = max(T, 1)
    counts = sorted({-(-Tr // -(-Tr // n)) for n in range(1, max(1, T // max(Km, warps, 1)) + 1)})
    filling = [n for n in counts if lines * n >= resident]
    runs = min(filling or counts, key=lambda n: (-(-lines * n // resident) * (-(-Tr // n) + Km), n))
    rows = -(-Tr // runs)
    tiles = -(-T // rows)
    waves = max(1, -(-B * groups * tiles // resident))
    scratch = 4 * B * tiles * Km * C if tiles > 1 else 0
    return WideBandTile(rows, warps, threads, slab, smem, tiles, groups, per_sm, waves,
                        B * groups * tiles / (waves * resident), scratch)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# K4's per-video counters, one int32 tensor a device, all 0 between launches
# (the block that takes a video's last ticket sets it back). Launches on one
# device share them, so they must not overlap: one stream at a time.
_TICKETS = {}


def _tickets(device, B):
    tickets = _TICKETS.get(device)
    if tickets is None or tickets.numel() < B:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("hsmm_band_grad: launch B={} once before capturing a CUDA graph, "
                               "so that its counters exist outside the graph".format(B))
        tickets = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
        _TICKETS[device] = tickets
    return tickets


def _launch_band_grad(G1m, G2p, dur, tile):
    """One launch of csrc/band_grad.cu in `tile`; returns (qg, sa, st, lg),
    the first three views of one (3, B, T, C) tensor."""
    B, T, C = G1m.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    qg, sa, st = G1m.new_empty((3, B, T, C)).unbind(0)
    lg = G1m.new_empty((B, Km, C))
    partials = G1m.new_empty((B * tile.tiles * Km * C,))
    chunks = -(-C // max(tile.chunk, 1))
    err = _call("band_grad", "hsmm_band_grad",
                [G1m, G2p, dur, qg, sa, st, lg, partials, _tickets(G1m.device, B * chunks)],
                [B, T, T2, C, Km, tile.rows, tile.slab, tile.smem_bytes, tile.chunk], G1m)
    _raise_on_error("hsmm_band_grad", err)
    return qg, sa, st, lg


def hsmm_band_grad(G1m, G2p, dur):
    """Span-posterior masses (qg, sa, st, lg); see ``_band_grad_plain``.

    On CUDA tensors (float32, contiguous, C <= 128: one thread a (row,
    class)) it launches csrc/band_grad.cu's narrow kernel once, in the
    tile ``band_grad_tile`` sizes, which reduces lg over the tiles in a
    fixed order (two runs give the same bits); above 128 classes the wide
    kernel (``hsmm_band_grad_wide``); on CPU tensors it runs the plain
    version."""
    if _device_type(G1m) == "cpu":
        return _band_grad_plain(G1m, G2p, dur)
    if G1m.shape[-1] > MAX_CLASSES:
        return hsmm_band_grad_wide(G1m, G2p, dur)
    B, T, T2, C, Km = _band_shapes("hsmm_band_grad", G1m, G2p, dur)
    tile = band_grad_tile(B, T, C, Km, _sm_count(G1m.device.index))
    out = _launch_band_grad(G1m, G2p, dur, tile)
    hsmm_band_grad.launches += 1
    return out


hsmm_band_grad.launches = 0


def _launch_band_grad_wide(G1m, G2p, dur, tile):
    """One launch of csrc/band_grad.cu's wide kernel in `tile`; returns
    (qg, sa, st, lg), the first three views of one (3, B, T, C) tensor."""
    B, T, C = G1m.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    qg, sa, st = G1m.new_empty((3, B, T, C)).unbind(0)
    lg = G1m.new_empty((B, Km, C))
    partials = G1m.new_empty((tile.scratch_bytes // 4,)) if tile.scratch_bytes else None
    err = _call("band_grad", "hsmm_band_grad_wide",
                [G1m, G2p, dur, qg, sa, st, lg, partials,
                 _tickets(G1m.device, B * tile.groups)],
                [B, T, T2, C, Km, tile.rows, tile.warps, tile.slab, tile.smem_bytes], G1m)
    _raise_on_error("hsmm_band_grad_wide", err)
    return qg, sa, st, lg


def hsmm_band_grad_wide(G1m, G2p, dur):
    """``hsmm_band_grad`` for a DP of C > 128 classes. On CUDA tensors
    (float32, contiguous, any C) it launches csrc/band_grad.cu's wide
    kernel once, in the tile ``band_grad_wide_tile`` sizes (lg the same
    bits in two runs; its partials at most one (B, T, C) plane); on CPU
    tensors it runs ``_band_grad_plain``."""
    if _device_type(G1m) == "cpu":
        return _band_grad_plain(G1m, G2p, dur)
    B, T, T2, C, Km = _band_shapes("hsmm_band_grad_wide", G1m, G2p, dur)
    tile = band_grad_wide_tile(B, T, C, Km, _sm_count(G1m.device.index))
    out = _launch_band_grad_wide(G1m, G2p, dur, tile)
    hsmm_band_grad_wide.launches += 1
    return out


hsmm_band_grad_wide.launches = 0


# ---- (d) the transition cotangent -------------------------------------------

# the frames of the plain version's chunk: at most (B, PAIR_CHUNK, C, C) of
# the pair exponent at once; where T <= PAIR_CHUNK, one chunk
PAIR_CHUNK = 64


def _pair_grad_plain(X, Y, trans, Z, lengths):
    """Plain PyTorch version of the transition cotangent (any device, any
    float dtype): (B, C, C) with [b, i, j] the sum over the interior
    boundaries t = 1 .. L_b - 1 of exp(X[b, t, j] + trans[b, i, j] +
    Y[b, t, i] - Z[b]); X, Y (B, T, C), trans (B, C, C) (an expanded
    view too), Z (B,), lengths (B,). The frames go in chunks of
    PAIR_CHUNK, each chunk's exponent formed, masked to BIG_NEG off the
    interior, exponentiated and summed over its frames, the chunks' sums
    added in order; the first chunk is the whole sum where T <=
    PAIR_CHUNK. The kernel forms each term in the same order; its sum over
    frames is associated otherwise (by pass, thread and run:
    ``pair_grad_tile``)."""
    B, T, C = X.shape
    out = X.new_zeros((B, C, C))
    for t0 in range(0, T, PAIR_CHUNK):
        t1 = min(t0 + PAIR_CHUNK, T)
        t_idx = torch.arange(t0, t1, device=X.device)[None, :]
        interior = (t_idx >= 1) & (t_idx < lengths[:, None])
        expo = X[:, t0:t1, None, :] + trans[:, None, :, :] + Y[:, t0:t1, :, None]
        expo = expo - Z[:, None, None, None]
        pair = torch.exp(
            torch.where(interior[:, :, None, None], expo, torch.full_like(expo, BIG_NEG))
        )
        out = pair.sum(dim=1) if t0 == 0 else out + pair.sum(dim=1)
    return out


def _pair_grad_plain64(X, Y, trans, Z, lengths):
    """``_pair_grad_plain`` in float64, a video at a time (at most (1,
    PAIR_CHUNK, C, C) of the exponent at once): the yardstick the pair
    kernel is held to (``_pair_grad_plain`` in float32 rounds each
    exponent to its own ulp)."""
    return torch.cat([
        _pair_grad_plain(X[b:b + 1].double(), Y[b:b + 1].double(), trans[b:b + 1].double(),
                         Z[b:b + 1].double(), lengths[b:b + 1])
        for b in range(X.shape[0])]) if X.shape[0] else X.new_zeros((0,) + trans.shape[1:],
                                                                      dtype=torch.float64)


# The pair kernel (csrc/pair_grad.cu): the sum over frames as a float64
# tensor-core product. A block owns a video, a tile of PAIR_TILE x PAIR_TILE
# (i, j) pairs and a run of frames, staged PAIR_FRAMES at a time. A frame
# of a tile goes into the product with the operands A[t, j] = exp(X[t, j]
# - a_t) and B[t, i] = exp(Y[t, i] + a_t + tau - Z), a_t the tile's largest
# X of the frame, b_t its largest Y and tau the tile's largest trans, and
# the product is scaled by exp(trans - tau); a frame whose gap g_t = a_t +
# b_t + tau - Z passes PAIR_THETA is summed term by term instead (the exact
# path), as is one whose gap is NaN (a NaN among its X, Y or Z), and one
# below PAIR_DEAD is left out (its every term is below float64's least).
# The source's header derives both.
PAIR_TILE = 64
PAIR_FRAMES = 32
PAIR_THREADS = 256
PAIR_REGS = 128
PAIR_THETA = 600.0
PAIR_DEAD = -750.0
# a block's shared memory (csrc/pair_grad.cu's Smem): the two operand
# stages (doubles, rows of PAIR_TILE + 4), the exact path's sums (doubles),
# a frame's two exponent shifts (doubles), two stages each of the staged X
# and Y (floats, rows of PAIR_TILE + 8), the warps' maxima and exact
# frames, a frame's state and the last-ticket flag
PAIR_SMEM = (8 * (2 * PAIR_FRAMES * (PAIR_TILE + 4) + PAIR_TILE * PAIR_TILE + 2 * PAIR_FRAMES)
             + 4 * (4 * PAIR_FRAMES * (PAIR_TILE + 8) + 2 * (PAIR_THREADS // 32)
                    + PAIR_FRAMES + 2))


def pair_scales(X, Y, trans, Z, lengths, side=PAIR_TILE):
    """The pair kernel's scales, in float64: (a, b (B, T, n), tau (B, n,
    n), gap (B, T, n, n), interior (B, T)) over the n = ceil(C / side)
    class tiles a side: a[b, t, q] the largest X[b, t, j] of j-tile q,
    b[b, t, p] the largest Y[b, t, i] of i-tile p (a and b NaN where a NaN
    is among them, as the kernel's max.NaN), tau[b, p, q] the tile's
    largest trans, NaN entries left out (0 where every entry is -inf or
    NaN), gap = a + b + tau - Z, and which frames are interior (1 <= t <
    L_b)."""
    B, T, C = X.shape
    n = -(-C // side)
    pad = n * side - C
    neg = float("-inf")
    Xd = torch.nn.functional.pad(X.double(), (0, pad), value=neg)
    Yd = torch.nn.functional.pad(Y.double(), (0, pad), value=neg)
    tr = torch.nn.functional.pad(trans.double(), (0, pad, 0, pad), value=neg)
    a = Xd.view(B, T, n, side).amax(dim=-1)
    b = Yd.view(B, T, n, side).amax(dim=-1)
    tr = torch.where(tr.isnan(), torch.full_like(tr, neg), tr)
    tau = tr.view(B, n, side, n, side).amax(dim=(2, 4))
    tau = torch.where(tau > neg, tau, torch.zeros_like(tau))
    gap = b[..., :, None] + a[..., None, :] + tau[:, None] - Z.double()[:, None, None, None]
    t_idx = torch.arange(T, device=X.device)[None, :]
    interior = (t_idx >= 1) & (t_idx < lengths.to(X.device).clamp(1, T)[:, None])
    return a, b, tau, gap, interior


class PairSplit(NamedTuple):
    """How the pair kernel takes a launch's interior tile-frames (each
    (video, tile, interior frame)): into the product, term by term (the
    exact path, gap > PAIR_THETA or NaN), or left out (gap < PAIR_DEAD)."""

    frames: int
    product: int
    exact: int
    dead: int

    @property
    def exact_share(self):
        return self.exact / max(self.frames, 1)


def pair_grad_split(X, Y, trans, Z, lengths, side=PAIR_TILE, theta=PAIR_THETA):
    """The PairSplit of the inputs (X, Y, trans, Z, lengths): from
    ``pair_scales``, as the kernel decides it."""
    _, _, _, gap, interior = pair_scales(X, Y, trans, Z, lengths, side)
    inside = interior[:, :, None, None].expand_as(gap)
    exact = inside & ~(gap <= theta)  # NaN too, as the kernel sums it term by term
    dead = inside & (gap < PAIR_DEAD)
    frames = int(inside.sum())
    return PairSplit(frames, frames - int(exact.sum()) - int(dead.sum()), int(exact.sum()),
                     int(dead.sum()))


def _pair_grad_scaled(X, Y, trans, Z, lengths, side=PAIR_TILE, theta=PAIR_THETA):
    """The pair kernel's algorithm in float64 (the tests hold it against
    ``_pair_grad_plain`` in float64; the main path never runs it): for
    each (i, j) tile, the operands of ``pair_scales``' product frames
    multiplied with torch.matmul over the frames and scaled by exp(trans -
    tau) in each video that has an interior frame, plus the exact path's
    frames (gap past theta, or NaN) summed term by term. Returns the (B,
    C, C) float64 sum."""
    X, Y, trans, Z = X.double(), Y.double(), trans.double(), Z.double()
    B, T, C = X.shape
    a, _, tau, gap, interior = pair_scales(X, Y, trans, Z, lengths, side)
    inside = interior[:, :, None, None]
    product = inside & (gap <= theta) & (gap >= PAIR_DEAD)
    exact = inside & ~(gap <= theta)
    framed = interior.any(dim=1)[:, None, None]
    out = X.new_zeros((B, C, C))
    zero = X.new_zeros(())
    for p, i0 in enumerate(range(0, C, side)):
        for q, j0 in enumerate(range(0, C, side)):
            Xj, Yi = X[:, :, j0:j0 + side], Y[:, :, i0:i0 + side]
            tr = trans[:, i0:i0 + side, j0:j0 + side]
            live = product[:, :, p, q, None]
            shift = (a[:, :, q] + tau[:, None, p, q] - Z[:, None])[..., None]
            A = torch.where(live, torch.exp(Xj - a[:, :, q, None]), zero)
            Bt = torch.where(live, torch.exp(Yi + shift), zero)
            tile = torch.where(framed,
                               (Bt.transpose(1, 2) @ A) * torch.exp(tr - tau[:, p, q, None, None]),
                               zero)
            hot = exact[:, :, p, q]
            for t0 in range(0, T, PAIR_CHUNK):
                if bool(hot[:, t0:t0 + PAIR_CHUNK].any()):
                    expo = (Xj[:, t0:t0 + PAIR_CHUNK, None, :] + tr[:, None]
                            + Yi[:, t0:t0 + PAIR_CHUNK, :, None] - Z[:, None, None, None])
                    keep = hot[:, t0:t0 + PAIR_CHUNK, None, None]
                    tile = tile + torch.exp(torch.where(keep, expo, zero - float("inf"))).sum(1)
            out[:, i0:i0 + side, j0:j0 + side] = tile
    return out


class PairTile(NamedTuple):
    """A pair kernel's launch (csrc/pair_grad.cu): blocks of 256 threads
    over a tile of (i, j) pairs of one video (PAIR_TILE a side on the
    tensor route, PAIR_SCALAR_TILE on the scalar route) and a run of
    `frames` frames."""

    route: str  # "tensor" (pair_grad_kernel) or "scalar" (pair_grad_scalar_kernel)
    tiles: int  # a video's (i, j) tiles
    runs: int  # a video's runs of frames
    frames: int  # a run's
    blocks_per_sm: int  # resident at once
    waves: int  # B * tiles * runs over the card's resident blocks
    filling: float  # the launch's blocks over the waves' resident slots
    scratch_bytes: int  # the partials past one run: B * runs * C * C doubles (floats, scalar)


# the scalar route (csrc/pair_grad.cu pair_grad_scalar_kernel, one expf a
# term): tiles of 32 x 32 pairs, at most 64 registers a thread (four blocks
# an SM), float32 partials. ``hsmm_pair_grad`` takes it at C <= 32, where
# its launch is shorter than the product's (the serving shape and the
# CrossTask fit batches; PERF.md §6)
PAIR_NARROW_CLASSES = 32
PAIR_SCALAR_TILE = 32
PAIR_SCALAR_REGS = 64


def pair_runs(B, T, C, side, per_sm, least, sms):
    """(runs, frames) a video for a pair kernel's tiles of `side`
    classes, `per_sm` blocks an SM: of the counts that leave every run at
    least `least` frames and keep the partials within two planes (runs * C
    <= T), the one whose launch costs the least, a launch costing its
    rounds of resident blocks (ceil(blocks / slots)) times a run's frames
    plus one pass's (the partials' sum); among equals the fewest runs."""
    side_n = -(-max(C, 1) // side)
    lines = max(B, 1) * side_n * side_n
    resident = sms * per_sm
    Tr = max(T, 1)
    most = max(1, min(Tr // least, Tr // max(C, 1)))
    counts = {-(-Tr // -(-Tr // n)) for n in range(1, most + 1)}
    runs = min(counts, key=lambda n: (-(-lines * n // resident) * (-(-Tr // n) + least), n))
    frames = -(-Tr // runs)
    return -(-Tr // frames), frames  # the runs the launch derives from `frames`


@functools.cache
def pair_grad_tile(B, T, C, sms=H100_SMS, route=None):
    """The launch a pair kernel takes for (B, T, C) on `sms` SMs, on
    `route` (by default the scalar route at C <= PAIR_NARROW_CLASSES, else
    the tensor route): two blocks an SM on the tensor route (PAIR_REGS
    registers, PAIR_SMEM bytes of shared memory), four on the scalar
    route, and ``pair_runs`` runs a video (29 runs of 36 frames for 18
    videos of 1,024 frames at 19 classes, the scalar route's; 2 at 342
    classes, 1 at 1,577). One run needs no partials and no ticket."""
    if route is None:
        route = "scalar" if C <= PAIR_NARROW_CLASSES else "tensor"
    if route == "tensor":
        side, word = PAIR_TILE, 8
        per_sm = min(_blocks_per_sm(PAIR_THREADS, PAIR_REGS),
                     SM_SMEM // (PAIR_SMEM + SM_SMEM_PER_BLOCK))
    else:
        side, word = PAIR_SCALAR_TILE, 4
        per_sm = _blocks_per_sm(PAIR_THREADS, PAIR_SCALAR_REGS)
    tiles = (-(-max(C, 1) // side)) ** 2
    runs, frames = pair_runs(B, T, C, side, per_sm, PAIR_FRAMES, sms)
    resident = sms * per_sm
    lines = max(B, 1) * tiles
    waves = max(1, -(-lines * runs // resident))
    scratch = word * B * runs * C * C if runs > 1 else 0
    return PairTile(route, tiles, runs, frames, per_sm, waves,
                    lines * runs / (waves * resident), scratch)


def _launch_pair_grad(X, Y, trans, Z, lengths, tile):
    """One launch of csrc/pair_grad.cu's kernel of `tile`'s route in
    `tile`; returns the (B, C, C) cotangent."""
    B, T, C = X.shape
    out = X.new_empty((B, C, C))
    part, tickets = None, None
    if tile.runs > 1:
        dtype = torch.float64 if tile.route == "tensor" else torch.float32
        part = X.new_empty((tile.scratch_bytes // dtype.itemsize,), dtype=dtype)
        tickets = _tickets(X.device, B * tile.tiles)
    symbol = "hsmm_pair_grad" if tile.route == "tensor" else "hsmm_pair_grad_scalar"
    err = _call("pair_grad", symbol, [X, Y, trans, Z, lengths, out, part, tickets],
                [B, T, C, *trans.stride(), tile.frames], X)
    _raise_on_error(symbol, err)
    return out


def _pair_grad_checked(name, X, Y, trans, Z, lengths):
    """The pair kernels' checks before a launch; returns lengths as
    contiguous int32."""
    B, T, C = X.shape
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda(name, [X, Y, Z, lengths], [(B, T, C), (B, T, C), (B,), (B,)],
                (torch.float32,) * 3 + (torch.int32,))
    if trans.device != X.device or trans.dtype != torch.float32 or tuple(trans.shape) != (
            B, C, C):
        raise ValueError("{}: trans {} {} on {}, not ({}, {}, {}) float32 on {}".format(
            name, tuple(trans.shape), trans.dtype, trans.device, B, C, C, X.device))
    if B > 65535 or max(trans.stride()) > 2 ** 31 - 1:
        raise ValueError("{}: B={} (at most 65,535) or trans strides {} past int32".format(
            name, B, trans.stride()))
    return lengths


def hsmm_pair_grad_narrow(X, Y, trans, Z, lengths):
    """The transition cotangent on the scalar route (csrc/pair_grad.cu
    pair_grad_scalar_kernel), at any C: each term formed in the plain
    version's float32 order, the sum over frames associated by pass, thread
    and run (within rtol 1e-5 / atol 1e-4 of ``_pair_grad_plain``, the same
    bits in two runs). ``hsmm_pair_grad`` takes it at C <=
    PAIR_NARROW_CLASSES. On CPU tensors it runs the plain version."""
    if _device_type(X) == "cpu":
        return _pair_grad_plain(X, Y, trans, Z, lengths)
    B, T, C = X.shape
    lengths = _pair_grad_checked("hsmm_pair_grad_narrow", X, Y, trans, Z, lengths)
    out = _launch_pair_grad(X, Y, trans, Z, lengths,
                            pair_grad_tile(B, T, C, _sm_count(X.device.index), "scalar"))
    hsmm_pair_grad_narrow.launches += 1
    return out


hsmm_pair_grad_narrow.launches = 0


def hsmm_pair_grad(X, Y, trans, Z, lengths):
    """The transition cotangent (B, C, C); see ``_pair_grad_plain``.

    On CUDA tensors (X, Y (B, T, C) float32 contiguous; trans (B, C, C)
    float32 of any strides, an expanded table read in place; Z (B,)
    float32; lengths (B,), any integer type) it launches one kernel of
    csrc/pair_grad.cu, in the launch ``pair_grad_tile`` sizes: past
    PAIR_NARROW_CLASSES the tensor route, the sum over frames as a float64
    tensor-core product of per-frame scaled operands
    (``_pair_grad_scaled`` is its algorithm in float64), held to the plain
    version in float64; at or below it the scalar route
    (``hsmm_pair_grad_narrow``). Neither holds the (B, T, C, C) exponent,
    and each sums a pair's runs in a fixed order (two runs give the same
    bits). ``launches`` counts the tensor route's launches,
    ``hsmm_pair_grad_narrow.launches`` the scalar route's. On CPU tensors
    it runs the plain version."""
    if _device_type(X) == "cpu":
        return _pair_grad_plain(X, Y, trans, Z, lengths)
    B, T, C = X.shape
    if C <= PAIR_NARROW_CLASSES:
        return hsmm_pair_grad_narrow(X, Y, trans, Z, lengths)
    lengths = _pair_grad_checked("hsmm_pair_grad", X, Y, trans, Z, lengths)
    out = _launch_pair_grad(X, Y, trans, Z, lengths,
                            pair_grad_tile(B, T, C, _sm_count(X.device.index), "tensor"))
    hsmm_pair_grad.launches += 1
    return out


hsmm_pair_grad.launches = 0


# ---- the two directions and the band inputs --------------------------------


def _stack_fwd_rev(pots: HsmmPotentials, lengths):
    """The forward model and its time-reversed counterpart stacked on the
    batch axis, as contiguous (2B, ...) scan inputs.

    By the HSMM's time symmetry the suffix boundary scores are the prefix
    boundary scores of the REVERSED model: emissions reversed within each
    length, transitions transposed, init and end_mask swapped. Every
    chain starts at t = 0. Above 128 classes, where the B videos share one
    table (an expanded view, batch stride 0, as a model's potentials give
    it), trans is the two tables (the table and its transpose) as a (2, B,
    C, C) view expanded over the videos: the wide scans read each once
    (``_wide_tables``), the plain versions as the concatenated form."""
    B, _, C = pots.emit.shape
    if C > MAX_CLASSES and (B == 1 or pots.trans.stride(0) == 0):
        table = pots.trans[0]
        trans = torch.stack([table, table.transpose(0, 1)])[:, None].expand(2, B, C, C)
    else:
        trans = torch.cat([pots.trans, pots.trans.transpose(-1, -2)], dim=0).contiguous()
    init = torch.cat([pots.init, pots.end_mask], dim=0)
    dur = _durations(pots.lens)
    dur = torch.cat([dur, dur], dim=0)
    emit = torch.cat([pots.emit, reverse_within_length(pots.emit, lengths)], dim=0)
    return (trans, *(x.contiguous() for x in (init, dur, emit)))


def _forward_chains(scan_in, B):
    """The forward model's B chains of ``_stack_fwd_rev``'s inputs: its
    table (or tables) and the first B rows of the rest."""
    trans, *rest = scan_in
    return (trans[0] if trans.dim() == 4 else trans[:B], *(x[:B] for x in rest))


def _dense_trans(trans):
    """A scan's trans as (N, C, C): ``_stack_fwd_rev``'s (2, B, C, C) view
    of two tables as the concatenated tables, (N, C, C) as it is."""
    return trans.reshape(-1, *trans.shape[-2:]) if trans.dim() == 4 else trans


def _band_inputs(pots: HsmmPotentials, lengths, gamma):
    """(G1, G2p, band) for the band kernels from the stacked gamma planes
    (max semiring for the band max, log for the band gradient).

    Splits each span's score into a prefix part at its start boundary s
    and a suffix part at its end boundary e = s + d:
    M[s, d] = G1[s] + lens[d] + G2p[s + d]. JAX's _packed_G1_g2 in the
    unpacked layout."""
    B, T, C = pots.emit.shape
    device = pots.emit.device
    K = pots.lens.shape[1]
    gammaF, gammaR = gamma[:B], gamma[B:]
    t_col = torch.arange(T, device=device)[None, :, None]
    L = lengths[:, None, None]
    cum = _emission_cumsum(pots.emit)  # (B, T+1, C) exclusive prefix sums

    # G1[s] = F[s] - cum[s], F[s] the prefix score with the next span
    # starting at s (init at s = 0), BIG_NEG from the length on
    F = torch.cat([pots.init[:, None], gammaF[:, : T - 1]], dim=1)
    F = torch.where(t_col < L, F, torch.full_like(F, BIG_NEG))
    G1 = F - cum[:, :T]

    # G2[e] = cum[e] + S2[e], S2[e] the suffix score from boundary e given
    # the previous span's class: the reversed chain has consumed L - e
    # frames at its step L - e - 1. Row e == L carries end_mask; rows
    # e == 0 and e > L are BIG_NEG.
    e_col = torch.arange(T + 1, device=device)[None, :, None]
    idx = (L - e_col - 1).clamp(0, T - 1).expand(B, T + 1, C)
    S2 = torch.gather(gammaR, 1, idx)
    S2 = torch.where(e_col == L, pots.end_mask[:, None, :], S2)
    S2 = torch.where((e_col >= 1) & (e_col <= L), S2, torch.full_like(S2, BIG_NEG))
    # K - 1 BIG_NEG rows past e = T: spans ending beyond the buffer (whole
    # rows whatever T is: a batch shorter than the band needs them too)
    G2p = torch.cat([cum + S2, S2.new_full((B, K - 1, C), BIG_NEG)], dim=1)
    # K == 1 has no representable duration: an empty band (all BIG_NEG)
    band = pots.lens[:, 1:, :]
    return G1.contiguous(), G2p.contiguous(), band.contiguous()


class GradBand(NamedTuple):
    """The band gradient's inputs and what the backward needs to read its
    outputs (``_grad_band_inputs``)."""

    G1m: torch.Tensor  # (B * chunks, rows, C)
    G2p: torch.Tensor  # (B * chunks, rows + Km + 1, C)
    band: torch.Tensor  # (B * chunks, Km, C)
    chunks: int  # a video's chunks
    chunk: int  # the rows a chunk owns (its G1m's past them are a halo)
    x_shift: torch.Tensor  # (B, T) float64: Of(s - 1) - Fref(s's chunk); None: no fold
    y_shift: torch.Tensor  # (B, T, C) float64: cum[s] - cum[s's chunk start]; None: no fold


def _grad_band_inputs(pots: HsmmPotentials, lengths, gamma, offsets, lse, chunk=BAND_CHUNK):
    """The band gradient's inputs (``GradBand``) from the stacked
    log-semiring scan (gamma and offsets of its 2B chains) and the forward
    chains' finals' LSE (B,), so that G1m[s] + band[j] + G2p[s+j+1] is a
    log span posterior, in chunks of `chunk` rows (the backward's
    BAND_CHUNK; a card test takes T, one chunk a video, to reach K4 wide's
    runs that meet by tickets).

    Where no block of the chains folded (T <= SCAN_FOLD) one chunk:
    ``_band_inputs`` with -lse (= -logZ) folded into G1, in float32, as
    before the fold. Else the pieces come back to float64 with their
    chains' offsets: G1 = F - cum and G2 = cum + S2 - logZ, F with the forward
    chain's offset Of, S2 with the reversed chain's Or, logZ = lse + Of(L
    - 1), the emission prefix sums cum taken in float64. A video's rows
    split into chunks of `chunk` rows from its first frame, each a
    video of the launch of its own rows and a halo of Km rows past them
    (their G1m BIG_NEG: the chunks after it own those starts). A chunk
    starting at t0 is anchored by A = cum[t0] - Fref (per class; Fref =
    Of(t0), per video; A = 0 for the first chunk): G1m = G1 + A, G2p = G2
    - A, each rounded once, so that the float32 values K4 reads are path
    scores over a chunk, not over the video; their sum is the same
    posterior. Masked rows are BIG_NEG as in ``_band_inputs``."""
    B, T, C = pots.emit.shape
    if T <= SCAN_FOLD:
        G1, G2p, band = _band_inputs(pots, lengths, gamma)
        return GradBand((G1 - lse[:, None, None]).contiguous(), G2p, band, 1, T, None, None)
    dtype, Km = pots.emit.dtype, pots.lens.shape[1] - 1
    N = chunk  # rows a chunk owns
    n = max(1, -(-T // N))
    L = lengths[:, None]
    # every chain's offset at each step, and each row s's forward offset
    # Of(s - 1) (F[0] = init has none)
    steps = torch.cumsum(offsets, dim=1, dtype=torch.float64)
    steps = steps.repeat_interleave(SCAN_FOLD, dim=1)[:, :T]
    of = torch.nn.functional.pad(steps[:B, : T - 1], (1, 0))
    logZ = lse.double() + steps[:B].gather(1, L - 1)[:, 0]
    cum = torch.nn.functional.pad(torch.cumsum(pots.emit, dim=1, dtype=torch.float64),
                                  (0, 0, 1, 0))  # (B, T + 1, C) exclusive prefix sums
    F = torch.cat([pots.init[:, None], gamma[:B, : T - 1]], dim=1)
    G1 = (F.double() + of[..., None]) - cum[:, :T]
    # S2[e]: the reversed chain has consumed L - e frames at its step
    # L - e - 1; row e == L carries end_mask (no offset)
    e_idx = torch.arange(T + 1, device=pots.emit.device)[None, :]
    idx = (L - e_idx - 1).clamp(0, T - 1)
    S2 = (torch.gather(gamma[B:], 1, idx[..., None].expand(B, T + 1, C)).double()
          + steps[B:].gather(1, idx)[..., None])
    S2 = torch.where((e_idx == L)[..., None], pots.end_mask[:, None, :].double(), S2)
    G2 = (cum + S2) - logZ[:, None, None]
    live1 = e_idx[:, :T] < L
    live2 = (e_idx >= 1) & (e_idx <= L)
    band = pots.lens[:, 1:, :]

    rows = N + Km
    starts = torch.arange(0, n * N, N, device=pots.emit.device)  # the chunks' t0
    fref = steps[:B, starts]  # (B, n)
    cum0 = cum[:, starts]  # (B, n, C)
    A = (cum0 - fref[..., None])[:, :, None, :]  # (B, n, 1, C)

    def chunked(x, live, size, own):
        """x's rows k * N .. k * N + size - 1 for each chunk k, anchored
        (G1: + A; G2: - A) and rounded once; BIG_NEG where not live and,
        for G1 (`own`), past the chunk's own rows."""
        pad = (n - 1) * N + size - x.shape[1]
        x = torch.nn.functional.pad(x, (0, 0, 0, pad)).unfold(1, size, N).transpose(2, 3)
        live = torch.nn.functional.pad(live, (0, pad)).unfold(1, size, N)
        if own:
            live = live & (torch.arange(size, device=live.device) < N)
        x = (x + A if own else x - A).to(dtype)
        return torch.where(live[..., None], x, BIG_NEG).reshape(B * n, size, C).contiguous()

    chunk_of = torch.arange(T, device=pots.emit.device) // N  # each row's chunk
    return GradBand(chunked(G1, live1, rows, True), chunked(G2, live2, rows + Km + 1, False),
                    band[:, None].expand(B, n, Km, C).reshape(B * n, Km, C).contiguous(), n, N,
                    of - fref[:, chunk_of], cum[:, :T] - cum0[:, chunk_of])


def _band_grad_chunked(band_grad, gb: GradBand, T):
    """(qg, sa, st (B, T, C), lg (B, Km, C)): ``band_grad`` launched once
    over a ``GradBand``'s chunks, its outputs put back in place: qg and sa
    from each chunk's own rows, st summed where a chunk's halo overlaps
    the chunks after it (a halo of Km rows reaches ceil(Km / N) of them:
    one slice-add each), lg summed over the chunks."""
    qg, sa, st, lg = band_grad(gb.G1m, gb.G2p, gb.band)
    n, N = gb.chunks, gb.chunk
    if gb.x_shift is None:
        return qg, sa, st, lg
    B = qg.shape[0] // n
    C = qg.shape[-1]
    rows = st.shape[1]
    own = lambda x: x.view(B, n, rows, C)[:, :, :N].reshape(B, n * N, C)[:, :T]  # noqa: E731
    st = st.view(B, n, rows, C)
    reach = -(-rows // N)  # the chunks a chunk's rows touch, its own included
    total = torch.nn.functional.pad(st[:, :, :N].reshape(B, n * N, C),
                                    (0, 0, 0, (reach - 1) * N))
    for h in range(1, reach):
        part = st[:, :, h * N: (h + 1) * N]  # chunk k's rows (k + h) * N ..
        part = torch.nn.functional.pad(part, (0, 0, 0, N - part.shape[2]))
        total[:, h * N: (h + n) * N] += part.reshape(B, n * N, C)
    return own(qg), own(sa), total[:, :T].contiguous(), lg.view(B, n, -1, C).sum(dim=1)


# ---- the labels chain ------------------------------------------------------


def _max_marginals(pots: HsmmPotentials, lengths, gamma_scan, band_max):
    """Per-frame max-marginals fm (B, T, C): the best score of any
    segmentation whose span covering frame t has class c."""
    lengths = _clamped(lengths, pots.emit.device)
    gamma, _ = gamma_scan(*_stack_fwd_rev(pots, lengths))
    return band_max(*_band_inputs(pots, lengths, gamma))


def _viterbi_labels(pots: HsmmPotentials, lengths, gamma_scan, band_max):
    fm = _max_marginals(pots, lengths, gamma_scan, band_max)
    lengths = _clamped(lengths, pots.emit.device)
    t = torch.arange(fm.shape[1], device=fm.device)[None, :]
    labels = fm.argmax(dim=2)  # first maximum, like jnp.argmax
    labels = torch.where(t < lengths[:, None], labels, -1)
    # every frame of the best path attains the global best score
    scores = fm[:, 0].amax(dim=1)
    return labels, scores


def hsmm_viterbi_labels(pots: HsmmPotentials, lengths):
    """Viterbi frame labels without traceback: (labels (B, T) int64 with
    -1 past each length, scores (B,)). Both kernels on CUDA tensors, their
    plain versions on CPU tensors. Requires C <= 128."""
    return _viterbi_labels(pots, lengths, hsmm_gamma_scan, hsmm_band_max)


def hsmm_viterbi_labels_plain(pots: HsmmPotentials, lengths):
    """``hsmm_viterbi_labels`` through the plain versions only, on any
    device and dtype (float64 included): the yardstick the kernels are
    held against."""
    return _viterbi_labels(pots, lengths, _gamma_scan_plain, _band_max_plain)


# ---- (d) exact spans: the backpointer scan and the traceback ---------------

# the class radix of a backpointer code, bp = bp_d * radix + bp_c: JAX's
# LANES for C <= 128 (the narrow kernels' compiled radix), and for a wide
# DP a power of two >= C, at least WIDE_CODE_RADIX (the wide kernels take
# it as an argument)
CODE_RADIX = 128
WIDE_CODE_RADIX = 1024


def code_radix(C):
    """The radix of C classes' backpointer codes: CODE_RADIX at C <= 128,
    else the larger of WIDE_CODE_RADIX and the least power of two >= C."""
    if C <= MAX_CLASSES:
        return CODE_RADIX
    return max(WIDE_CODE_RADIX, 1 << (C - 1).bit_length())


def _scan_radix(name, C, Km):
    """``code_radix(C)``, raising where Km duration rows would carry a
    code past int32."""
    radix = code_radix(C)
    if Km * radix > 2 ** 31:
        raise ValueError("{}: Km={} rows at radix {} overflow the int32 codes".format(
            name, Km, radix))
    return radix


def _viterbi_scan_plain(trans, init, dur, emit, radix=None):
    """Plain PyTorch version of the backpointer scan (any device, any
    float dtype).

    trans (N, C, C) [to, from] (or the (2, B, C, C) form, as
    ``_gamma_scan_plain``); init (N, C); dur (N, Km, C), row j scoring
    duration j+1; emit (N, T, C). Returns (alphas (N, T, C), bp
    (N, T, C) int32): alphas[:, t] is the best score of frames [0, t]
    whose last span ends at t, bp[:, t, c] = bp_d * radix + bp_c with
    bp_d the argmax duration row of that span and bp_c the argmax
    previous class at boundary t + 1 given next class c; `radix` defaults
    to ``code_radix(C)``. First maxima (argmax), the kernel's float
    operations in its order.
    """
    N, T, C = emit.shape
    Km = dur.shape[1]
    if radix is None:
        radix = _scan_radix("_viterbi_scan_plain", C, Km)
    trans = _dense_trans(trans)
    W = torch.full((N, Km, C), BIG_NEG, dtype=emit.dtype, device=emit.device)
    W[:, 0] = init
    cum = torch.zeros((N, C), dtype=emit.dtype, device=emit.device)
    alphas, codes = [], []
    for t in range(T):
        cum = cum + emit[:, t]
        span = W + dur
        alpha = span.amax(dim=1) + cum
        arrivals = trans + alpha[:, None, :]
        gamma = arrivals.amax(dim=2)
        codes.append(span.argmax(dim=1) * radix + arrivals.argmax(dim=2))
        W = torch.cat([(gamma - cum)[:, None], W[:, :-1]], dim=1)
        alphas.append(alpha)
    if not T:
        return emit.new_empty((N, 0, C)), torch.empty((N, 0, C), dtype=torch.int32,
                                                       device=emit.device)
    return torch.stack(alphas, dim=1), torch.stack(codes, dim=1).to(torch.int32)


def _traceback_plain(bp, lengths, c_last, radix=None):
    """Plain PyTorch version of the traceback (any device): spans (N, T)
    int64, the class at each span start and -1 elsewhere.

    Walks every video at once, as JAX's vmapped while-loop: from
    (t = length, c = c_last), d = bp_d + 1 at (t - 1, c), s = t - d,
    spans[s] = c, and for s > 0 the previous class is bp_c at (s - 1, c),
    with the codes at `radix` (default ``code_radix(C)``). A start before
    frame 0 (only on an impossible, BIG_NEG path) wraps like a negative
    index and ends that video's walk."""
    N, T, C = bp.shape
    if radix is None:
        radix = code_radix(C)
    device = bp.device
    spans = torch.full((N, T), -1, dtype=torch.long, device=device)
    rows = torch.arange(N, device=device)
    codes = bp.long()
    t, c = lengths.long().clone(), c_last.long().clone()
    while bool((t > 0).any()):
        active = t > 0
        d = codes[rows, (t - 1).clamp(min=0), c] // radix + 1
        s = t - d
        w = torch.where(s >= 0, s, s + T)
        write = active & (w >= 0)
        spans[rows[write], w[write]] = c[write]
        c_prev = codes[rows, (s - 1).clamp(min=0), c] % radix
        c = torch.where(active & (s > 0), c_prev, c)
        t = torch.where(active, s, t)
    return spans


def hsmm_viterbi_scan(trans, init, dur, emit):
    """The backpointer scan: (alphas (N, T, C), bp (N, T, C) int32); see
    ``_viterbi_scan_plain`` for the function.

    On CUDA tensors (float32, contiguous but trans, which may be an
    expanded view) it launches csrc/hsmm_viterbi.cu, one block per video,
    at C <= 128, and the wide kernel (``hsmm_viterbi_scan_wide``, which
    gives the chains of an expanded trans one table) above; on CPU
    tensors it runs the plain version. Raises where the codes would
    overflow int32."""
    radix = _scan_radix("hsmm_viterbi_scan", emit.shape[-1], dur.shape[1])
    if _device_type(emit) == "cpu":
        return _viterbi_scan_plain(trans, init, dur, emit, radix)
    if emit.shape[-1] > MAX_CLASSES:
        return hsmm_viterbi_scan_wide(trans, init, dur, emit)
    alphas = torch.empty_like(emit)
    bp = torch.empty(emit.shape, dtype=torch.int32, device=emit.device)
    _launch_scan("hsmm_viterbi_scan", "hsmm_viterbi_scan", trans.contiguous(), init, dur, emit,
                 [alphas, bp], lib="hsmm_viterbi")
    hsmm_viterbi_scan.launches += 1
    return alphas, bp


hsmm_viterbi_scan.launches = 0


def hsmm_viterbi_scan_wide(trans, init, dur, emit):
    """``hsmm_viterbi_scan`` for a DP of C > 128 classes: (alphas, bp)
    with the codes at ``code_radix(C)``. On CUDA tensors it launches
    csrc/hsmm_scan_wide.cu's max instance on the route
    ``wide_scan_instance`` picks; on CPU tensors it runs the plain
    version."""
    radix = _scan_radix("hsmm_viterbi_scan_wide", emit.shape[-1], dur.shape[1])
    if _device_type(emit) == "cpu":
        return _viterbi_scan_plain(trans, init, dur, emit, radix)
    alphas = torch.empty_like(emit)
    bp = torch.empty(emit.shape, dtype=torch.int32, device=emit.device)
    hsmm_viterbi_scan_wide.launches += _launch_wide_scan(
        "hsmm_viterbi_scan_wide", "hsmm_wide_viterbi_scan", trans, init, dur, emit, [alphas, bp],
        [radix])
    return alphas, bp


hsmm_viterbi_scan_wide.launches = 0


class TracebackTile(NamedTuple):
    """The traceback's tile: code rows a tile and the launch's dynamic
    shared memory."""

    rows: int
    smem_bytes: int


# the traceback's shared memory: a 16-byte header (the tile's mbarrier and
# two hand-off slots), then two tile buffers of _tile_words(rows, C)
TRACEBACK_HEADER = 16


def _tile_words(rows, C):
    # rows * C codes placed up to 3 words in (so that their 16-byte-aligned
    # body lands aligned), rounded up to 16 bytes
    return (rows * C + 6) // 4 * 4


def traceback_tile(T, C, max_rows=None):
    """The tile the traceback of a (T, C) code plane launches with: the
    most rows (at most T, and at most `max_rows` where given) for which
    two tile buffers fit an H100 block's shared memory, and that memory
    (the kernel's layout). A video's whole plane is one tile up to 29,049
    codes (T=1024 at C <= 28); past that the walk goes through tiles of
    rows from the top down."""
    words = (MAX_BLOCK_SMEM - TRACEBACK_HEADER) // 8 // 4 * 4
    rows = max(1, min(T, (words - 3) // C, max_rows or T))
    return TracebackTile(rows, TRACEBACK_HEADER + 8 * _tile_words(rows, C))


class WideTracebackTile(NamedTuple):
    """The wide traceback's ring: code rows a slot, slots, and the
    launch's dynamic shared memory."""

    rows: int
    stages: int
    smem_bytes: int


# the wide traceback's ring: at most WIDE_TRACEBACK_STAGES slots (the
# kernel takes up to 16), each tile one bulk copy of its rows widened to
# the 16-byte lines around them; the slots follow two mbarriers a slot
WIDE_TRACEBACK_STAGES = 4


def _wide_slot_words(rows, C):
    # rows * C codes and up to 3 words of line on either side, in whole lines
    return (rows * C + 6) // 4 * 4


def _wide_traceback_header(stages):
    return 16 * stages


def wide_traceback_tile(T, C, max_rows=None, stages=WIDE_TRACEBACK_STAGES):
    """The ring the wide traceback (W2) of a (T, C) code plane launches
    with: the most rows a slot (at most T, and at most `max_rows` where
    given) for which `stages` slots fit an H100 block's shared memory;
    no more slots than the plane's shared rows (T - 1) make tiles of;
    and that memory (the kernel's layout). At 342 classes 4 slots of 42
    rows, at 1,024 4 of 14, at 1,577 4 of 9; past 14,521 classes not
    one row fits a slot (the launch raises)."""
    words = (MAX_BLOCK_SMEM - _wide_traceback_header(stages)) // (4 * stages) // 4 * 4
    rows = max(1, min(T, (words - 3) // C, max_rows or T))
    stages = max(1, min(stages, -(-(T - 1) // rows)))
    return WideTracebackTile(rows, stages, _wide_traceback_header(stages)
                             + stages * 4 * _wide_slot_words(rows, C))


def _launch_traceback(bp, lengths, c_last, tile):
    """Checks, then one launch of csrc/hsmm_viterbi.cu's traceback with
    `tile` (a ``traceback_tile``; above 128 classes W2 with a
    ``wide_traceback_tile`` and the log2 of ``code_radix(C)``); returns
    the spans."""
    N, T, C = bp.shape
    name = "hsmm_viterbi_traceback"
    ints = [N, T, C, *tile]
    if C > MAX_CLASSES:
        name = "hsmm_viterbi_traceback_wide"
        ints.append(code_radix(C).bit_length() - 1)
    if tile.smem_bytes > MAX_BLOCK_SMEM:
        raise ValueError("{}: a row of C={} codes does not fit the ring's slot ({} bytes of "
                         "shared memory, past a block's {})".format(name, C, tile.smem_bytes,
                                                                    MAX_BLOCK_SMEM))
    _check_cuda(name, (bp, lengths, c_last), ((N, T, C), (N,), (N,)),
                (torch.int32, torch.int64, torch.int64))
    if C > MAX_CLASSES and bp.data_ptr() % 16:
        raise ValueError("{}: the codes must be 16-byte aligned".format(name))
    spans = torch.empty((N, T), dtype=torch.long, device=bp.device)
    err = _call("hsmm_viterbi", name, [bp, lengths, c_last, spans], ints, bp)
    _raise_on_error(name, err)
    return spans


def hsmm_viterbi_traceback(bp, lengths, c_last):
    """Spans (N, T) int64 from the scan's codes; see ``_traceback_plain``.

    bp (N, T, C) int32 at ``code_radix(C)``; lengths (N,) int64 in [1, T];
    c_last (N,) int64. On CUDA tensors (contiguous) it launches
    csrc/hsmm_viterbi.cu, one block per video walking its codes in shared
    memory, in the tiles ``traceback_tile`` sizes: at C <= 128 its narrow
    instance, above it the wide one (``hsmm_viterbi_traceback_wide``). On
    CPU tensors it runs the plain version."""
    if _device_type(bp) == "cpu":
        return _traceback_plain(bp, lengths, c_last, code_radix(bp.shape[-1]))
    if bp.shape[-1] > MAX_CLASSES:
        return hsmm_viterbi_traceback_wide(bp, lengths, c_last)
    spans = _launch_traceback(bp, lengths, c_last, traceback_tile(*bp.shape[1:]))
    hsmm_viterbi_traceback.launches += 1
    return spans


hsmm_viterbi_traceback.launches = 0


def hsmm_viterbi_traceback_wide(bp, lengths, c_last):
    """``hsmm_viterbi_traceback`` for a DP of C > 128 classes (codes at
    ``code_radix(C)``): W2 on CUDA tensors, one warp a video walking the
    raw codes through a ring of tiles in shared memory that
    ``wide_traceback_tile`` sizes, the radix passed to the launch; the
    plain version on CPU tensors. Raises where a row of C codes does not
    fit a slot of the ring (past 14,521 classes)."""
    if _device_type(bp) == "cpu":
        return _traceback_plain(bp, lengths, c_last, code_radix(bp.shape[-1]))
    if not MAX_CLASSES < bp.shape[-1]:
        raise ValueError("hsmm_viterbi_traceback_wide: C={} <= {}".format(
            bp.shape[-1], MAX_CLASSES))
    spans = _launch_traceback(bp, lengths, c_last, wide_traceback_tile(*bp.shape[1:]))
    hsmm_viterbi_traceback_wide.launches += 1
    return spans


hsmm_viterbi_traceback_wide.launches = 0


def _viterbi_spans(pots: HsmmPotentials, lengths, scan, traceback):
    lengths = _clamped(lengths, pots.emit.device)
    alphas, bp = scan(
        pots.trans, pots.init.contiguous(),
        _durations(pots.lens).contiguous(), pots.emit.contiguous(),
    )
    # the finals stay outside the kernels, as in JAX
    fin = _finals(alphas, lengths, pots.end_mask)
    spans = traceback(bp, lengths, fin.argmax(dim=-1))  # first maximum
    return spans, fin.amax(dim=-1)


def hsmm_viterbi_spans(pots: HsmmPotentials, lengths):
    """Exact Viterbi spans: (spans (B, T) int64, the class at each span
    start and -1 on continuations and past each length; scores (B,)).
    The contract of ``ops.hsmm.hsmm_viterbi`` and JAX's
    ``hsmm_viterbi_pallas``. Both kernels on CUDA tensors (the wide ones
    above 128 classes), their plain versions on CPU tensors."""
    return _viterbi_spans(pots, lengths, hsmm_viterbi_scan, hsmm_viterbi_traceback)


def hsmm_viterbi_spans_plain(pots: HsmmPotentials, lengths):
    """``hsmm_viterbi_spans`` through the plain versions only, on any
    device and dtype (float64 included): the yardstick the kernels are
    held against."""
    return _viterbi_spans(pots, lengths, _viterbi_scan_plain, _traceback_plain)
