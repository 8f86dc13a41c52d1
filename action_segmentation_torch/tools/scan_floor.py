"""The serial floor of the port's scan kernels and of the traceback: the
longest chain of dependent instructions that one step of a scan's time
loop, or one segment of the traceback's walk, hands to the next, worked
out from the compiled code; and the issue floor of the band kernels (K3
and K4), whose duration loops run in every thread of the launch at once.

A scan's T steps run one after another, so no kernel of this design can
take less than T x that chain; the traceback's walk takes one link a
segment, so no walk can take less than the most segments in one video x
its chain. The script reads the SASS of the built libraries (`cuobjdump
-sass`), takes one scan instance's time loop (the innermost loop that
waits on the emission window, `DEPBAR`) and the traceback's walk (the
innermost loop that loads shared memory and stores to global memory), and
builds the loop's dependence graph over registers and predicates (a
guarded write also reads its old value; a shared-memory load depends on
the step's earlier shared store). The chain is the loop's largest cycle
mean over the values it carries from one step to the next, with the
assumed latencies of LATENCY. Beside it, the issue floor: one warp issues
at most one instruction a cycle, and a MUFU takes its quarter of the SM's
16 special-function units for 8 cycles a warp.

The latencies are assumptions for Hopper, not measurements (no profiler
reads them on the card's machine): fixed-latency integer and float
arithmetic 4 cycles, MUFU 20, shared and constant loads 30, a shared load
behind a shared store 4 more. Cycles turn into time at the card's
largest SM clock (`nvidia-smi --query-gpu=clocks.max.sm`), so the floor is
a lower bound.

K4 (csrc/band_grad.cu) has no serial chain across its launch: every
warp runs the same duration loop (the loop of `band_grad_kernel` with no
barrier that holds the terms' MUFU.EX2, one duration an iteration). Its floor is the loop's instructions x Km x the launch's
warps, issued by the SMs' 4 schedulers, one warp-instruction a clock
each. Its wide kernel (`band_grad_wide_kernel`, C > 128) runs the same
loop inside the loop over its run's rows: its duration loop is the
innermost loop that holds the expf, and its floor is the loop's
instructions x Km x the launch's warp-rows (B x groups of 32 classes x
T). Beside the loop, K4's cross-tile sum of lg (`band_grad_tail`): the
partials' bytes, written and then read, at the card's memory rate, and
the serial loads of the block that sums a (video, chunk)'s partials
(each of its threads adds the tiles' partials of ceil(Km x chunk /
threads) columns, one load each, the unrolled loop keeping
TAIL_LOADS_IN_FLIGHT of them in flight at LATENCY's LDG).

K3 (csrc/band_max.cu) has three duration loops, none with a barrier in
it: a start's (the loop that loads dur and G2p and stores the slab's
entry, STS), its twin above the tile (no store), and an output's fold
(the loop of shared loads and maxima). Its instructions a duration are
the loop's over the durations it runs a turn (one STS, FMNMX or LDS
each; the compiler unrolls two of them). Its floor is those instructions x the durations
each loop runs at the launch's shape (the starts of each tile and its
halo, r from Km - 1 down; the outputs' r <= t), over 32 lanes a warp,
issued by the SMs' 4 schedulers.

The wide scans (csrc/hsmm_scan_wide.cu: `wide_cluster_scan_kernel`,
the cluster route, and `wide_grid_scan_kernel`, the grid route, three
instances each; an earlier source's `wide_scan_kernel`, the L2 route of
one block a chain, is read the same way) have no emission window, and
their time loop holds loops of its own (the cluster route's template is
compiled for a cluster of one block and for more, the grid route's for
its table slab in shared memory and not). Their time loop is the
innermost loop that holds a barrier (the alpha row's `BAR.SYNC`, or the
wait on its mbarrier, `SYNCS`) and, whole inside it, a duration loop and
the combine's loops: on the cluster route the loops with no global load
(the table's and the alpha row's shared loads), on the grid route the
loops with 16-byte shared loads (`LDS.128`: the alpha rows, beside the
table's) or shared loads and no global load (their remainders), on the L2
route the loops with a shared load (alpha's, beside the table's `LDG`).
Every other loop inside it that loads is a duration loop (the `LDG` of
dur), or holds no term (the grid route's copy of the alpha rows, its
barrier's spin). A loop holding `MUFU.EX2` is the log semiring's second
pass (the ordered sum), one expf a term; a first pass has one compare a
term (`FMNMX`, or the argmax's `FSETP`). Of each kind of loop (combine or
duration, first pass or sum) the version with the most terms an
iteration (the compiler's unrolled body, not its remainder) gives its
instructions and its chain a term (the loop's largest cycle mean over the
terms of an iteration). A step issues the time loop's instructions
outside its inner loops plus, for each kind, C (combine) or Km
(duration) terms; its chain is the kinds' chains a term times their
terms, one after another (a pass needs the last one's result), without
the barrier's latency, which the SASS does not show. The floor a step is
the larger of the chain and the instructions times the warps each
scheduler issues for at the launch (its blocks over the SMs); a scan's
floor is T steps of it. A thread that owns several classes (the L2 route
past 1,024 classes) or several (chain, class) pairs (the grid route's
blocks past GRID_THREADS pairs) runs them in turn, so its instructions and
its chain a step count that many times. On the grid route a step also
waits at the grid barrier: its floor adds the barrier's time a step where
it is given (`barrier_us`, tools/scan_ab.py's empty-step probe).

Run from the repository root on a machine with the CUDA toolkit:

    python3 -m action_segmentation_torch.tools.scan_floor [--B 18] [--C 19] [--Km 19] [--T 1024] [--segments 720] [--wide-C 342] [--wide-segments 760] [--wide-barrier-us 0] [--sass-dir DIR]

With `--sass-dir`, DIR holds `hsmm_scan.sass`, `hsmm_viterbi.sass`,
`band_grad.sass`, `band_max.sass` and `hsmm_scan_wide.sass` (cuobjdump's
output) and nothing is built. The wide scans' floors are at B chains
(2B for the log scan, the stacked forward and reversed chains) of T
steps, `--wide-C` classes and Km rows, on the route
``hsmm_cuda.wide_scan_instance`` picks for one expanded table (the log
scan's two). `--segments`
is the most segments in one video for the traceback's floor in time, and
`--wide-segments` the same for W2, the wide traceback (the same walk
reader on `traceback_wide_kernel`, whose walk takes two shared loads a
segment), at T and `--wide-C`; W2's floor adds its first tile's arrival,
that tile's bytes at the card's memory rate. B, T, C and Km size the band
kernels' launches (their tiles from `hsmm_cuda.band_grad_tile` and
`band_max_tile`; K4's wide kernel's at `--wide-C` from
`band_grad_wide_tile`). Prints one line per serving instance, one for
the traceback, one for W2, one for K4, one for K4's wide kernel, one for
K3, one per wide instance and route, and a JSON object last.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from action_segmentation_torch.ops import _build
from action_segmentation_torch.ops.hsmm_cuda import (
    H100_SMS,
    MAX_BLOCK_SMEM,
    MAX_BLOCK_THREADS,
    SM_SMEM,
    SM_SMEM_PER_BLOCK,
    BAND_GRAD_WIDE_CLASSES,
    WideScan,
    band_grad_tile,
    band_grad_wide_tile,
    band_max_tile,
    scan_instance,
    wide_scan_instance,
    wide_traceback_tile,
)

# assumed latencies in cycles, by opcode (the part before the first dot)
LATENCY = {"MUFU": 20, "LDS": 30, "LDC": 30, "ULDC": 30, "S2R": 20, "S2UR": 20,
           "SHFL": 30, "LDG": 500, "BRA": 0, "DEPBAR": 0, "LDGDEPBAR": 0, "NOP": 0,
           "WARPSYNC": 0, "BAR": 0}
DEFAULT_LATENCY = 4
STORE_TO_LOAD = 4  # a shared load after the step's shared store
MUFU_ISSUE = 8  # cycles a warp's MUFU holds its quarter's 4 units
NO_DEST = {"STS", "STG", "ST", "STL", "RED", "LDGSTS", "BRA", "EXIT", "DEPBAR",
           "LDGDEPBAR", "BAR", "NOP", "WARPSYNC", "BSYNC", "BSSY", "MEMBAR", "YIELD",
           "CCTL", "ERRBAR"}
SCHEDULERS = 4  # an SM's warp schedulers, one warp-instruction a clock each
H100_BYTES_PER_S = 3.35e12  # the card's memory rate (NVIDIA's data sheet, SXM)
TAIL_LOADS_IN_FLIGHT = 8  # K4's cross-tile sum: its loop's `#pragma unroll 8`
SEMIRINGS = {"max": ("hsmm_scan", 0), "log": ("hsmm_scan", 1), "argmax": ("hsmm_viterbi", 2)}

LINE = re.compile(r"/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
REG = re.compile(r"(?<![\w.])(UR\d+|R\d+|UP\d|P\d)(\.64|\.128)?(?![\w])")


def parse_function(sass, mangled_part):
    """[(address, guard, opcode, operands)] of the function whose mangled
    name holds `mangled_part`."""
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = mangled_part in line.split("Function :")[1]
            continue
        if not inside:
            continue
        m = LINE.search(line)
        if m:
            ops = [o.strip() for o in m.group(4).split(",")] if m.group(4).strip() else []
            out.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), ops))
    return out


def loops(insts, wanted):
    """The bodies of the backward branches whose body `wanted` accepts."""
    found = []
    for i, (addr, _, op, ops) in enumerate(insts):
        if op != "BRA" or not ops:
            continue
        target = int(ops[-1], 16) if ops[-1].startswith("0x") else None
        if target is None or target >= addr:
            continue
        start = next(k for k, ins in enumerate(insts) if ins[0] >= target)
        body = insts[start:i + 1]
        if wanted({ins[2].split(".")[0] for ins in body}):
            found.append(body)
    return found


def innermost_loop(insts, wanted, what):
    """The innermost backward branch whose body `wanted` accepts."""
    found = loops(insts, wanted)
    if not found:
        raise ValueError("no {} found".format(what))
    return min(found, key=len)


def time_loop(insts):
    """A scan's time loop: the innermost one that holds the window's DEPBAR."""
    return innermost_loop(insts, lambda ops: "DEPBAR" in ops, "time loop")


def walk_loop(insts):
    """The traceback's walk: the innermost loop that loads shared memory
    and stores to global memory, with no barrier in it."""
    return innermost_loop(insts, lambda ops: {"LDS", "STG"} <= ops and "BAR" not in ops,
                          "walk loop")


def traceback_floor(sass, kernel="viterbi_traceback_kernel"):
    """(chain cycles, instructions) of one segment of the traceback's walk
    in csrc/hsmm_viterbi.cu's SASS; `kernel` "traceback_wide_kernel" reads
    W2's (two shared loads a segment)."""
    body = walk_loop(parse_function(sass, kernel))
    return chain_cycles(body)[0], sum(1 for ins in body if ins[2] != "NOP")


def traceback_wide_floor(sass):
    """(chain cycles, instructions) of one segment of W2's walk."""
    return traceback_floor(sass, "traceback_wide_kernel")


def wide_first_tile_bytes(T, C):
    """The codes of W2's first tile on a (T, C) plane: the ring's slot
    rows, at most the T - 1 rows the shared walk reads."""
    return 4 * min(wide_traceback_tile(T, C).rows, max(T - 1, 0)) * C


def traceback_wide_floor_ms(chain, segments, first_tile_bytes, clock_mhz):
    """A wide traceback's floor in ms: the longest video's `segments`
    links of `chain` cycles, plus its first tile's arrival, that tile's
    bytes at the card's memory rate (H100_BYTES_PER_S), a lower bound on
    the copy."""
    return segments * chain / clock_mhz * 1e-3 + first_tile_bytes / H100_BYTES_PER_S * 1e3


def duration_loop(insts):
    """K4's duration loop: the loop with no barrier that holds the expf
    of its terms (MUFU.EX2; an integer division's MUFU.RCP does not
    count); where the compiler made several versions of it, the longest."""
    found = [body for body in loops(insts, lambda ops: "MUFU" in ops and "BAR" not in ops)
             if sum(1 for ins in body if ins[2] == "MUFU.EX2") >= 2]
    if not found:
        raise ValueError("no duration loop found")
    return max(found, key=len)


def band_grad_floor(sass):
    """(instructions, MUFU) of one iteration (one duration) of K4's
    duration loop in csrc/band_grad.cu's SASS."""
    body = duration_loop(parse_function(sass, "band_grad_kernel"))
    return (sum(1 for ins in body if ins[2] != "NOP"),
            sum(1 for ins in body if ins[2].startswith("MUFU")))


def band_grad_issue_ms(instructions, B, T, C, Km, clock_mhz, sms=H100_SMS):
    """K4's issue floor in ms: the loop's instructions x Km x the launch's
    warps (B x class chunks x tiles x warps a block), over `sms` SMs of 4
    schedulers."""
    tile = band_grad_tile(B, T, C, Km, sms)
    warps = B * -(-C // max(tile.chunk, 1)) * tile.tiles * -(-tile.threads // 32)
    return instructions * Km * warps / (sms * SCHEDULERS) / clock_mhz * 1e-3


def wide_duration_loop(insts):
    """K4's wide kernel's duration loop: of the innermost loops that hold
    two expf or more (the loop over the run's rows around it holds them
    too), the longest."""
    body = max((b for b in innermost_loops(insts)
                if sum(1 for ins in b if ins[2] == "MUFU.EX2") >= 2), key=len, default=None)
    if body is None:
        raise ValueError("no duration loop found in band_grad_wide_kernel")
    return body


def band_grad_wide_floor(sass):
    """(instructions, MUFU) of one iteration (one duration) of the wide
    kernel's duration loop in csrc/band_grad.cu's SASS."""
    body = wide_duration_loop(parse_function(sass, "band_grad_wide_kernel"))
    return (sum(1 for ins in body if ins[2] != "NOP"),
            sum(1 for ins in body if ins[2].startswith("MUFU")))


def band_grad_wide_issue_ms(instructions, B, T, C, Km, clock_mhz, sms=H100_SMS):
    """The wide kernel's issue floor in ms: the loop's instructions x Km
    x the launch's warp-rows (a warp runs a row of 32 classes at a time:
    B x ceil(C / 32) x T of them), over `sms` SMs of 4 schedulers."""
    warp_rows = B * -(-C // BAND_GRAD_WIDE_CLASSES) * T
    return instructions * Km * warp_rows / (sms * SCHEDULERS) / clock_mhz * 1e-3


def band_grad_tail(B, T, C, Km, clock_mhz, sms=H100_SMS, wide=False):
    """K4's cross-tile sum of lg at a (B, T, C) plane with Km durations,
    in the narrow kernel's tile (``band_grad_tile``: every tile writes a
    partial) or the wide kernel's (``band_grad_wide_tile``: none at one
    run a video). Returns the partials' bytes (`scratch_bytes`), their
    write and read at the card's memory rate (`bytes_ms`), the loads a
    thread of the block that sums a (video, chunk) adds in turn
    (`loads_per_thread`: its ceil(Km x chunk / threads) columns, a load a
    tile each) and their time at LATENCY's LDG with TAIL_LOADS_IN_FLIGHT
    in flight (`serial_ms`), and the two summed (`floor_ms`)."""
    if wide:
        tile = band_grad_wide_tile(B, T, C, Km, sms)
        cols, partials = BAND_GRAD_WIDE_CLASSES, tile.tiles > 1
    else:
        tile = band_grad_tile(B, T, C, Km, sms)
        cols, partials = tile.chunk, True
    scratch = 4 * B * tile.tiles * Km * C if partials and Km else 0
    loads = -(-Km * cols // tile.threads) * tile.tiles if scratch else 0
    bytes_ms = 2 * scratch / H100_BYTES_PER_S * 1e3
    serial_ms = loads * LATENCY["LDG"] / TAIL_LOADS_IN_FLIGHT / clock_mhz * 1e-3
    return {"tiles": tile.tiles, "scratch_bytes": scratch, "bytes_ms": bytes_ms,
            "loads_per_thread": loads, "serial_ms": serial_ms, "floor_ms": bytes_ms + serial_ms}


def innermost_loops(insts):
    """Every loop body (a backward branch's) that holds no other."""
    bodies = loops(insts, lambda ops: True)
    spans = [(body[0][0], body[-1][0]) for body in bodies]
    return [body for body, (a, b) in zip(bodies, spans)
            if not any((a, b) != (c, d) and a <= c and d <= b for c, d in spans)]


def _opcount(body, prefix):
    return sum(1 for ins in body if ins[2].startswith(prefix))


def pair_grad_floor(sass):
    """The pair kernels' loops in csrc/pair_grad.cu's SASS, by function
    (either design: the scalar kernel, one expf a term, as the scalar route
    or an earlier source's only kernel, or the tensor-core kernel). The
    scalar kernel's term loop (of the innermost loops holding
    two MUFU.EX2 or more, the longest): its instructions (no NOP) and MUFU
    an iteration, and instructions a term (a MUFU.EX2 each). The tensor-core kernel's
    product loop (the innermost loop holding DMMA): instructions and DMMA
    an iteration; and its operand loop (the innermost loop holding MUFU.EX2
    and no DMMA, where the compiler kept one): instructions and MUFU an
    iteration."""
    names = sorted({line.split("Function :")[1].strip() for line in sass.splitlines()
                    if "Function :" in line and re.search(r"pair_grad(_scalar)?_kernel", line)})
    out = {}
    for name in names:
        insts = parse_function(sass, name)
        inner = innermost_loops(insts)
        count = lambda body: sum(1 for ins in body if ins[2] != "NOP")  # noqa: E731
        if any(ins[2].startswith("DMMA") for ins in insts):
            mma = min((b for b in inner if _opcount(b, "DMMA")), key=len, default=None)
            ops = max((b for b in inner if _opcount(b, "MUFU.EX2") and not _opcount(b, "DMMA")),
                      key=len, default=None)
            out[name] = {
                "design": "tensor",
                "mma_loop": None if mma is None else {
                    "instructions": count(mma), "dmma": _opcount(mma, "DMMA"),
                    "lds": _opcount(mma, "LDS")},
                "operand_loop": None if ops is None else {
                    "instructions": count(ops), "mufu": _opcount(ops, "MUFU.EX2")},
                "dmma_total": _opcount(insts, "DMMA"), "mufu_total": _opcount(insts, "MUFU.EX2")}
        else:
            body = max((b for b in inner if _opcount(b, "MUFU.EX2") >= 2), key=len,
                       default=None)
            if body is None:
                raise ValueError("no term loop found in " + name)
            mufu = _opcount(body, "MUFU.EX2")
            out[name] = {"design": "scalar", "instructions": count(body), "mufu": mufu,
                         "instructions_per_term": count(body) / mufu}
    if not out:
        raise ValueError("no pair_grad_kernel in the SASS")
    return out


def pair_grad_issue_ms(instructions_per_term, terms, clock_mhz, sms=H100_SMS):
    """The scalar pair kernel's issue floor in ms: its instructions a term
    x the launch's terms over 32 lanes a warp, issued by `sms` SMs of 4
    schedulers."""
    return instructions_per_term * terms / 32 / (sms * SCHEDULERS) / clock_mhz * 1e-3


# K3's duration loops: (name, the body's opcodes it needs, those it must
# not hold, the opcode that marks one duration)
BAND_MAX_LOOPS = (
    ("start", {"LDG", "STS"}, set(), "STS"),  # the span terms stored to the slab
    ("update", {"LDG", "FMNMX"}, {"STS"}, "FMNMX"),  # the starts' durations above the tile
    ("fold", {"LDS", "FMNMX"}, {"STS", "LDG"}, "LDS"),  # the outputs' fold
)


# K3's instances: (name, its template argument in the mangled name)
BAND_MAX_INSTANCES = (("one slab", "band_max_kernelILb0E"), ("slabs", "band_max_kernelILb1E"))


def band_max_floor(sass):
    """{instance: {loop: instructions a duration}} of K3's three duration
    loops in each instance of csrc/band_max.cu's kernel (one slab, or
    several): where the compiler made several versions of a loop
    (unrolled and not; for the first, middle and last slab), those over
    the most durations, their mean. Raises if a loop is missing or holds
    a barrier."""
    return {name: _band_max_loops(parse_function(sass, mangled))
            for name, mangled in BAND_MAX_INSTANCES}


def _band_max_loops(insts):
    bodies = [(body, [ins[2].split(".")[0] for ins in body]) for body in innermost_loops(insts)]
    out = {}
    for name, needs, refuses, mark in BAND_MAX_LOOPS:
        found = [(body, ops) for body, ops in bodies
                 if needs <= set(ops) and not refuses & set(ops)]
        if not found:
            raise ValueError("no {} loop found in band_max_kernel".format(name))
        if any("BAR" in ops for _, ops in found):
            raise ValueError("a barrier in band_max_kernel's {} loop".format(name))
        most = max(ops.count(mark) for _, ops in found)
        rates = [(len(ops) - ops.count("NOP")) / most for _, ops in found
                 if ops.count(mark) == most]
        out[name] = sum(rates) / len(rates)
    return out


def band_max_durations(T, Km, rows):
    """(start, update, fold) durations a (video, class) at K3's tile of
    `rows`: each start of each tile, halo included, runs r from Km - 1
    down to the least that reaches the tile, storing where its output row
    s + r is in the tile (start) and not above it (update); each output t
    folds r <= min(t, Km - 1)."""
    start = update = 0
    for t0 in range(0, T, rows):
        t_end = min(t0 + rows, T)
        for s in range(max(t0 - Km + 1, 0), t_end):
            r_end = max(0, t0 - s)
            r_top = min(Km, t_end - s) - 1
            update += max(0, Km - 1 - max(r_top, r_end - 1))
            start += max(0, r_top - r_end + 1)
    fold = sum(min(t + 1, Km) for t in range(T))
    return start, update, fold


def band_max_issue_ms(floor, B, T, C, Km, clock_mhz, sms=H100_SMS):
    """K3's issue floor in ms: each duration loop's instructions (of the
    instance the tile ``band_max_tile`` picks, in ``band_max_floor``'s
    `floor`) x the durations it runs at this shape (``band_max_durations``)
    x B x C lanes, 32 a warp, over `sms` SMs of 4 schedulers."""
    tile = band_max_tile(B, T, C, Km, sms)
    loops = floor["slabs" if tile.slab < Km else "one slab"]
    counts = band_max_durations(T, Km, tile.rows)
    lanes = sum(loops[name] * n for (name, *_), n in zip(BAND_MAX_LOOPS, counts))
    return B * C * lanes / 32 / (sms * SCHEDULERS) / clock_mhz * 1e-3


# the wide scans' kernels (csrc/hsmm_scan_wide.cu) by route (the L2 route
# an earlier source's, before the grid route), and their instances in the
# Scan enum's order
WIDE_KERNELS = {"cluster": "wide_cluster_scan_kernel", "grid": "wide_grid_scan_kernel",
                "l2": "wide_scan_kernel"}
WIDE_SCANS = ("viterbi", "log", "forward")


def wide_mangled(route, scan, multi=False):
    """The mangled name's part of a wide instance: the kernel's name and
    its template arguments (the cluster route's: the scan, and whether the
    cluster has more than one block; the grid route's: the scan, and
    whether the table slab is in shared memory, `multi`)."""
    name = WIDE_KERNELS[route]
    part = "{}{}ILNS_4ScanE{}E".format(len(name), name, WIDE_SCANS.index(scan))
    return part + ("Lb{}E".format(int(multi)) if route != "l2" else "")


def earlier_l2_launch(C, Km):
    """The launch of an earlier source's L2 route (commits f3ba4a7 to
    73d2b7b: one block a chain of min(C, 1,024) threads, each then
    ceil(C / 1,024) classes in turn), as a WideScan for a chain: its
    double-buffered alpha row, each class's prefix sum and duration argmax
    (4 C words) and the ring's Km * C floats where both fit a block's
    shared memory, else the ring in a global scratch."""
    ring = "shared" if 4 * (4 * C + Km * C) <= MAX_BLOCK_SMEM else "global"
    return WideScan("l2", 1, C, 1, 1, min(MAX_BLOCK_THREADS, 32 * -(-C // 32)), "global", ring,
                    4 * (4 * C + Km * C * (ring == "shared")), 1)


def is_barrier(op):
    """A block's or a cluster's barrier, or an mbarrier's wait (SYNCS)."""
    base = op.split(".")[0]
    return base in ("BAR", "SYNCS") or "CGABAR" in base


def loop_ranges(insts):
    """[(first, last) index] of each loop: a backward branch's target up
    to the last backward branch to it."""
    index = {ins[0]: k for k, ins in enumerate(insts)}
    ends = {}
    for i, (addr, _, op, ops) in enumerate(insts):
        if op != "BRA" or not ops or not ops[-1].startswith("0x"):
            continue
        target = int(ops[-1], 16)
        if target < addr and target in index:
            ends[index[target]] = max(ends.get(index[target], i), i)
    return sorted(ends.items())


def wide_loops(insts, route):
    """(time loop, [(kind, pass, body)]) of a wide scan: the time loop is
    the innermost loop that holds a barrier (or an mbarrier's wait), a
    combine loop and a duration loop, each whole inside it (a wait's retry
    path placed past the loop's end makes a backward branch that overlaps
    it, and is no loop of a step); its innermost loops are "combine" or
    "duration" loops (see the module's docstring), pass "max" or "sum"
    (holding MUFU.EX2), or neither (the alpha row's pushes to the other
    blocks), which count with the rest."""
    ranges = loop_ranges(insts)

    def ops_of(a, b):
        return [ins[2] for ins in insts[a:b + 1]]

    def kind(a, b):
        full = set(ops_of(a, b))
        ops = {op.split(".")[0] for op in full}
        if route == "cluster":
            return "duration" if "LDG" in ops else "combine" if "LDS" in ops else None
        if route == "grid":
            if any(op.startswith("LDS.128") for op in full) or ("LDS" in ops and "LDG" not in ops):
                return "combine"
            return "duration" if "LDG" in ops else None
        return "combine" if "LDS" in ops else "duration" if "LDG" in ops else None

    times = []
    for a, b in ranges:
        inner = [(c, d) for c, d in ranges if a <= c and d <= b and (c, d) != (a, b)]
        has_bar = any(is_barrier(op) for op in ops_of(a, b))
        kinds = {kind(c, d) for c, d in inner}
        if has_bar and {"combine", "duration"} <= kinds:
            times.append((a, b, inner))
    if not times:
        raise ValueError("no wide time loop found")
    a, b, inner = min(times, key=lambda t: t[1] - t[0])
    inner = [(c, d) for c, d in inner  # the innermost only
             if not any((c, d) != (e, f) and c <= e and f <= d for e, f in inner)]
    loops = []
    for c, d in inner:
        k = kind(c, d)
        if k is not None:
            body = insts[c:d + 1]
            loops.append((k, "sum" if "MUFU.EX2" in ops_of(c, d) else "max", body))
    return insts[a:b + 1], loops


def loop_terms(body):
    """Terms an iteration of a wide scan's inner loop: its expf (MUFU.EX2)
    in a sum's loop, else its compares (a max's FMNMX, an argmax's FSETP)."""
    ops = [ins[2] for ins in body]
    ex2 = sum(1 for op in ops if op.startswith("MUFU.EX2"))
    return ex2 or sum(1 for op in ops if op.split(".")[0] in ("FMNMX", "FSETP"))


def wide_step(sass, route, scan, multi=False):
    """{instructions and chain a step by kind} of a wide instance from its
    SASS: per kind and pass ("combine max", "combine sum", "duration max",
    "duration sum"), the instructions and chain cycles a term of its most
    unrolled loop; `rest`, the time loop's instructions outside its inner
    loops."""
    insts = parse_function(sass, wide_mangled(route, scan, multi))
    time_body, loops = wide_loops(insts, route)
    inner = {ins[0] for _, _, body in loops for ins in body}
    rest = sum(1 for ins in time_body if ins[0] not in inner and ins[2] != "NOP")
    per = {}
    for kind, pss, body in loops:
        terms = loop_terms(body)
        if terms == 0:
            continue
        key = "{} {}".format(kind, pss)
        if key in per and per[key]["terms_per_iteration"] >= terms:
            continue
        n = sum(1 for ins in body if ins[2] != "NOP")
        per[key] = {"terms_per_iteration": terms, "instructions_per_term": n / terms,
                    "chain_per_term": chain_cycles(body)[0] / terms,
                    "mufu_per_term": sum(1 for ins in body if ins[2].startswith("MUFU")) / terms}
    if not any(k.startswith("combine") for k in per):
        raise ValueError("no combine loop in {} {}".format(route, scan))
    return {"rest": rest, "loops": per}


def wide_warps_per_scheduler(blocks, threads, smem, sms=H100_SMS):
    """Warps each scheduler of the busiest SM issues for: the launch's
    blocks over `sms` SMs, as many an SM as its shared memory and threads
    let stay resident (a second wave counts as more blocks), 4 schedulers."""
    resident = max(1, min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK),
                          2 * MAX_BLOCK_THREADS // threads))
    per_sm = -(-blocks // sms)
    waves = -(-per_sm // resident)
    warps = min(per_sm, resident) * -(-threads // 32)
    return -(-warps // SCHEDULERS), waves


def wide_floor(step, C, Km, T, N, inst, clock_mhz, sms=H100_SMS, barrier_us=0.0):
    """A wide instance's floor at N chains of T steps on `inst`'s launch:
    per step a thread's instructions (the rest plus each kind's terms: the
    combine's C, the duration loop's Km) and chain (each kind's, in turn),
    each times the classes or pairs a thread owns (the L2 route's ceil(C /
    threads), the grid route's ceil(chains x slab / threads), else 1), the
    warps a scheduler (the cluster route's N x cluster blocks, the L2
    route's N, the grid route's own); the floor a step is the larger of
    the chain and instructions x warps a scheduler, plus on the grid route
    `barrier_us` (the grid barrier's time a step, where measured)."""
    terms = {"combine": C, "duration": Km}
    if inst.route == "grid":
        per, blocks = -(-inst.chains * inst.slab // inst.threads), inst.blocks
    else:
        per, blocks = -(-inst.slab // inst.threads), N * inst.cluster
    issue = per * (step["rest"] + sum(v["instructions_per_term"] * terms[k.split()[0]]
                                      for k, v in step["loops"].items()))
    chain = per * sum(v["chain_per_term"] * terms[k.split()[0]]
                      for k, v in step["loops"].items())
    mufu = per * sum(v["mufu_per_term"] * terms[k.split()[0]] for k, v in step["loops"].items())
    per_sched, waves = wide_warps_per_scheduler(blocks, inst.threads, inst.smem_bytes, sms)
    floor = max(chain, issue * per_sched)
    barrier = barrier_us if inst.route == "grid" else 0.0
    return {"route": inst.route, "cluster": inst.cluster, "slab": inst.slab,
            "chains_per_block": inst.chains, "blocks": blocks,
            "threads": inst.threads, "classes_per_thread": per, "chains": N,
            "instructions_per_step": issue,
            "chain_cycles_per_step": chain, "mufu_per_step": mufu,
            "warps_per_scheduler": per_sched, "waves": waves, "barrier_us_per_step": barrier,
            "floor_us_per_step": waves * floor / clock_mhz + barrier,
            "floor_ms": T * (waves * floor / clock_mhz + barrier) * 1e-3,
            "bound_by": "chain" if chain >= issue * per_sched else "issue"}


def wide_floors(sass, C, Km, T, B, clock_mhz, sms=H100_SMS, earlier=False, barrier_us=0.0):
    """{"<scan> <route>": floor} of each wide instance at B chains of one
    expanded table (the log scan's 2B stacked chains of its two) on the
    route ``wide_scan_instance`` picks, with the grid route's barrier
    `barrier_us` a step; with `earlier`, an earlier source's L2 route
    alone (``earlier_l2_launch``)."""
    out = {}
    for scan in WIDE_SCANS:
        N = 2 * B if scan == "log" else B
        inst = earlier_l2_launch(C, Km) if earlier else wide_scan_instance(C, Km, N, B, sms)
        multi = inst.cluster > 1 if inst.route == "cluster" else inst.table == "shared"
        step = wide_step(sass, inst.route, scan, multi=multi)
        out["{} {}".format(scan, inst.route)] = dict(
            wide_floor(step, C, Km, T, N, inst, clock_mhz, sms, barrier_us), step=step)
    return out


def regs(operand, width_hint=1):
    names = []
    for m in REG.finditer(operand):
        name, width = m.group(1), m.group(2)
        n = {".64": 2, ".128": 4}.get(width, width_hint)
        if name.startswith("R") and n > 1:
            base = int(name[1:])
            names += ["R{}".format(base + k) for k in range(n)]
        else:
            names.append(name)
    return names


def dests_and_sources(guard, op, ops):
    base = op.split(".")[0]
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    srcs = regs(guard)
    dests = []
    if base in NO_DEST or not ops:
        for o in ops:
            srcs += regs(o)
        return dests, srcs
    dests = regs(ops[0], width)
    rest = ops[1:]
    if rest and re.fullmatch(r"(P\d|PT|UP\d|UPT)", rest[0]):
        dests += regs(rest[0])
        rest = rest[1:]
    for o in rest:
        srcs += regs(o)
    if guard:  # a guarded write may keep the old value
        srcs += dests
    return dests, srcs


def chain_cycles(body):
    """(largest cycle mean of the loop-carried graph, its carried values)."""
    insts = [dests_and_sources(g, op, ops) + (op,) for _, g, op, ops in body]
    written, read_first = set(), set()  # values a step takes from the one before
    for dests, srcs, _ in insts:
        read_first |= set(srcs) - written
        written |= set(dests)
    carried = sorted(read_first & written)
    lat = [LATENCY.get(op.split(".")[0], DEFAULT_LATENCY) for _, _, op in insts]
    edges = {}
    for a in carried:  # longest path from a's value at the step's start
        ready = {a: 0.0}
        last_store = None
        for i, (dests, srcs, op) in enumerate(insts):
            t = max((ready[s] for s in srcs if s in ready), default=None)
            if op.startswith("LDS") and last_store is not None:
                t = last_store if t is None else max(t, last_store)
            if t is None:
                for d in dests:
                    ready.pop(d, None)
                continue
            done = t + lat[i]
            if op.startswith("STS"):
                last_store = t + STORE_TO_LOAD
            for d in dests:
                ready[d] = done
        for b in carried:
            if b in ready:
                edges[(a, b)] = ready[b]
    # Karp's largest cycle mean
    nodes = carried
    n = len(nodes)
    neg = float("-inf")
    D = [{v: 0.0 for v in nodes}]
    for k in range(1, n + 1):
        Dk = {v: neg for v in nodes}
        for (a, b), w in edges.items():
            if D[k - 1][a] > neg and D[k - 1][a] + w > Dk[b]:
                Dk[b] = D[k - 1][a] + w
        D.append(Dk)
    best = neg
    for v in nodes:
        if D[n][v] == neg:
            continue
        worst = min((D[n][v] - D[k][v]) / (n - k) for k in range(n) if D[k][v] > neg)
        best = max(best, worst)
    return best, len(carried)


def built_sass(lib):
    """cuobjdump's SASS of csrc/<lib>.cu's library, building it first."""
    _build.build([lib])
    return library_sass(_build.library_path(lib))


def library_sass(so):
    """cuobjdump's SASS of the built library `so`."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump) if cuobjdump.exists() else "cuobjdump", "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout


def max_sm_clock_mhz():
    """The card's largest SM clock, from nvidia-smi."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--B", type=int, default=18)
    parser.add_argument("--C", type=int, default=19)
    parser.add_argument("--Km", type=int, default=19)
    parser.add_argument("--T", type=int, default=1024)
    parser.add_argument("--segments", type=int, default=None,
                        help="the most segments in one video, for the traceback's floor in time")
    parser.add_argument("--wide-segments", type=int, default=None,
                        help="the most segments in one video at --wide-C and --T, for W2's "
                             "floor in time")
    parser.add_argument("--wide-C", type=int, default=342,
                        help="the wide scans' classes (their B, T and Km are the band kernels')")
    parser.add_argument("--wide-barrier-us", type=float, default=0.0,
                        help="the grid route's barrier a step (tools/scan_ab.py's empty-step "
                             "probe), added to its floor")
    parser.add_argument("--sass-dir", type=Path, default=None)
    parser.add_argument("--clock-mhz", type=float, default=None,
                        help="SM clock for the floor in time (default: nvidia-smi's max)")
    args = parser.parse_args()

    sass = {}
    for lib in ("hsmm_scan", "hsmm_viterbi", "band_grad", "band_max", "hsmm_scan_wide"):
        if args.sass_dir is not None:
            sass[lib] = (args.sass_dir / (lib + ".sass")).read_text()
        else:
            sass[lib] = built_sass(lib)
    clock = args.clock_mhz or max_sm_clock_mhz()

    inst = scan_instance(args.C, args.Km)
    results = {}
    for name, (lib, code) in SEMIRINGS.items():
        prefix = "_ZN9hsmm_scan11scan_kernelILNS_8SemiringE{}ELi{}ELi{}ELb{}E".format(
            code, inst.warps, inst.row, inst.tail)
        body = time_loop(parse_function(sass[lib], prefix))
        chain, n_carried = chain_cycles(body)
        issue = sum(1 for ins in body if ins[2] != "NOP")
        mufu = sum(1 for ins in body if ins[2].startswith("MUFU"))
        results[name] = {
            "instance": "scan_kernel<{}, {} warps, row {}, tail {}>".format(
                name, inst.warps, inst.row, inst.tail),
            "chain_cycles": chain, "issue_cycles": issue, "mufu": mufu,
            "mufu_cycles": MUFU_ISSUE * mufu, "carried_values": n_carried,
            "chain_us_per_step": chain / clock, "issue_us_per_step": issue / clock,
            "chain_floor_ms": args.T * chain / clock * 1e-3,
            "issue_floor_ms": args.T * issue / clock * 1e-3,
        }
        r = results[name]
        print("{}: chain {:.0f} cycles a step ({:.4f} us, T={} -> {:.4f} ms); {} instructions "
              "a step ({:.4f} us -> {:.4f} ms); {} MUFU ({} cycles)".format(
                  r["instance"], chain, r["chain_us_per_step"], args.T, r["chain_floor_ms"],
                  issue, r["issue_us_per_step"], r["issue_floor_ms"], mufu, r["mufu_cycles"]))
    chain, issue = traceback_floor(sass["hsmm_viterbi"])
    tb = {"chain_cycles": chain, "issue_cycles": issue,
          "chain_us_per_segment": chain / clock, "issue_us_per_segment": issue / clock}
    line = "traceback walk: chain {:.0f} cycles a segment ({:.5f} us); {} instructions".format(
        chain, tb["chain_us_per_segment"], issue)
    if args.segments:
        tb["chain_floor_ms"] = args.segments * chain / clock * 1e-3
        line += "; {} segments -> {:.5f} ms".format(args.segments, tb["chain_floor_ms"])
    print(line)
    chain, issue = traceback_wide_floor(sass["hsmm_viterbi"])
    tbw = {"chain_cycles": chain, "issue_cycles": issue,
           "chain_us_per_segment": chain / clock, "issue_us_per_segment": issue / clock,
           "tile": wide_traceback_tile(args.T, args.wide_C)._asdict()}
    line = ("traceback wide walk (W2): chain {:.0f} cycles a segment ({:.5f} us); {} "
            "instructions; ring of {} slots of {} rows at T={} C={}").format(
                chain, tbw["chain_us_per_segment"], issue, tbw["tile"]["stages"],
                tbw["tile"]["rows"], args.T, args.wide_C)
    if args.wide_segments:
        tbw["floor_ms"] = traceback_wide_floor_ms(
            chain, args.wide_segments, wide_first_tile_bytes(args.T, args.wide_C), clock)
        line += "; {} segments -> {:.5f} ms".format(args.wide_segments, tbw["floor_ms"])
    print(line)
    insts, mufu = band_grad_floor(sass["band_grad"])
    bg = {"instructions_per_duration": insts, "mufu_per_duration": mufu, "B": args.B,
          "tile": band_grad_tile(args.B, args.T, args.C, args.Km)._asdict(),
          "issue_floor_ms": band_grad_issue_ms(insts, args.B, args.T, args.C, args.Km, clock)}
    print("band grad duration loop: {} instructions ({} MUFU) a duration; B={} T={} C={} Km={} "
          "-> issue floor {:.5f} ms".format(insts, mufu, args.B, args.T, args.C, args.Km,
                                            bg["issue_floor_ms"]))
    bg["tail"] = band_grad_tail(args.B, args.T, args.C, args.Km, clock)
    print("band grad cross-tile sum: {}".format(json.dumps(bg["tail"])))
    insts, mufu = band_grad_wide_floor(sass["band_grad"])
    bgw = {"instructions_per_duration": insts, "mufu_per_duration": mufu, "B": args.B,
           "C": args.wide_C, "tile": band_grad_wide_tile(args.B, args.T, args.wide_C,
                                                         args.Km)._asdict(),
           "issue_floor_ms": band_grad_wide_issue_ms(insts, args.B, args.T, args.wide_C,
                                                     args.Km, clock),
           "tail": band_grad_tail(args.B, args.T, args.wide_C, args.Km, clock, wide=True),
           "narrow_tail": band_grad_tail(args.B, args.T, args.wide_C, args.Km, clock)}
    print("band grad wide duration loop: {} instructions ({} MUFU) a duration; B={} T={} C={} "
          "Km={} -> issue floor {:.5f} ms; cross-tile sum {} (the narrow kernel's tile: "
          "{})".format(insts, mufu, args.B, args.T, args.wide_C, args.Km, bgw["issue_floor_ms"],
                       json.dumps(bgw["tail"]), json.dumps(bgw["narrow_tail"])))
    bm_loops = band_max_floor(sass["band_max"])
    bm = {"instructions_per_duration": bm_loops, "B": args.B,
          "tile": band_max_tile(args.B, args.T, args.C, args.Km)._asdict(),
          "issue_floor_ms": band_max_issue_ms(bm_loops, args.B, args.T, args.C, args.Km, clock)}
    print("band max duration loops (no barrier), instructions a duration: {}; B={} T={} C={} "
          "Km={} -> issue floor {:.5f} ms".format(
              "; ".join("{}: {}".format(inst, ", ".join(
                  "{} {:.2f}".format(k, v) for k, v in loops.items()))
                  for inst, loops in bm_loops.items()),
              args.B, args.T, args.C, args.Km, bm["issue_floor_ms"]))
    wide = wide_floors(sass["hsmm_scan_wide"], args.wide_C, args.Km, args.T, args.B, clock,
                       barrier_us=args.wide_barrier_us)
    for name, w in wide.items():
        print("wide {} (cluster {}, slab {}, {} chains a block, {} blocks of {} threads), {} "
              "chains: {:.0f} instructions a step "
              "({:.0f} MUFU), chain {:.0f} cycles, {} warps a scheduler, {} wave(s), barrier {} "
              "us -> floor {:.4f} us a step, T={} C={} Km={} -> {:.4f} ms ({}); a term: {}".format(
                  name, w["cluster"], w["slab"], w["chains_per_block"], w["blocks"], w["threads"],
                  w["chains"],
                  w["instructions_per_step"], w["mufu_per_step"], w["chain_cycles_per_step"],
                  w["warps_per_scheduler"], w["waves"], w["barrier_us_per_step"],
                  w["floor_us_per_step"], args.T,
                  args.wide_C, args.Km, w["floor_ms"], w["bound_by"],
                  "; ".join("{} {:.2f} instructions, chain {:.2f}".format(
                      k, v["instructions_per_term"], v["chain_per_term"])
                      for k, v in w["step"]["loops"].items())))
    print(json.dumps({"scan_floor": results, "traceback_floor": tb,
                      "traceback_wide_floor": tbw, "band_grad_floor": bg,
                      "band_grad_wide_floor": bgw,
                      "band_max_floor": bm, "wide_floor": wide, "wide_C": args.wide_C,
                      "C": args.C, "Km": args.Km, "T": args.T, "clock_mhz": clock}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
