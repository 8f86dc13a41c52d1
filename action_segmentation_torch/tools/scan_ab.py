"""Time the port's scan kernels, the traceback and the band gradient (K4)
against an earlier version of their sources on one card, in turns, with
the SM clock read while they run.

The earlier sources are a directory holding ``hsmm_scan.cu`` and
``hsmm_viterbi.cu`` (and any header they include), ``band_grad.cu`` for
``--kernels band_grad`` or ``band_max.cu`` for ``--kernels band_max``,
for example a commit's files from ``git show
<commit>:action_segmentation_torch/csrc/<file>``, written into a
directory that .gitignore lists. Their scan entry points take the
wrapper's instance, as the current ones do; their traceback takes the
tile ``traceback_tile`` sizes (rows, smem), the staged traceback's
interface, and so does their wide traceback (one rule for both, before
W2's ring); their band
gradient is the two-launch form before
the tile (pointers to qg, sa, st, lg and a (B, blocks, Km, C) scratch
sized by ``hsmm_band_grad_blocks``; B, T, T2, C, Km) or the current
one (told apart by that export); their band max
the form before the tile (pointers to G1, G2p, dur, fm; B, T, T2, C,
Km). Run from the repository root on a machine with a CUDA card:

    python3 -m action_segmentation_torch.tools.scan_ab --old_csrc OLD_DIR [--kernels all|scans|traceback|band_grad|band_max|wide] [--step0] [--out ab.json]

For example, K4 against the source before its wide kernel:

    mkdir -p _archive/k4_old && git show 39d6789:action_segmentation_torch/csrc/band_grad.cu > _archive/k4_old/band_grad.cu
    python3 -m action_segmentation_torch.tools.scan_ab --old_csrc _archive/k4_old --kernels band_grad

Both versions build with the port's nvcc flags. For each shape and scan
(the max gamma scan, the log scan with alphas, the forward-only log scan,
the backpointer scan) it checks that the two versions' outputs are equal
(the log scans of a source that folds their carry, whose header names
``kFold``, write offsets too: each version's log scans are then held
equal to the plain scan with or without the fold, ``hc._scan_plain``),
then times them with CUDA events in the order old, new, new, old, each
window about `--window_ms` long, and prints ms and us per step. The
shapes are chip_smoke.py's kernel cases, a CrossTask fit batch (B=5,
T=1,056, C=20), two warps a chain (C=33, 48) and
the shared-memory tail's (Km past the carry's 24 register rows), and three
of them on centred emissions, as the model's partition takes them. It also
times the max gamma scan and the backpointer scan at one common chain count
(18 and 36 chains), and prints each log instance's time loop read from
both versions' SASS (instructions, branches and chain cycles a step).

The traceback is timed the same way, but from a CUDA graph of the
launches replayed (no host time between them), on the codes the current
backpointer scan writes, at the serving shape, K=1, C=128, T=12,000 and the
global-memory tail's shape (C=1, Km=28,900, T=64), with the spans held
equal; it prints ms, the segments (all videos and the longest video's)
and us a segment of the longest video's walk, which sets the time. Above
128 classes the wide traceback (W2; the earlier one from ``git show
b8d2282:action_segmentation_torch/csrc/hsmm_viterbi.cu``, with the
``hsmm_scan_core.cuh`` it includes) at the S6 shape (18 videos of 1,024
frames at C = 342, K = 20, lengths drawn as chip_smoke.py's phase 4i
draws them), C = 129, 664 and 1,024, and C = 342 at T = 12,000 (B = 2,
lengths 12,000 and 7,001), on the wide scan's codes, with each version's
floor from its SASS (``scan_floor.traceback_wide_floor``: the longest
video's segments x the walk's chain, plus the first tile's bytes at the
card's memory rate). At the S6 shape it also splits each version's time:
the staging stream alone (the same lengths, every code a span of one
tile, so the walk visits every tile in one segment each), the walk alone
(a plane of 84 rows, one earlier tile, less its one-segment twin, as
cycles a segment), and a copy probe (one block a video copying tiles of
the earlier and of W2's rows by cp.async.bulk one after another: bytes a
us through one SM); then W2's ring at 2, 3, 4, 6 and 8 slots, in turns.
With ``--step0`` only the earlier wide traceback runs (the wide shapes,
its floor, its split and the probe).

The band gradient (``--kernels band_grad``, never with the others) is
timed from replayed CUDA graphs too, old, new, new, old, and each version
also launched one by one, at the serving shape (first, the earlier
kernel alone both ways), a CrossTask fit batch (B=5, T=1,056, C=20,
K=20), T=12,000 (B=2), C=128 (B=4), Km=100 and, past 128 classes, where
the current wrapper takes the wide kernel (``hsmm_band_grad_wide`` in the
tile ``band_grad_wide_tile`` sizes) and the earlier source its one kernel
(in the tile ``band_grad_tile`` sizes), at B=18, T=1,024, K=20 over 342
(the S6 shape), 664 and 1,577 classes and at T=12,000 (B=2) over 342, on
the band inputs the current log scan gives. It checks that wherever qg,
sa or st differ between the versions the new one equals the plain
version's, that the new lg is the same in two runs and within rtol 1e-5
/ atol 1e-4 of the plain version (equal to the earlier lg where the
narrow tile keeps its 512 // C rows, or where the earlier source takes
the current interface, up to 128 classes), and prints the new tile, each
version's lg scratch (the partials' bytes) beside the (B, T, C) plane's,
its issue floor and its cross-tile sum's floor (``scan_floor``), each
version's entries of qg, sa and st that differ from the plain version's
(and how many of those the plain version holds as denormal), and each
version's duration loop from the SASS (the new narrow and wide kernels'
both), counted by opcode (FFMA, FADD, MUFU, ...). The earlier source takes
the current narrow interface with or without the chunk (its text says).
At the wide shapes it also times the current wide
kernel in the rule's tile beside tiles of other run counts a video
(``BAND_GRAD_RUNS``), in turns from replayed graphs, lg held to the plain
version's in each (a finding).
With ``--step0`` only the earlier kernel runs: alone at the wide shapes
(its outputs held to the plain version's, its scratch and floors), and
at the S6 shape and at 1,577 classes beside scratch builds of its source
that each cut one part (``BAND_GRAD_CUTS``: the last block's sum over
the tiles, the partials' stores, the stop mass's recomputed expf, and
the first two together), all in turns from replayed graphs (no output
check for a cut build).

The band max (``--kernels band_max``, never with the others) starts
with step 0: the earlier kernel alone at the serving shape, from a
replayed CUDA graph of 50 launches and launched one by one (raw
launches, outputs made once), then through the earlier wrapper's code
(checks, the output's allocation, the ctypes call) one by one and from a
graph, and that wrapper's host time a call. Then old, new, new, old
from replayed graphs, and each version launched one by one, at the
serving shape, a synthetic decode batch (B=18, lengths 20-1,024 padded
to the 1,056 bucket), T=12,000 (B=2), C=128 (B=4), Km=100 and K=1, on
the band inputs the current max gamma scan gives; fm must be equal
between the versions and to the plain version's, and it prints the new
tile. Last, at shapes where ``band_max_tile``'s halo share changes its
pick, the new kernel in that tile against the tile of the rows that
count warps alone, rule, warps, warps, rule from graphs, fm equal to
the plain version's in both.

The wide scans (``--kernels wide``, never with the others) take an
earlier ``hsmm_scan_wide.cu`` of the current interface (the cluster and
grid routes, from commit 39d6789's source on; an earlier source is
refused: its library lacks ``hsmm_wide_grid_barrier``), whose log scans
fold where its library exports ``hsmm_wide_fold_steps`` (for example
``git show e050508:action_segmentation_torch/csrc/hsmm_scan_wide.cu``,
which does not). At the S6 shape and at B = 18, T = 1,024, C = 1,577,
K = 20, each version's log and forward scans on the first 128 frames
are held equal to the plain scan with or without the fold as the
version computes it (offsets included), the max scans equal across the
versions, then old, new, new, old with CUDA events on the route
``wide_scan_instance`` picks (the max and forward scans on 18 chains of
one expanded table, the log scan on the 36 stacked chains of two); and
K4 wide on each version's band inputs (one chunk a video where the
version does not fold, chunks of 16 rows where it does), qg, sa and st
equal to the plain version's, old, new, new, old from replayed graphs.
About 3 minutes of command time.

A thread reads the SM clock through NVML every 5 ms; each result lists
the readings taken inside its timed windows, old and new apart. Prints the
card's name and power limit first.
"""

import argparse
import collections
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from action_segmentation_torch.ops import _build
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops.distributions import (
    gaussian_emission_log_probs,
    initial_log_probs,
    poisson_length_log_probs,
    transition_log_probs,
)
from action_segmentation_torch.ops.hsmm import HsmmPotentials, _durations, _finals
from action_segmentation_torch.ops.hsmm_grad import _log_partition, centre_emissions
from action_segmentation_torch.tools.scan_floor import (
    built_sass,
    duration_loop,
    band_grad_floor,
    band_grad_issue_ms,
    band_grad_tail,
    band_grad_wide_floor,
    band_grad_wide_issue_ms,
    chain_cycles,
    library_sass,
    max_sm_clock_mhz,
    parse_function,
    time_loop,
    traceback_wide_floor,
    traceback_wide_floor_ms,
    wide_duration_loop,
    wide_first_tile_bytes,
)
from action_segmentation_torch.utils.misc import host_ms

SOURCES = ("hsmm_scan", "hsmm_viterbi")
D = 300  # feature width of the serving shape
# (name, B, T, C, K, lengths): K the longest span, Km = K - 1 rows
SHAPES = [
    ("serving", 18, 1024, 19, 20, None),
    ("crosstask fit batch", 5, 1056, 20, 20, [1056, 1001, 900, 808, 612]),
    ("ragged", 18, 1056, 19, 20, "ragged"),
    ("C=128", 4, 1024, 128, 20, None),
    ("K=1", 18, 1024, 19, 1, None),
    ("T=12000", 2, 12000, 19, 20, [12000, 7001]),
    ("C=33", 8, 1024, 33, 20, None),
    ("C=48", 8, 1024, 48, 20, None),
    # the model's path: the same draws centred frame by frame, as the loss and
    # segment_with_marginals give the log scans (their per-class fold then
    # all but idle)
    ("serving, centred", 18, 1024, 19, 20, None),
    ("C=48, centred", 8, 1024, 48, 20, None),
    ("tail Km=25, centred", 18, 1024, 19, 26, None),
    # the shared-memory tail: one row past the carry's 24 registers, and more
    ("tail Km=25", 18, 1024, 19, 26, None),
    ("tail Km=64", 18, 1024, 19, 65, None),
    ("tail Km=100", 18, 1024, 19, 101, None),
    ("tail C=33 Km=25", 8, 1024, 33, 26, None),
    ("tail C=128 Km=100", 4, 1024, 128, 101, None),
    # a tail whose durations do not fit beside it: read from global memory
    ("global tail C=1", 2, 64, 1, 28901, None),
]
# the traceback's shapes: (name, B, T, C, K, lengths); above 128 classes
# W2, the wide traceback, on the wide backpointer scan's codes ("phase 4i":
# lengths drawn as chip_smoke.py's phase 4i draws the S6 shape's, uniform
# in [1, T] with the first T and the second 1)
TRACEBACK_SHAPES = [
    ("serving", 18, 1024, 19, 20, None),
    ("K=1", 18, 1024, 19, 1, None),
    ("C=128", 4, 1024, 128, 20, None),
    ("T=12000", 2, 12000, 19, 20, [12000, 7001]),
    ("global tail C=1", 2, 64, 1, 28901, None),
    ("wide S6", 18, 1024, 342, 20, "phase 4i"),
    ("wide C=129", 18, 1024, 129, 20, None),
    ("wide C=664", 18, 1024, 664, 20, None),
    ("wide C=1024", 18, 1024, 1024, 20, None),
    ("wide T=12000", 2, 12000, 342, 20, [12000, 7001]),  # a plane of 16 MB a video
]
# W2's ring at the S6 shape: the rule's slot count against these
WIDE_TRACEBACK_RING_STAGES = (2, 3, 4, 6, 8)
# W2's split (step 0 and after): the walk alone on a plane that fits one of
# the earlier kernel's tiles (84 rows at C = 342)
WALK_T = 84
# the band gradient's shapes: (name, B, T, C, K, lengths)
BAND_GRAD_SHAPES = [
    ("serving", 18, 1024, 19, 20, None),
    ("crosstask fit batch", 5, 1056, 20, 20, [1056, 1001, 900, 808, 612]),
    ("T=12000", 2, 12000, 19, 20, [12000, 7001]),
    ("C=128", 4, 1024, 128, 20, None),
    ("Km=100", 18, 1024, 19, 101, None),
    ("wide S6 C=342", 18, 1024, 342, 20, None),
    ("wide C=664", 18, 1024, 664, 20, None),
    ("wide C=1577", 18, 1024, 1577, 20, None),
    ("wide T=12000 C=342", 2, 12000, 342, 20, [12000, 7001]),
]
# step 0's split of the earlier K4 at these shapes: scratch builds of its
# source, each with one part cut (an exact text of it replaced)
BAND_GRAD_SPLIT_SHAPES = ("wide S6 C=342", "wide C=1577")
# the current wide kernel at these shapes in other run counts than its
# rule's, in turns beside it (a finding)
BAND_GRAD_RUNS = {"wide S6 C=342": (2, 4, 6, 8, 10, 12, 16, 24, 32),
                  "wide C=664": (1, 2, 4, 6, 9, 11, 16),
                  "wide C=1577": (1, 2, 4, 8, 12, 16, 24, 41),
                  "wide T=12000 C=342": (24, 96, 144, 192)}
BAND_GRAD_CUTS = {
    # the last block's sum over the tiles (the ticket stays)
    "no tail sum": [("  if (!last) return;\n", "  return;\n")],
    # the partials' stores (the slab's pair sums stay: a store never taken)
    "no partial writes": [("if (c0 + kc < C) part[", "if (c0 + kc < C && sum == -1.f) part[")],
    # the stop mass's recomputed expf (its load and adds stay)
    "no stop expf": [("stop = __fadd_rn(stop, expf(g1m[o1 - rc] + (d + g2_here)));",
                      "stop = __fadd_rn(stop, g1m[o1 - rc] + (d + g2_here));")],
}
BAND_GRAD_CUTS["loop alone"] = BAND_GRAD_CUTS["no tail sum"] + BAND_GRAD_CUTS["no partial writes"]
# the band max's shapes: (name, B, T, C, K, lengths)
BAND_MAX_SHAPES = [
    ("serving", 18, 1024, 19, 20, None),
    ("synthetic decode batch", 18, 1056, 19, 20, "synthetic"),
    ("T=12000", 2, 12000, 19, 20, [12000, 7001]),
    ("C=128", 4, 1024, 128, 20, None),
    ("Km=100", 18, 1024, 19, 101, None),
    ("K=1", 18, 1024, 19, 1, None),
]
# shapes where band_max_tile's halo share moves its pick off the rows that
# count warps alone (K4's rule without its thread minimum)
BAND_MAX_RULE_SHAPES = [
    ("T=12000", 2, 12000, 19, 20, [12000, 7001]),
    ("B=9", 9, 1024, 19, 20, None),
    ("C=48", 18, 1024, 48, 20, None),
]
# (scan, symbol, outputs: "g" gamma, "a" alphas, "b" codes; a source whose
# wide log scans fold also writes "o" offsets after them)
WIDE_SCANS = [("viterbi", "hsmm_wide_viterbi_scan", "ab"),
              ("log", "hsmm_wide_log_scan", "ga"),
              ("forward", "hsmm_wide_forward_scan", "a")]
# the wide scans and K4 wide against an earlier source: (name, B, T, C, K);
# each version's log and forward scans held to the plain scan, with or
# without the fold, on the first WIDE_CHECK_T frames
WIDE_SHAPES = [("S6 C=342", 18, 1024, 342, 20), ("timed C=1577", 18, 1024, 1577, 20)]
WIDE_CHECK_T = 128
N_GRAPH = 50  # step 0's launches in one graph
RTOL, ATOL = 1e-5, 1e-4
# (scan, symbol, library, outputs: "g" gamma, "a" alphas, "b" codes, "-" none;
# a source whose log scans fold also writes "o" offsets after them)
SCANS = [
    ("max", "hsmm_gamma_scan_max", "hsmm_scan", "g-"),
    ("log", "hsmm_gamma_scan_log", "hsmm_scan", "ga"),
    ("forward", "hsmm_forward_scan_log", "hsmm_scan", "a"),
    ("viterbi", "hsmm_viterbi_scan", "hsmm_viterbi", "ab"),
]


def folds(csrc):
    """True where the scan template in `csrc` folds the log scans' carry
    (and so takes their offsets output)."""
    header = csrc / "hsmm_scan_core.cuh"
    return header.exists() and "kFold" in header.read_text()


def wide_folds(lib):
    """True where the wide scans' library `lib` folds the log scans' carry
    (it exports ``hsmm_wide_fold_steps``; its log scans then take their
    offsets output). Raises for a library of the earlier L2 route."""
    if not hasattr(lib, "hsmm_wide_grid_barrier"):
        raise RuntimeError("the earlier hsmm_scan_wide.cu is not of the current interface (the "
                           "cluster and grid routes, from commit 39d6789's source on)")
    if not hasattr(lib, "hsmm_wide_fold_steps"):
        return False
    steps = ctypes.c_int.in_dll(lib, "hsmm_wide_fold_steps").value
    if steps != hc.SCAN_FOLD:
        raise RuntimeError("the library folds every {} steps, not {}".format(steps, hc.SCAN_FOLD))
    return True


def wide_kind(scan, kind, folded):
    """A wide scan's outputs in a version: the offsets after the log scans'
    planes where its source folds."""
    return kind + "o" if folded and scan != "viterbi" else kind


class SmClock:
    """The card's SM clock in MHz through NVML, read every `period` s on a
    thread: (perf_counter, MHz) pairs. No readings if NVML does not load."""

    def __init__(self, index=0, period=0.005):
        self.samples, self.period = [], period
        self._stop = threading.Event()
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
                    index, ctypes.byref(handle)):
                raise OSError("NVML did not start")
            self._read = lambda out: nvml.nvmlDeviceGetClockInfo(handle, 1, ctypes.byref(out))
        except OSError as e:
            print("scan_ab: SM clock not read ({})".format(e), flush=True)
            self._read = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        mhz = ctypes.c_uint()
        while not self._stop.wait(self.period):
            if self._read(mhz) == 0:  # NVML_CLOCK_SM
                self.samples.append((time.perf_counter(), mhz.value))

    def __enter__(self):
        if self._read is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def within(self, windows):
        return [m for t, m in self.samples if any(a <= t <= b for a, b in windows)]


def clock_summary(mhz):
    if not mhz:
        return {"n": 0}
    return {"n": len(mhz), "min": min(mhz), "median": statistics.median(mhz), "max": max(mhz)}


# the log scans' instances whose step loops ``step_loop_readings`` reads:
# (warps, trans row registers, tail)
LOG_INSTANCES = ((1, 24, False), (1, 32, False), (2, 0, False), (4, 0, False), (1, 24, True),
                 (2, 0, True))


def step_loop_readings(old_sass, new_sass):
    """For each log-scan instance, each version's time loop from its SASS
    (``scan_floor.time_loop``: the innermost loop holding the emission
    window's DEPBAR, a runtime loop inside it counted once): instructions
    (no NOP), branches and the dependent chain's cycles a step."""
    out = []
    for warps, row, tail in LOG_INSTANCES:
        prefix = "_ZN9hsmm_scan11scan_kernelILNS_8SemiringE1ELi{}ELi{}ELb{}E".format(
            warps, row, int(tail))
        r = {"instance": "log, {} warps, row {}, tail {}".format(warps, row, tail)}
        for version, sass in (("old", old_sass), ("new", new_sass)):
            body = time_loop(parse_function(sass, prefix))
            r[version + "_instructions"] = sum(1 for ins in body if ins[2] != "NOP")
            r[version + "_branches"] = sum(1 for ins in body if ins[2] == "BRA")
            r[version + "_chain_cycles"] = chain_cycles(body)[0]
        print("step loop {}: old {} instructions ({} branches, chain {} cycles), new {} ({}, "
              "{})".format(r["instance"], r["old_instructions"], r["old_branches"],
                           r["old_chain_cycles"], r["new_instructions"], r["new_branches"],
                           r["new_chain_cycles"]), flush=True)
        out.append(r)
    return out


def build_old(csrc, out_dir, names=SOURCES):
    """nvcc of each earlier source, all at once, with the port's flags;
    prints the compiler's register and spill lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out_dir / "lib{}.so".format(name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for the earlier {}:\n{}".format(name, out))
        print_ptxas("old " + name, out)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def build_cuts(csrc, out_dir, cuts=BAND_GRAD_CUTS):
    """{cut: library} of scratch builds of the earlier ``band_grad.cu``,
    each with its texts replaced (each must occur once), all nvcc at once."""
    source = (csrc / "band_grad.cu").read_text()
    procs = {}
    for name, edits in cuts.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError("cut {!r}: {!r} occurs {} times in the earlier band_grad.cu"
                                   .format(name, old, text.count(old)))
            text = text.replace(old, new)
        d = out_dir / ("cut_" + name.replace(" ", "_"))
        d.mkdir(parents=True, exist_ok=True)
        (d / "band_grad.cu").write_text(text)
        so = d / "libband_grad.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "band_grad.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for the cut {!r}:\n{}".format(name, out))
        print_ptxas("cut " + name, out)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def loop_opcodes(sass, kernel="band_grad_kernel"):
    """{opcode: count} of the instructions of K4's duration loop (of the
    wide kernel's with `kernel` "band_grad_wide_kernel")."""
    insts = parse_function(sass, kernel)
    body = duration_loop(insts) if kernel == "band_grad_kernel" else wide_duration_loop(insts)
    return dict(collections.Counter(ins[2].split(".")[0] for ins in body if ins[2] != "NOP"))


def print_ptxas(what, log):
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            print("{}: {}".format(what, line.strip()), flush=True)


def bind(lib, symbol, n_ptr, n_int):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def potentials(rng, B, T, C, K, lengths, device):
    """Potentials as the port's Gaussian HSMM makes them at D=300 (random
    features, means, covariance, transition, initial and length
    parameters), emissions zeroed past each length."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    feats, means = rng.randn(B, T, D), rng.randn(C, D)
    cov = np.abs(rng.randn(D).astype(np.float32)) + 0.5
    trans_logits, init_logits = rng.randn(C, C), rng.randn(C)
    log_rates = rng.randn(C).astype(np.float32) * 0.3 + 1.5
    emit = gaussian_emission_log_probs(t(feats), t(means), t(cov))
    L = torch.from_numpy(lengths).to(device)
    emit = emit * (torch.arange(T, device=device)[None, :, None] < L[:, None, None])
    lens = poisson_length_log_probs(t(log_rates), K)
    pots = HsmmPotentials(
        trans=transition_log_probs(t(trans_logits)).expand(B, C, C),
        init=initial_log_probs(t(init_logits)).expand(B, C),
        lens=lens.expand((B,) + lens.shape),
        emit=emit.contiguous(),
        end_mask=torch.zeros(B, C, device=device),
    )
    return pots, L


def scan_inputs(B, T, C, K, lengths, rng, device, centred=False):
    """(the forward and reversed chains stacked, as decode and training
    give the gamma scans; the forward chains, as the spans chain gives
    the backpointer scan); `centred`: the emissions centred as the model's
    partition takes them (``centre_emissions``)."""
    if lengths == "ragged":
        lengths = rng.randint(1, T - 31, size=B)
        lengths[[0, 5]] = 1
        lengths[1] = T - 32
    elif lengths is None:
        lengths = np.full(B, T)
    pots, L = potentials(rng, B, T, C, K, np.asarray(lengths, np.int64), device)
    if centred:
        pots = centre_emissions(pots, L.clamp(min=1))[0]
    stacked = hc._stack_fwd_rev(pots, L.clamp(min=1))
    forward = (pots.trans.contiguous(), pots.init.contiguous(),
               _durations(pots.lens).contiguous(), pots.emit.contiguous())
    return stacked, forward


def traceback_inputs(B, T, C, K, lengths, rng, device):
    """(bp, lengths, c_last) as the spans chain gives the traceback: the
    codes of the current backpointer scan (the wide one above 128
    classes) and the best final classes."""
    if lengths is None:
        lengths = np.full(B, T)
    elif isinstance(lengths, str):  # "phase 4i"
        lengths = rng.randint(1, T + 1, size=B)
        lengths[0], lengths[1] = T, 1
    pots, L = potentials(rng, B, T, C, K, np.asarray(lengths, np.int64), device)
    alphas, bp = hc.hsmm_viterbi_scan(pots.trans.contiguous(), pots.init.contiguous(),
                                      _durations(pots.lens).contiguous(), pots.emit.contiguous())
    c_last = _finals(alphas, L, pots.end_mask).argmax(dim=-1)
    return bp, L, c_last


def launcher(fn, outs, inputs):
    """One launch of `fn` on `inputs` with the instance ``scan_instance``
    picks."""
    trans, init, dur, emit = inputs
    N, T, C = emit.shape
    Km = dur.shape[1]
    inst = hc.scan_instance(C, Km)
    ints = [N, T, C, Km, inst.warps, inst.row, inst.tail, inst.smem_bytes]
    device, stream = emit.device.index, torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in inputs] + [None if o is None else o.data_ptr() for o in outs]

    def run():
        err = fn(*ptrs, *ints, device, stream)
        if err:
            raise RuntimeError("launch failed with CUDA error {}".format(err))
    return run


def outputs_for(kind, emit):
    outs = []
    for k in kind:
        if k == "b":
            outs.append(torch.empty(emit.shape, dtype=torch.int32, device=emit.device))
        elif k == "-":
            outs.append(None)
        elif k == "o":
            outs.append(emit.new_empty((emit.shape[0], hc.fold_blocks(emit.shape[1]))))
        else:
            outs.append(torch.empty_like(emit))
    return outs


def check_log_outputs(kinds, outs, inputs):
    """Each version's log scan outputs equal to the plain scan's, folded
    where the version writes offsets ("o" in its kind)."""
    for v, kind in kinds.items():
        want = dict(zip("gao", hc._scan_plain(*inputs, "log", fold="o" in kind)))
        for k, out in zip(kind, outs[v]):
            if out is not None and not torch.equal(out, want[k]):
                raise RuntimeError("{}: {} differs from the plain scan at {} of {} entries".format(
                    v, k, int((out != want[k]).sum()), out.numel()))


def event_ms(run, n):
    """Mean ms of `n` launches and the host window that holds them."""
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, (t0, time.perf_counter())


def graph_ms(run, n):
    """Mean ms of `n` launches captured in one CUDA graph and replayed (no
    host time between them), and the host window of the replay."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            run()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, (t0, time.perf_counter())


def traceback_tile_of(version, T, C, stages=None):
    """The tile a traceback version launches with: ``traceback_tile``
    (rows, smem) for the narrow kernel of both versions and the earlier
    wide one; ``wide_traceback_tile`` (rows, stages, smem) for W2, with
    `stages` slots where given."""
    if C > hc.MAX_CLASSES and version == "new":
        if stages is None:
            return hc.wide_traceback_tile(T, C)
        return hc.wide_traceback_tile(T, C, stages=stages)
    return hc.traceback_tile(T, C)


def traceback_launcher(fn, spans, inputs, tile):
    """One launch of a traceback `fn` on (bp, lengths, c_last) with
    `tile` (``traceback_tile_of``)."""
    bp = inputs[0]
    N, T, C = bp.shape
    ints = [N, T, C, *tile]
    if isinstance(tile, hc.WideTracebackTile):  # W2 takes the radix's log2
        ints.append(hc.code_radix(C).bit_length() - 1)
    ptrs = [x.data_ptr() for x in (*inputs, spans)]

    def run():  # on the current stream, which a graph's capture replaces
        err = fn(*ptrs, *ints, bp.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("launch failed with CUDA error {}".format(err))
    return run


def bind_traceback(libs, version, C):
    """`version`'s traceback entry for C classes: the narrow one, or above
    128 classes the wide one (the earlier takes rows and smem, W2 rows,
    stages, smem and the radix's log2)."""
    if C <= hc.MAX_CLASSES:
        return bind(libs["hsmm_viterbi"], "hsmm_viterbi_traceback", 4, 5)
    return bind(libs["hsmm_viterbi"], "hsmm_viterbi_traceback_wide", 4,
                7 if version == "new" else 5)


def one_segment_a_tile(inputs, rows):
    """(bp, lengths, c_last) with every code a span of `rows` frames: the
    walk takes one segment a tile of that many rows and visits every tile,
    so its time is the tiles' staging (copy and, in the earlier kernel,
    rewrite) with almost no walk."""
    bp, L, c_last = inputs
    fill = (rows - 1) * hc.WIDE_CODE_RADIX + torch.arange(bp.shape[-1], device=bp.device)
    return fill.to(torch.int32).expand(bp.shape).contiguous(), L, c_last


def segments_longest(spans):
    per_video = (spans >= 0).sum(dim=1)
    return int(per_video.sum()), int(per_video.max())


# one block a video copies its plane's first `tiles` tiles of `bytes` into
# shared memory one after another, each a cp.async.bulk waited on before
# the next: the earlier W2's copy without its rewrite
COPY_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
__global__ void copy_probe_kernel(const int32_t* src, int stride_words, int bytes,
                                  int tiles) {
  extern __shared__ __align__(16) unsigned char buf[];
  if (threadIdx.x != 0) return;
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int32_t* base = src + (size_t)blockIdx.x * stride_words;
  for (int t = 0; t < tiles; ++t) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];" ::"r"(bar + 16), "l"(base + (size_t)t * (bytes / 4)),
                 "r"(bytes), "r"(bar) : "memory");
    uint32_t done = 0;
    while (!done) {
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(t & 1) : "memory");
    }
  }
}
}  // namespace
extern "C" int copy_probe(const void* src, int blocks, int stride_words, int bytes, int tiles,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = 16 + bytes;
  err = cudaFuncSetAttribute(copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  copy_probe_kernel<<<blocks, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)src, stride_words, bytes, tiles);
  return (int)cudaGetLastError();
}
"""


def build_copy_probe(out_dir):
    """nvcc of COPY_PROBE with the port's flags; its ``copy_probe``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "copy_probe.cu", out_dir / "libcopy_probe.so"
    src.write_text(COPY_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    return bind(ctypes.CDLL(str(so)), "copy_probe", 1, 4)


def copy_rate(probe, bp, rows):
    """One block a video copying tiles of `rows` rows one after another
    from a replayed graph: (us a tile, bytes a us through one SM) from the
    launch with one tile and with as many as fit the plane, less the
    launch with none."""
    N, T, C = bp.shape
    nbytes = rows * C * 4 // 16 * 16
    most = T * C * 4 // nbytes
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def ms(tiles):
        def run():
            err = probe(bp.data_ptr(), N, T * C, nbytes, tiles, bp.device.index, stream())
            if err:
                raise RuntimeError("copy probe failed with CUDA error {}".format(err))
        return graph_ms(run, N_GRAPH)[0]
    empty, one, full = ms(0), ms(1), ms(most)
    return {"rows": rows, "bytes_a_tile": nbytes, "tiles": most, "empty_ms": empty,
            "one_tile_us": 1e3 * (one - empty), "tiles_us": 1e3 * (full - empty),
            "bytes_per_us_one": nbytes / (1e3 * (one - empty)),
            "bytes_per_us_stream": most * nbytes / (1e3 * (full - empty))}


def traceback_split(fn, version, inputs, walk_inputs):
    """Where a version's time at the S6 shape goes, from replayed graphs:
    its time on `inputs`; the same lengths with codes of one segment a
    tile (the staging stream alone); and on `walk_inputs` (a plane of
    WALK_T rows, one earlier tile) the real walk less its one-segment
    twin, as us and cycles a segment of the longest video."""
    def timed(inp, rows=None):
        N, T, C = inp[0].shape
        tile = traceback_tile_of(version, T, C)
        if rows is not None:
            inp = one_segment_a_tile(inp, tile.rows)
        spans = torch.empty(inp[0].shape[:2], dtype=torch.long, device=inp[0].device)
        run = traceback_launcher(fn, spans, inp, tile)
        run()
        torch.cuda.synchronize()
        if not torch.equal(spans, hc._traceback_plain(*inp)):
            raise RuntimeError("{} traceback's spans differ from plain".format(version))
        return graph_ms(run, N_GRAPH)[0], segments_longest(spans)
    full, (_, longest) = timed(inputs)
    stream, _ = timed(inputs, rows=True)
    walk, (_, walk_longest) = timed(walk_inputs)
    walk_one, (_, one_longest) = timed(walk_inputs, rows=True)
    per = (walk - walk_one) / (walk_longest - one_longest)
    return {"ms": full, "longest": longest, "stream_ms": stream, "walk_T": WALK_T,
            "walk_ms": walk, "walk_one_segment_ms": walk_one,
            "walk_segments_longest": walk_longest, "walk_us_per_segment": 1e3 * per}


def band_grad_inputs(B, T, C, K, lengths, rng, device):
    """(G1m, G2p, band) as the partition's backward gives the band
    gradient: from the current log scan's gamma and logZ."""
    if lengths is None:
        lengths = np.full(B, T)
    pots, L = potentials(rng, B, T, C, K, np.asarray(lengths, np.int64), device)
    gamma, alphas, offsets = hc.hsmm_log_scan(*hc._stack_fwd_rev(pots, L))
    lse, _ = _log_partition(alphas[:B], offsets[:B], L, pots.end_mask)
    gb = hc._grad_band_inputs(pots, L, gamma, offsets, lse)
    return gb.G1m, gb.G2p, gb.band


def band_grad_launchers(fns, old_blocks, inputs, old_chunk=True):
    """({version: (run, (qg, sa, st, lg), scratch bytes)}, narrow tile,
    wide tile): one launch of each version's band gradient into outputs
    of its own. "new" past 128 classes is the wide entry
    (``hsmm_band_grad_wide``) in the tile ``band_grad_wide_tile`` sizes for
    this card; every other version the narrow entry in the tile
    ``band_grad_tile`` sizes (with the chunk where `old_chunk`, as the
    current one), but "old" the two-launch form where `old_blocks` is
    given."""
    G1m, G2p, dur = inputs
    B, T, C = G1m.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    sms = hc._sm_count(G1m.device.index)
    tile = hc.band_grad_tile(B, T, C, Km, sms)
    wide = hc.band_grad_wide_tile(B, T, C, Km, sms)
    out = {}
    for v, fn in fns.items():
        outs = [torch.empty_like(G1m) for _ in range(3)] + [G1m.new_empty((B, Km, C))]
        ints = [B, T, T2, C, Km]
        if v == "new" and C > hc.MAX_CLASSES:
            floats, tickets = wide.scratch_bytes // 4, hc._tickets(G1m.device, B * wide.groups)
            ints += [wide.rows, wide.warps, wide.slab, wide.smem_bytes]
        elif v == "old" and old_blocks is not None:
            floats, tickets = B * old_blocks(T, C) * Km * C, None
        else:
            floats = B * tile.tiles * Km * C
            tickets = hc._tickets(G1m.device, B * -(-C // tile.chunk))
            ints += [tile.rows, tile.slab, tile.smem_bytes] + (
                [tile.chunk] if v == "new" or old_chunk else [])
        # alive while `run` is
        held = [*inputs, *outs, G1m.new_empty((floats,)) if floats else None]
        if tickets is not None:
            held.append(tickets)

        def run(fn=fn, held=held, ints=ints):
            err = fn(*[None if x is None else x.data_ptr() for x in held], *ints,
                     G1m.device.index, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError("launch failed with CUDA error {}".format(err))
        out[v] = (run, outs, 4 * floats)
    return out, tile, wide


def band_grad_floors(B, T, C, Km, mhz, sms, insts, wide):
    """A version's issue floor (its duration loop's `insts`) and its
    cross-tile sum's (``scan_floor.band_grad_tail``) in its tile."""
    issue = (band_grad_wide_issue_ms if wide else band_grad_issue_ms)(insts, B, T, C, Km, mhz, sms)
    return {"issue_floor_ms": issue, "tail": band_grad_tail(B, T, C, Km, mhz, sms, wide=wide)}


def check_band_grad_plain(name, outs, plain):
    """qg, sa and st equal to the plain version's, lg within the score
    tolerance; raises naming `name`."""
    for out, a, p in zip(("qg", "sa", "st", "lg"), outs, plain):
        if out != "lg" and not torch.equal(a, p):
            raise RuntimeError("{} {}: {} of {} entries differ from the plain version".format(
                name, out, int((a != p).sum()), a.numel()))
        try:
            torch.testing.assert_close(a, p, rtol=RTOL, atol=ATOL)
        except AssertionError as e:
            raise RuntimeError("{} {}: against the plain version\n{}".format(name, out, e))


def band_grad_step0(fns, inputs, window_ms, clock, insts, split, old_chunk):
    """Step 0 at a wide shape: the earlier kernel's outputs against the
    plain version's, its scratch, floors and time alone from replayed
    graphs; with `split`, beside the cut builds in `fns`, in turns (each
    version, then each in reverse order)."""
    runs, tile, _ = band_grad_launchers(fns, None, inputs, old_chunk)
    B, T, C = inputs[0].shape
    Km = inputs[2].shape[1]
    sms = hc._sm_count(inputs[0].device.index)
    runs["old"][0]()
    torch.cuda.synchronize()
    check_band_grad_plain("the earlier kernel", runs["old"][1], hc._band_grad_plain(*inputs))
    r = {"tile": tile._asdict(), "old_scratch_bytes": runs["old"][2], "plane_bytes": 4 * B * T * C,
         "old_floor": band_grad_floors(B, T, C, Km, max_sm_clock_mhz(), sms, insts, False)}
    versions = list(runs) if split else ["old"]
    n = int(min(1000, max(3, window_ms / event_ms(runs["old"][0], 1)[0])))
    timed = [(v, *graph_ms(runs[v][0], n)) for v in versions + versions[::-1]]
    r["launches"] = n
    for v in versions:
        key = v.replace(" ", "_")
        r[key + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[key + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
    return r


def compare_band_grad(fns, old_blocks, inputs, window_ms, clock, insts, step0=False,
                      old_chunk=True):
    """The outputs' checks, then ms from replayed graphs in the order old,
    new, new, old, and each version launched one by one; with `step0`, the
    earlier kernel alone both ways first. Each version's scratch and
    floors (its loop's instructions in `insts`: old, new, new wide)."""
    runs, tile, wide = band_grad_launchers(fns, old_blocks, inputs, old_chunk)
    G1m = inputs[0]
    B, T, C = G1m.shape
    Km = inputs[2].shape[1]
    is_wide = C > hc.MAX_CLASSES
    sms, mhz = hc._sm_count(G1m.device.index), max_sm_clock_mhz()
    r = {"tile": tile._asdict(), "plane_bytes": 4 * B * T * C,
         "old_scratch_bytes": runs["old"][2], "new_scratch_bytes": runs["new"][2],
         "old_floor": band_grad_floors(B, T, C, Km, mhz, sms, insts["old"], False),
         "new_floor": band_grad_floors(B, T, C, Km, mhz, sms,
                                       insts["new wide" if is_wide else "new"], is_wide)}
    if is_wide:
        r["wide_tile"] = wide._asdict()
    if step0:
        run = runs["old"][0]
        n = int(min(1000, max(3, window_ms / event_ms(run, 1)[0])))
        r["step0_old_graph_ms"] = graph_ms(run, n)[0]
        r["step0_old_stream_ms"] = event_ms(run, n)[0]
        print("step 0, the earlier kernel alone at this shape: {:.5f} ms from a replayed graph "
              "of {} launches, {:.5f} ms launched one by one".format(
                  r["step0_old_graph_ms"], n, r["step0_old_stream_ms"]), flush=True)
    for run, _, _ in runs.values():
        run()
    torch.cuda.synchronize()
    old, new = runs["old"][1], runs["new"][1]
    new_lg = new[3].clone()
    runs["new"][0]()
    torch.cuda.synchronize()
    if not torch.equal(new_lg, new[3]):
        raise RuntimeError("lg: two runs of the new kernel differ")
    plain = hc._band_grad_plain(*inputs)
    tiny = torch.finfo(torch.float32).tiny
    # per version and output: [entries unequal to plain, of them denormal in plain]
    r["differ_plain"] = {v: {name: [int((a != p).sum()),
                                    int(((a != p) & (p != 0) & (p.abs() < tiny)).sum())]
                             for name, a, p in zip(("qg", "sa", "st"), outs, plain)}
                         for v, (_, outs, _) in runs.items()}
    r["plain_st_denormals"] = int(((plain[2] != 0) & (plain[2].abs() < tiny)).sum())
    for name, a, b, p in zip(("qg", "sa", "st"), old, new, plain):
        moved = (a != b) & (b != p)
        if moved.any():
            raise RuntimeError("{}: at {} of {} entries the versions differ and the new one "
                               "is not the plain version's".format(name, int(moved.sum()),
                                                                    a.numel()))
    for name, a, b in zip(("qg", "sa", "st", "lg"), new, plain):
        try:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        except AssertionError as e:
            raise RuntimeError("{}: the new kernel against the plain version\n{}".format(name, e))
    r["lg_max_abs_err_plain"] = float((new[3].double() - plain[3].double()).abs().max()) \
        if new[3].numel() else 0.0
    r["lg_equal_old"] = bool(torch.equal(old[3], new[3]))
    same_rows = not is_wide and (old_blocks is None or tile.rows == 512 // C)
    if same_rows and not r["lg_equal_old"]:
        raise RuntimeError("lg: the tile keeps the earlier rows, but lg differs")
    fastest = min(event_ms(run, 1)[0] for run, _, _ in runs.values())
    n = int(min(1000, max(3, window_ms / fastest)))
    timed = [(v, *graph_ms(runs[v][0], n)) for v in ("old", "new", "new", "old")]
    r["launches"] = n
    for v in ("old", "new"):
        r[v + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[v + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
        r[v + "_stream_ms"] = event_ms(runs[v][0], n)[0]
    return r


def band_grad_runs(inputs, runs, window_ms, clock):
    """The wide kernel in the rule's tile and in tiles of `runs` runs a
    video (the rows and partials they give), from replayed graphs in
    turns (the rule's, each other, then back); lg within the score
    tolerance of the plain version in each."""
    G1m = inputs[0]
    B, T, C = G1m.shape
    Km = inputs[2].shape[1]
    rule = hc.band_grad_wide_tile(B, T, C, Km, hc._sm_count(G1m.device.index))
    tiles = {"rule": rule}
    for n in runs:
        rows = -(-T // n)
        n = -(-T // rows)
        tiles["{} runs".format(n)] = rule._replace(
            rows=rows, tiles=n, scratch_bytes=4 * B * n * Km * C if n > 1 else 0)
    plain = hc._band_grad_plain(*inputs)
    launches = {}
    for name, tile in tiles.items():
        outs = hc._launch_band_grad_wide(*inputs, tile)
        torch.cuda.synchronize()
        check_band_grad_plain("the wide kernel in " + name, outs, plain)
        launches[name] = lambda tile=tile: hc._launch_band_grad_wide(*inputs, tile)
    n = int(min(1000, max(3, window_ms / event_ms(launches["rule"], 1)[0])))
    order = list(tiles) + list(tiles)[::-1]
    timed = [(v, *graph_ms(launches[v], n)) for v in order]
    r = {"runs_launches": n, "runs": {}}
    for name, tile in tiles.items():
        r["runs"][name] = {"runs": tile.tiles, "rows": tile.rows,
                           "scratch_bytes": tile.scratch_bytes,
                           "ms": [ms for w, ms, _ in timed if w == name],
                           "sm_mhz": clock_summary(clock.within(
                               [win for w, _, win in timed if w == name]))}
    return r


def run_band_grad(old_libs, new_libs, old_csrc, window_ms, clock, rng, device, step0):
    """K4's comparison (``compare_band_grad`` at BAND_GRAD_SHAPES) or, with
    `step0`, the earlier kernel alone at the wide shapes and its split
    (``band_grad_step0``). Returns (results, loop opcodes by version)."""
    # the two-launch form exports its scratch's size; the current one does not
    old_blocks = getattr(old_libs["band_grad"], "hsmm_band_grad_blocks", None)
    if old_blocks is not None:
        old_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        old_blocks.restype = ctypes.c_int
    old_chunk = "int chunk" in (old_csrc / "band_grad.cu").read_text()
    old_ints = (5 if old_blocks is not None else 8 + old_chunk)
    fns = {"old": bind(old_libs["band_grad"], "hsmm_band_grad",
                       8 if old_blocks is not None else 9, old_ints)}
    old_sass = library_sass(old_csrc / "build" / "libband_grad.so")
    opcodes = {"old": loop_opcodes(old_sass)}
    insts = {"old": band_grad_floor(old_sass)[0]}
    if not step0:
        new_sass = built_sass("band_grad")
        fns["new"] = bind(new_libs["band_grad"], "hsmm_band_grad", 9, 9)
        fns["new wide"] = bind(new_libs["band_grad"], "hsmm_band_grad_wide", 9, 9)
        opcodes.update({"new": loop_opcodes(new_sass),
                        "new wide": loop_opcodes(new_sass, "band_grad_wide_kernel")})
        insts.update({"new": band_grad_floor(new_sass)[0],
                      "new wide": band_grad_wide_floor(new_sass)[0]})
    print("band grad duration loop, instructions by opcode: {}".format(json.dumps(opcodes)),
          flush=True)
    results = []
    cuts = {}
    if step0:
        cuts = {name: bind(lib, "hsmm_band_grad", 9, old_ints)
                for name, lib in build_cuts(old_csrc, old_csrc / "build").items()}
    for shape, B, T, C, K, lengths in BAND_GRAD_SHAPES:
        if step0 and C <= hc.MAX_CLASSES:
            continue
        inputs = band_grad_inputs(B, T, C, K, lengths, rng, device)
        if step0:
            split = shape in BAND_GRAD_SPLIT_SHAPES
            r = band_grad_step0({"old": fns["old"], **(cuts if split else {})}, inputs,
                                window_ms, clock, insts["old"], split, old_chunk)
            r.update(shape=shape, B=B, T=T, C=C, Km=K - 1)
            results.append(r)
            fl = r["old_floor"]
            print("{:20s} step 0, band grad B={:2d} T={:5d} C={:4d} Km={:3d}: the earlier kernel "
                  "{} ms (graphs of {}); outputs equal plain (lg at rtol {} / atol {}); tile {} "
                  "rows x {} classes, {} tiles a video; scratch {} bytes (plane {}); issue floor "
                  "{:.5f} ms, cross-tile sum floor {:.5f} ms ({}){}".format(
                      shape, B, T, C, K - 1, ["{:.5f}".format(x) for x in r["old_ms"]],
                      r["launches"], RTOL, ATOL, r["tile"]["rows"], r["tile"]["chunk"],
                      r["tile"]["tiles"], r["old_scratch_bytes"], r["plane_bytes"],
                      fl["issue_floor_ms"], fl["tail"]["floor_ms"], json.dumps(fl["tail"]),
                      "".join("; {} {} ms".format(v, ["{:.5f}".format(x) for x in r[
                          v.replace(" ", "_") + "_ms"]]) for v in cuts if split)), flush=True)
            continue
        new_fns = {"old": fns["old"],
                   "new": fns["new wide" if C > hc.MAX_CLASSES else "new"]}
        r = compare_band_grad(new_fns, old_blocks, inputs, window_ms, clock, insts,
                              step0=shape == "serving", old_chunk=old_chunk)
        if shape in BAND_GRAD_RUNS:
            r.update(band_grad_runs(inputs, BAND_GRAD_RUNS[shape], window_ms, clock))
            print("{:20s} band grad wide kernel by runs a video (graphs of {}, in turns): "
                  "{}".format(shape, r["runs_launches"], json.dumps(
                      {k: {f: v[f] for f in ("runs", "rows", "scratch_bytes", "ms")}
                       for k, v in r["runs"].items()})), flush=True)
        old, new = np.mean(r["old_ms"]), np.mean(r["new_ms"])
        r.update(shape=shape, B=B, T=T, C=C, Km=K - 1, speedup=old / new)
        results.append(r)
        t = r.get("wide_tile", r["tile"])
        print("{:20s} band grad B={:2d} T={:5d} C={:4d} Km={:3d}: old {} ms, new {} ms "
              "(graphs), x{:.2f}; one by one old {:.5f}, new {:.5f} ms; new tile {}; scratch "
              "old {} bytes, new {} (plane {}); floors old {}, new {}; qg/sa/st entries "
              "differing from plain (of them denormal there) {}; lg max abs err vs plain {:.3g}, "
              "equal old {}; SM clock old {}, new {}".format(
                  shape, B, T, C, K - 1, ["{:.5f}".format(x) for x in r["old_ms"]],
                  ["{:.5f}".format(x) for x in r["new_ms"]], r["speedup"],
                  r["old_stream_ms"], r["new_stream_ms"], json.dumps(t),
                  r["old_scratch_bytes"], r["new_scratch_bytes"], r["plane_bytes"],
                  json.dumps(r["old_floor"]), json.dumps(r["new_floor"]), r["differ_plain"],
                  r["lg_max_abs_err_plain"], r["lg_equal_old"], r["old_sm_mhz"],
                  r["new_sm_mhz"]), flush=True)
    return results, opcodes


def band_max_inputs(B, T, C, K, lengths, rng, device):
    """(G1, G2p, band) as the labels chain gives the band max: from the
    current max gamma scan. Lengths "synthetic": a synthetic slice's
    decode batch, 20-1,024 frames padded to T."""
    if lengths == "synthetic":
        lengths = rng.randint(20, 1025, size=B)
        lengths[0] = 1024
    elif lengths is None:
        lengths = np.full(B, T)
    pots, L = potentials(rng, B, T, C, K, np.asarray(lengths, np.int64), device)
    gamma, _ = hc.hsmm_gamma_scan(*hc._stack_fwd_rev(pots, L))
    return hc._band_inputs(pots, L, gamma)


def band_max_launchers(fns, inputs, tile=None):
    """{version: (run, fm)}: one launch of each version's band max into
    an output of its own, the new one in `tile` (by default the tile
    ``band_max_tile`` sizes for this card); and the tile."""
    G1, G2p, dur = inputs
    B, T, C = G1.shape
    T2, Km = G2p.shape[1], dur.shape[1]
    if tile is None:
        tile = hc.band_max_tile(B, T, C, Km, hc._sm_count(G1.device.index))
    out = {}
    for v, fn in fns.items():
        fm = torch.empty_like(G1)
        held = [*inputs, fm]  # alive while `run` is
        ints = [B, T, T2, C, Km] + ([tile.rows, tile.slab, tile.smem_bytes] if v == "new" else [])

        def run(fn=fn, held=held, ints=ints):
            err = fn(*[x.data_ptr() for x in held], *ints, G1.device.index,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError("launch failed with CUDA error {}".format(err))
        out[v] = (run, fm)
    return out, tile


def earlier_band_max_wrapper(fn):
    """The earlier ``hsmm_band_max``'s code on the card bound to the
    earlier kernel: the checks, the output's allocation, one ctypes call
    with the stream's arguments, the error check."""
    def call(G1, G2p, dur):
        B, T, T2, C, Km = hc._band_shapes("hsmm_band_max", G1, G2p, dur)
        fm = torch.empty_like(G1)
        err = fn(*[x.data_ptr() for x in (G1, G2p, dur, fm)], B, T, T2, C, Km,
                 *hc._stream_args(G1))
        hc._raise_on_error("hsmm_band_max", err)
        return fm
    return call


def band_max_step0(fn, inputs):
    """Step 0: the earlier kernel alone, raw from a replayed graph of
    N_GRAPH launches and one by one, then through the earlier wrapper's
    code one by one and from a graph, and the wrapper's host time."""
    runs, _ = band_max_launchers({"old": fn}, inputs)
    run = runs["old"][0]
    wrapper = earlier_band_max_wrapper(fn)
    r = {"step0_old_graph_ms": graph_ms(run, N_GRAPH)[0],
         "step0_old_stream_ms": event_ms(run, N_GRAPH)[0],
         "step0_old_wrapper_stream_ms": event_ms(lambda: wrapper(*inputs), N_GRAPH)[0],
         "step0_old_wrapper_graph_ms": graph_ms(lambda: wrapper(*inputs), N_GRAPH)[0],
         "step0_old_wrapper_host_ms": host_ms(lambda: wrapper(*inputs), N_GRAPH)}
    print("step 0, the earlier band max alone at this shape ({} launches): {:.5f} ms from a "
          "replayed graph, {:.5f} ms launched one by one; through its wrapper {:.5f} ms one by "
          "one, {:.5f} ms from a graph, the wrapper's host time {:.5f} ms a call".format(
              N_GRAPH, r["step0_old_graph_ms"], r["step0_old_stream_ms"],
              r["step0_old_wrapper_stream_ms"], r["step0_old_wrapper_graph_ms"],
              r["step0_old_wrapper_host_ms"]), flush=True)
    return r


def compare_band_max(fns, inputs, window_ms, clock):
    """fm equal between the versions and to the plain version's, then ms
    from replayed graphs in the order old, new, new, old, and each version
    launched one by one."""
    runs, tile = band_max_launchers(fns, inputs)
    r = {"tile": tile._asdict()}
    for run, _ in runs.values():
        run()
    torch.cuda.synchronize()
    old, new = runs["old"][1], runs["new"][1]
    plain = hc._band_max_plain(*inputs)
    for name, a, b in (("old and new", old, new), ("new and plain", new, plain)):
        if not torch.equal(a, b):
            raise RuntimeError("fm: {} differ at {} of {} entries".format(
                name, int((a != b).sum()), a.numel()))
    fastest = min(event_ms(run, 1)[0] for run, _ in runs.values())
    n = int(min(1000, max(3, window_ms / fastest)))
    timed = [(v, *graph_ms(runs[v][0], n)) for v in ("old", "new", "new", "old")]
    r["launches"] = n
    for v in ("old", "new"):
        r[v + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[v + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
        r[v + "_stream_ms"] = event_ms(runs[v][0], n)[0]
    return r


def compare_band_max_rule(fn, inputs, window_ms, clock):
    """The new band max in ``band_max_tile``'s tile ("rule") against the
    tile of the rows that count warps alone (halo share 0, "warps"): fm
    equal to the plain version's in both, then ms from replayed graphs in
    the order rule, warps, warps, rule."""
    G1, G2p, dur = inputs
    B, T, C = G1.shape
    sms = hc._sm_count(G1.device.index)
    tiles = {"rule": hc.band_max_tile(B, T, C, dur.shape[1], sms),
             "warps": hc.band_max_tile(B, T, C, dur.shape[1], sms, halo_share=0)}
    runs = {k: band_max_launchers({"new": fn}, inputs, tile)[0]["new"]
            for k, tile in tiles.items()}
    plain = hc._band_max_plain(*inputs)
    for k, (run, fm) in runs.items():
        run()
        torch.cuda.synchronize()
        if not torch.equal(fm, plain):
            raise RuntimeError("fm in the {} tile differs from plain at {} of {} entries".format(
                k, int((fm != plain).sum()), fm.numel()))
    n = int(min(1000, max(3, window_ms / min(event_ms(run, 1)[0] for run, _ in runs.values()))))
    timed = [(v, *graph_ms(runs[v][0], n)) for v in ("rule", "warps", "warps", "rule")]
    r = {"launches": n}
    for v, tile in tiles.items():
        r[v + "_rows"], r[v + "_blocks"] = tile.rows, B * tile.tiles
        r[v + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[v + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
    return r


def compare(fns, kind, inputs, window_ms, clock):
    """Equal outputs, then ms in the order old, new, new, old, and the SM
    clock readings inside each version's timed windows. Scans by `kind`
    (or {version: kind} where one version's log scan writes offsets);
    kind "t" is the traceback on (bp, lengths, c_last)."""
    kinds = kind if isinstance(kind, dict) else None
    if kind == "t":
        outs = {v: [torch.empty(inputs[0].shape[:2], dtype=torch.long,
                                device=inputs[0].device)] for v in fns}
        T, C = inputs[0].shape[1:]
        runs = {v: traceback_launcher(fns[v], outs[v][0], inputs, traceback_tile_of(v, T, C))
                for v in fns}
    else:
        outs = {v: outputs_for(kinds[v] if kinds else kind, inputs[3]) for v in fns}
        runs = {v: launcher(fns[v], outs[v], inputs) for v in fns}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    if kinds:
        check_log_outputs(kinds, outs, inputs)
    for a, b in zip(outs["old"], outs["new"]) if not kinds else ():
        if a is not None and not torch.equal(a, b):
            raise RuntimeError("old and new outputs differ at {} of {} entries".format(
                int((a != b).sum()), a.numel()))
    fastest = min(event_ms(run, 1)[0] for run in runs.values())
    n = int(min(1000, max(3, window_ms / fastest)))
    # the traceback from a replayed graph: a short kernel launched one by
    # one would read the host's launch time
    timer = graph_ms if kind == "t" else event_ms
    timed = [(v, *timer(runs[v], n)) for v in ("old", "new", "new", "old")]
    r = {"launches": n}
    for v in ("old", "new"):
        r[v + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[v + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
    return r


def run_traceback(old_libs, new_libs, probe, window_ms, clock, rng, device, old_sass,
                  new_sass):
    """The traceback at TRACEBACK_SHAPES, spans equal to the plain
    version's: old, new, new, old from replayed graphs, or with no
    `new_libs` (step 0) the earlier kernel alone at the wide shapes. At
    the wide shapes each version's floor from its SASS; at the S6 shape
    each version's split (``traceback_split``), the copy probe's rate at
    the earlier tile and at W2's slot, and (not in step 0) W2's ring at
    WIDE_TRACEBACK_RING_STAGES slots, in turns."""
    mhz = max_sm_clock_mhz()
    versions = {"old": old_libs, **({"new": new_libs} if new_libs else {})}
    chains = {"old": traceback_wide_floor(old_sass)[0]}
    if new_libs:
        chains["new"] = traceback_wide_floor(new_sass)[0]
    results = []
    for shape, B, T, C, K, lengths in TRACEBACK_SHAPES:
        wide = C > hc.MAX_CLASSES
        if not new_libs and not wide:
            continue
        inputs = traceback_inputs(B, T, C, K, lengths, rng, device)
        spans = hc._traceback_plain(*inputs)
        total, longest = segments_longest(spans)
        fns = {v: bind_traceback(libs, v, C) for v, libs in versions.items()}
        if new_libs:
            if not torch.equal(hc.hsmm_viterbi_traceback(*inputs), spans):
                raise RuntimeError("{}: the traceback's spans differ from the plain "
                                   "version's".format(shape))
            r = compare(fns, "t", inputs, window_ms, clock)
        else:
            out = torch.empty_like(spans)
            run = traceback_launcher(fns["old"], out, inputs, traceback_tile_of("old", T, C))
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, spans):
                raise RuntimeError("{}: the earlier traceback's spans differ from the plain "
                                   "version's".format(shape))
            timed = [graph_ms(run, N_GRAPH) for _ in range(2)]
            r = {"launches": N_GRAPH, "old_ms": [ms for ms, _ in timed],
                 "old_sm_mhz": clock_summary(clock.within([w for _, w in timed]))}
        r.update(shape=shape, kernel="traceback", videos=B, T=T, C=C, Km=max(K - 1, 1),
                 segments=total, segments_longest_video=longest)
        for v in versions:
            r[v + "_us_per_segment"] = 1e3 * np.mean(r[v + "_ms"]) / longest
        if new_libs:
            r["speedup"] = np.mean(r["old_ms"]) / np.mean(r["new_ms"])
        if wide:
            tiles = {"old": hc.traceback_tile(T, C), "new": hc.wide_traceback_tile(T, C)}
            first = {"old": 4 * min(tiles["old"].rows, T) * C,
                     "new": wide_first_tile_bytes(T, C)}
            for v in versions:
                r[v + "_tile"] = tiles[v]._asdict()
                r[v + "_floor_ms"] = traceback_wide_floor_ms(chains[v], longest, first[v], mhz)
                r[v + "_floor_ratio"] = np.mean(r[v + "_ms"]) / r[v + "_floor_ms"]
                r[v + "_chain_cycles"] = chains[v]
        if shape == "wide S6":
            walk_in = traceback_inputs(B, WALK_T, C, K, None, rng, device)
            for v in versions:
                r[v + "_split"] = traceback_split(fns[v], v, inputs, walk_in)
                r[v + "_split"]["walk_cycles_per_segment"] = (
                    r[v + "_split"]["walk_us_per_segment"] * mhz)
            r["copy_probe"] = [copy_rate(probe, inputs[0], rows) for rows in sorted(
                {hc.traceback_tile(T, C).rows, hc.wide_traceback_tile(T, C).rows})]
            if new_libs:
                r["ring"] = compare_ring(fns["new"], inputs, clock)
        results.append(r)
        line = "{:18s} traceback N={:2d} T={:5d} C={:4d}: {} segments, longest video {}".format(
            shape, B, T, C, total, longest)
        for v in versions:
            line += "; {} {} ms ({:.5f} us a segment{})".format(
                v, ["{:.5f}".format(x) for x in r[v + "_ms"]], r[v + "_us_per_segment"],
                ", floor {:.5f} ms, x{:.2f}".format(r[v + "_floor_ms"], r[v + "_floor_ratio"])
                if wide else "")
        if new_libs:
            line += "; x{:.2f}".format(r["speedup"])
        line += "; SM clock " + ", ".join("{} {}-{} MHz ({} readings)".format(
            v, r[v + "_sm_mhz"].get("min"), r[v + "_sm_mhz"].get("max"), r[v + "_sm_mhz"]["n"])
            for v in versions)
        print(line, flush=True)
        for v in versions:
            if v + "_split" in r:
                sp = r[v + "_split"]
                print("  {} split at the S6 shape: {:.5f} ms in all; the staging stream alone "
                      "(one segment a tile) {:.5f} ms; the walk alone at T={} ({} segments, the "
                      "one-segment twin {:.5f} ms): {:.5f} us = {:.1f} cycles a segment at {:.0f} "
                      "MHz".format(v, sp["ms"], sp["stream_ms"], WALK_T,
                                   sp["walk_segments_longest"], sp["walk_one_segment_ms"],
                                   sp["walk_us_per_segment"], sp["walk_cycles_per_segment"],
                                   mhz), flush=True)
        for cp in r.get("copy_probe", ()):
            print("  copy probe, tiles of {} rows ({} bytes) through one SM a video: one tile "
                  "{:.3f} us ({:.0f} bytes a us), {} tiles one after another {:.3f} us ({:.0f} "
                  "bytes a us); an empty launch {:.5f} ms".format(
                      cp["rows"], cp["bytes_a_tile"], cp["one_tile_us"], cp["bytes_per_us_one"],
                      cp["tiles"], cp["tiles_us"], cp["bytes_per_us_stream"], cp["empty_ms"]),
                  flush=True)
        if "ring" in r:
            print("  W2's ring at the S6 shape, slots (rows): {}".format("; ".join(
                "{} ({}) {} ms".format(k["stages"], k["rows"], ["{:.5f}".format(x)
                                                                for x in k["ms"]])
                for k in r["ring"])), flush=True)
    return results


def compare_ring(fn, inputs, clock):
    """W2 with WIDE_TRACEBACK_RING_STAGES slots (the most rows that fit
    each), spans equal to the plain version's, timed from replayed graphs
    in turns (each count once, then again in the reverse order)."""
    N, T, C = inputs[0].shape
    plain = hc._traceback_plain(*inputs)
    runs = {}
    for st in WIDE_TRACEBACK_RING_STAGES:
        tile = traceback_tile_of("new", T, C, stages=st)
        spans = torch.empty_like(plain)
        runs[st] = (traceback_launcher(fn, spans, inputs, tile), tile)
        runs[st][0]()
        torch.cuda.synchronize()
        if not torch.equal(spans, plain):
            raise RuntimeError("W2 with {} slots: spans differ from plain".format(st))
    order = list(WIDE_TRACEBACK_RING_STAGES)
    timed = [(st, *graph_ms(runs[st][0], N_GRAPH)) for st in order + order[::-1]]
    return [{"stages": st, "rows": runs[st][1].rows, "smem_bytes": runs[st][1].smem_bytes,
             "ms": [ms for w, ms, _ in timed if w == st],
             "sm_mhz": clock_summary(clock.within([win for w, _, win in timed if w == st]))}
            for st in order]


def wide_launcher(fn, inputs, kind, inst):
    """(run, outputs): one launch of a wide scan `fn` on (trans, init, dur,
    emit) on `inst`'s launch, the chains sharing tables as the inputs
    give them (``hsmm_cuda._wide_tables``); the tables' layout (transposed
    for the cluster route, rows padded for the grid route) and the scratch
    made once here."""
    trans, init, dur, emit = inputs
    N, T, C = emit.shape
    Km = dur.shape[1]
    tables, group = hc._wide_tables("scan_ab", trans, N, C)
    outs = outputs_for(kind, emit)
    radix = [hc.code_radix(C)] if "b" in kind else []
    if inst.route == "cluster":
        held = [tables.transpose(1, 2).contiguous(), init, dur, emit, *outs, None, None, None]
        ints = [N, T, C, Km, *radix, inst.cluster, inst.slab, 1, inst.smem_bytes, group]
    else:
        table = emit.new_zeros((tables.shape[0], C, hc._table_stride(C)))
        table[..., :C] = tables
        ring = emit.new_empty((inst.blocks, Km, inst.chains * inst.slab)) \
            if inst.ring == "global" else None
        held = [table, init, dur, emit, *outs, emit.new_empty((N, 2, hc._table_stride(C))), ring,
                torch.zeros(1, dtype=torch.int32, device=emit.device)]
        ints = [N, T, C, Km, *radix, 0 if inst.table == "shared" else -1, inst.slab,
                inst.chains, inst.smem_bytes, group]

    def run():
        err = fn(*[None if x is None else x.data_ptr() for x in held], *ints,
                 emit.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("launch failed with CUDA error {}".format(err))
    return run, outs


def compare_wide(runs, window_ms, clock, order, same=True):
    """Outputs equal across the versions (where `same`: they compute one
    function), then ms from CUDA events over `order`'s turns, each window
    about `window_ms`, and the SM clock readings inside each version's
    windows."""
    for run, _ in runs.values():
        run()
    torch.cuda.synchronize()
    names = list(runs)
    for v in names[1:] if same else ():
        for a, b in zip(runs[names[0]][1], runs[v][1]):
            if not torch.equal(a, b):
                raise RuntimeError("{} and {} differ at {} of {} entries".format(
                    names[0], v, int((a != b).sum()), a.numel()))
    fastest = min(event_ms(run, 1)[0] for run, _ in runs.values())
    n = int(min(1000, max(2, window_ms / fastest)))
    timed = [(v, *event_ms(runs[v][0], n)) for v in order]
    r = {"launches": n}
    for v in names:
        r[v.replace(" ", "_") + "_ms"] = [ms for w, ms, _ in timed if w == v]
        r[v.replace(" ", "_") + "_sm_mhz"] = clock_summary(
            clock.within([win for w, _, win in timed if w == v]))
    return r


def check_wide_plain(name, fn, inputs, kind, inst, plain):
    """One launch of a wide log or forward scan on `inputs` (the first
    frames of a shape), each output equal to `plain`'s (gamma, alphas,
    offsets of the plain scan on the same chains, with or without the
    fold, as the version computes); raises naming `name`."""
    run, outs = wide_launcher(fn, inputs, kind, inst)
    run()
    torch.cuda.synchronize()
    for k, out in zip(kind, outs):
        want = plain["gao".index(k)]
        if not torch.equal(out, want):
            raise RuntimeError("{}: {} differs from the plain scan at {} of {} entries".format(
                name, k, int((out != want).sum()), out.numel()))


def wide_inputs(pots, L):
    """{scan: inputs}: the forward chains of one expanded table (the max
    and forward scans, as the spans chain and the primal give them) and
    the stacked forward and reversed chains of two (the log scan)."""
    B = pots.emit.shape[0]
    stacked = hc._stack_fwd_rev(pots, L)
    forward = (stacked[0][0], *(x[:B] for x in stacked[1:]))  # one expanded table
    return {"viterbi": forward, "forward": forward, "log": stacked}


def k4_wide_inputs(pots, L, log_out):
    """K4 wide's inputs from a log scan's (gamma, alphas[, offsets]) of the
    stacked chains, as the backward forms them: one chunk a video in
    float32 where the scan does not fold (the wide route before the fold),
    else the chunks of ``_grad_band_inputs``."""
    B = pots.emit.shape[0]
    gamma, alphas = log_out[:2]
    if len(log_out) == 2:
        lse = torch.logsumexp(_finals(alphas[:B], L, pots.end_mask), dim=-1)
        G1, G2p, band = hc._band_inputs(pots, L, gamma)
        return (G1 - lse[:, None, None]).contiguous(), G2p, band
    lse, _ = _log_partition(alphas[:B], log_out[2][:B], L, pots.end_mask)
    gb = hc._grad_band_inputs(pots, L, gamma, log_out[2], lse)
    return gb.G1m, gb.G2p, gb.band


def run_wide(old_lib, new_lib, window_ms, clock, rng, device):
    """The wide scans against an earlier source of the current interface
    at WIDE_SHAPES (B = 18, T = 1,024, K = 20): each version's log and
    forward scans on the first WIDE_CHECK_T frames equal to the plain scan
    (with the fold where the version folds, ``wide_folds``; the max scans,
    and the log and forward scans where both fold, equal across the
    versions), then old, new, new, old with CUDA events on the route
    ``wide_scan_instance`` picks. Then K4 wide (its one source) on each
    version's band inputs, from replayed graphs in the same turns: one
    chunk a video where the version does not fold, the chunks of
    BAND_CHUNK rows where it does; qg, sa and st equal to the plain
    version's on each. Returns the results."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    folded = {"old": wide_folds(old_lib), "new": wide_folds(new_lib)}
    results = []
    for shape, B, T, C, K in WIDE_SHAPES:
        pots, L = potentials(rng, B, T, C, K, np.full(B, T, np.int64), device)
        inputs = wide_inputs(pots, L)
        Km = K - 1
        cut = (*inputs["log"][:3], inputs["log"][3][:, :WIDE_CHECK_T].contiguous())
        plain = {f: hc._scan_plain(*cut, "log", fold=f) for f in set(folded.values())}
        log_outs = {}
        for scan, symbol, kind in WIDE_SCANS:
            scan_in = inputs[scan]
            N = scan_in[3].shape[0]
            inst = hc.wide_scan_instance(C, Km, N, B, sms)
            runs = {}
            for v, lib in (("old", old_lib), ("new", new_lib)):
                v_kind = wide_kind(scan, kind, folded[v])
                fn = bind(lib, symbol, 7 + len(v_kind), 9 + (kind == "ab"))
                runs[v] = wide_launcher(fn, scan_in, v_kind, inst)
                if scan != "viterbi":
                    want = plain[folded[v]]
                    if scan == "forward":
                        want = [None, *(x[:B] for x in want[1:])]
                    check_wide_plain("{} {} {}".format(shape, v, scan), fn,
                                     (*scan_in[:3], scan_in[3][:, :WIDE_CHECK_T].contiguous()),
                                     v_kind, inst, want)
            same = scan == "viterbi" or folded["old"] == folded["new"]
            r = compare_wide(runs, window_ms, clock, ["old", "new", "new", "old"], same=same)
            if scan == "log":
                log_outs = {v: runs[v][1] for v in runs}
            r.update(shape=shape, scan=scan, chains=N, T=T, C=C, Km=Km, route=inst.route,
                     cluster=inst.cluster, slab=inst.slab, chains_per_block=inst.chains,
                     blocks=inst.blocks, threads=inst.threads, table=inst.table, ring=inst.ring,
                     old_folds=folded["old"],
                     change=np.mean(r["new_ms"]) / np.mean(r["old_ms"]) - 1)
            results.append(r)
            print("{:14s} wide {:8s} N={:2d} T={:5d} C={:4d} Km={:2d}, {} (cluster {}, {} chains "
                  "x {} classes a block, {} blocks): old {} ms, new {} ms ({:+.2%}); log and "
                  "forward outputs each equal to its plain scan on {} frames{}; SM clock old {}, "
                  "new {}".format(
                      shape, scan, N, T, C, Km, inst.route, inst.cluster, inst.chains,
                      inst.slab, inst.blocks, ["{:.4f}".format(x) for x in r["old_ms"]],
                      ["{:.4f}".format(x) for x in r["new_ms"]], r["change"], WIDE_CHECK_T,
                      ", outputs equal across the versions" if same else "",
                      r["old_sm_mhz"], r["new_sm_mhz"]), flush=True)
        # K4 wide on each version's band inputs (full-length log scans)
        k4_in = {v: k4_wide_inputs(pots, L, outs) for v, outs in log_outs.items()}
        runs = {}
        for v, band_in in k4_in.items():
            check_band_grad_plain("{} K4 wide on {}'s inputs".format(shape, v),
                                  hc.hsmm_band_grad_wide(*band_in), hc._band_grad_plain(*band_in))
            runs[v] = lambda band_in=band_in: hc.hsmm_band_grad_wide(*band_in)
        timed = [(v, *graph_ms(runs[v], N_GRAPH)) for v in ("old", "new", "new", "old")]
        r = {"shape": shape, "scan": "K4 wide", "chains": B, "T": T, "C": C, "Km": Km,
             "launches": N_GRAPH}
        for v in runs:
            G1m = k4_in[v][0]
            r[v + "_ms"] = [ms for w, ms, _ in timed if w == v]
            r[v + "_inputs"] = list(G1m.shape)
            r[v + "_chunks"] = G1m.shape[0] // B
            r[v + "_sm_mhz"] = clock_summary(clock.within([win for w, _, win in timed if w == v]))
        r["change"] = np.mean(r["new_ms"]) / np.mean(r["old_ms"]) - 1
        results.append(r)
        print("{:14s} K4 wide B={} T={} C={} Km={}: on {} chunk(s) a video ({} rows) {} ms, on {} "
              "chunks ({} rows) {} ms ({:+.2%}; graphs of {}, old, new, new, old); qg/sa/st equal "
              "to plain on both; SM clock old {}, new {}".format(
                  shape, B, T, C, Km, r["old_chunks"], r["old_inputs"][1],
                  ["{:.5f}".format(x) for x in r["old_ms"]], r["new_chunks"], r["new_inputs"][1],
                  ["{:.5f}".format(x) for x in r["new_ms"]], r["change"], N_GRAPH,
                  r["old_sm_mhz"], r["new_sm_mhz"]), flush=True)
    return results


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old_csrc", required=True, type=Path)
    parser.add_argument("--kernels", choices=("all", "scans", "traceback", "band_grad",
                                              "band_max", "wide"), default="all")
    parser.add_argument("--step0", action="store_true",
                        help="--kernels traceback or band_grad: the earlier kernels alone "
                             "(band_grad: and its split), nothing current built")
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="--kernels scans: these SHAPES names only (default: all)")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--window_ms", type=float, default=100.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.step0 and args.kernels not in ("traceback", "band_grad"):
        parser.error("--step0 takes --kernels traceback or band_grad")
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    sources = (args.kernels,) if args.kernels in ("band_grad", "band_max") else SOURCES
    if args.kernels == "wide":
        sources = ("hsmm_scan_wide",)
    old_libs = build_old(args.old_csrc, args.old_csrc / "build", sources)
    old_folds = folds(args.old_csrc)
    new_libs = {}
    if not args.step0:
        for name, log in _build.build(list(sources)).items():
            print_ptxas("new " + name, log)
        new_libs = {name: _build.load_library(name) for name in sources}
    print("built both versions in {:.1f} s".format(time.perf_counter() - t0), flush=True)

    device = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    results, tb_results, bg_results, bm_results, rule_results = [], [], [], [], []
    step_loops = []
    wide_results = []
    bg_opcodes = {}

    def clk(s):
        return "{}-{} MHz ({} readings)".format(s.get("min"), s.get("max"), s["n"])

    def record(r, shape, scan, inputs):
        N, T, C = inputs[3].shape
        old, new = np.mean(r["old_ms"]), np.mean(r["new_ms"])
        r.update(shape=shape, scan=scan, chains=N, T=T, C=C, Km=inputs[2].shape[1],
                 old_us_per_step=1e3 * old / T, new_us_per_step=1e3 * new / T,
                 speedup=old / new)
        results.append(r)
        print("{:18s} {:8s} N={:2d} T={:5d} C={:3d} Km={:3d}: old {} ms, new {} ms; "
              "{:.4f} -> {:.4f} us/step, x{:.2f}; SM clock old {}, new {}".format(
                  shape, scan, N, T, C, r["Km"],
                  ["{:.4f}".format(x) for x in r["old_ms"]],
                  ["{:.4f}".format(x) for x in r["new_ms"]],
                  r["old_us_per_step"], r["new_us_per_step"], r["speedup"],
                  clk(r["old_sm_mhz"]), clk(r["new_sm_mhz"])), flush=True)

    with SmClock(device.index or 0) as clock:
        if args.kernels == "wide":
            wide_results = run_wide(old_libs["hsmm_scan_wide"], new_libs["hsmm_scan_wide"],
                                    args.window_ms, clock, rng, device)
        if args.kernels == "band_max":
            fns = {"old": bind(old_libs["band_max"], "hsmm_band_max", 4, 5),
                   "new": bind(new_libs["band_max"], "hsmm_band_max", 4, 8)}
            for shape, B, T, C, K, lengths in BAND_MAX_SHAPES:
                inputs = band_max_inputs(B, T, C, K, lengths, rng, device)
                # Km: the band's rows (the model's K=1 table has one duration)
                r = {"shape": shape, "B": B, "T": T, "C": C, "Km": inputs[2].shape[1]}
                if shape == "serving":
                    r.update(band_max_step0(fns["old"], inputs))
                r.update(compare_band_max(fns, inputs, args.window_ms, clock))
                r["speedup"] = np.mean(r["old_ms"]) / np.mean(r["new_ms"])
                bm_results.append(r)
                t = r["tile"]
                print("{:22s} band max B={:2d} T={:5d} C={:3d} Km={:3d}: old {} ms, new {} ms "
                      "(graphs), x{:.2f}; one by one old {:.5f}, new {:.5f} ms; tile {} rows, "
                      "{} threads, slab {}, {} tiles a video, {} blocks an SM, {} waves, filling "
                      "{:.3f}, balance {:.3f}; fm equal old and plain; SM clock old {}, "
                      "new {}".format(
                          shape, B, T, C, r["Km"], ["{:.5f}".format(x) for x in r["old_ms"]],
                          ["{:.5f}".format(x) for x in r["new_ms"]], r["speedup"],
                          r["old_stream_ms"], r["new_stream_ms"], t["rows"], t["threads"],
                          t["slab"], t["tiles"], t["blocks_per_sm"], t["waves"], t["filling"],
                          t["balance"], clk(r["old_sm_mhz"]), clk(r["new_sm_mhz"])), flush=True)
            for shape, B, T, C, K, lengths in BAND_MAX_RULE_SHAPES:
                inputs = band_max_inputs(B, T, C, K, lengths, rng, device)
                r = {"shape": shape, "B": B, "T": T, "C": C, "Km": K - 1}
                r.update(compare_band_max_rule(fns["new"], inputs, args.window_ms, clock))
                r["speedup"] = np.mean(r["warps_ms"]) / np.mean(r["rule_ms"])
                rule_results.append(r)
                print("{:22s} band max tile rule B={:2d} T={:5d} C={:3d}: {} rows ({} blocks) "
                      "{} ms, warps alone {} rows ({} blocks) {} ms (graphs), x{:.2f}; fm equal "
                      "plain in both; SM clock {}, {}".format(
                          shape, B, T, C, r["rule_rows"], r["rule_blocks"],
                          ["{:.5f}".format(x) for x in r["rule_ms"]], r["warps_rows"],
                          r["warps_blocks"], ["{:.5f}".format(x) for x in r["warps_ms"]],
                          r["speedup"], clk(r["rule_sm_mhz"]), clk(r["warps_sm_mhz"])),
                      flush=True)
        if args.kernels == "band_grad":
            bg_results, bg_opcodes = run_band_grad(old_libs, new_libs, args.old_csrc,
                                                   args.window_ms, clock, rng, device, args.step0)
        if args.kernels in ("all", "scans"):
            step_loops = step_loop_readings(
                library_sass(args.old_csrc / "build" / "libhsmm_scan.so"),
                built_sass("hsmm_scan"))
        shapes = [s for s in SHAPES if args.shapes is None or s[0] in args.shapes]
        for shape, B, T, C, K, lengths in (shapes if args.kernels in ("all", "scans") else ()):
            stacked, forward = scan_inputs(B, T, C, K, lengths, rng, device,
                                           centred=shape.endswith(", centred"))
            for scan, symbol, lib, kind in SCANS:
                inputs = stacked if scan in ("max", "log") else forward
                kinds = {"old": kind, "new": kind}
                if scan in ("log", "forward"):
                    kinds = {"old": kind + "o" * old_folds, "new": kind + "o"}
                fns = {v: bind(libs[lib], symbol, 4 + len(kinds[v]), 8)
                       for v, libs in (("old", old_libs), ("new", new_libs))}
                record(compare(fns, kinds if scan in ("log", "forward") else kind, inputs,
                               args.window_ms, clock), shape, scan, inputs)
            if shape != "serving":
                continue
            # the max gamma scan and the backpointer scan at one chain count
            for N in (B, 2 * B):
                for scan, symbol, lib, kind, base in (
                        ("max", "hsmm_gamma_scan_max", "hsmm_scan", "g-", stacked),
                        ("viterbi", "hsmm_viterbi_scan", "hsmm_viterbi", "ab", forward)):
                    inputs = tuple(torch.cat([x, x])[:N].contiguous() for x in base)
                    fns = {v: bind(libs[lib], symbol, 4 + len(kind), 8)
                           for v, libs in (("old", old_libs), ("new", new_libs))}
                    record(compare(fns, kind, inputs, args.window_ms, clock),
                           "common chain count", scan, inputs)
        if args.kernels in ("all", "traceback"):
            old_sass = library_sass(args.old_csrc / "build" / "libhsmm_viterbi.so")
            probe = build_copy_probe(args.old_csrc / "build")
            tb_results = run_traceback(
                old_libs, new_libs, probe, args.window_ms, clock, rng, device, old_sass,
                built_sass("hsmm_viterbi") if new_libs else None)
    out = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "results": results, "step_loops": step_loops, "traceback": tb_results,
           "band_grad": bg_results,
           "band_grad_loop_opcodes": bg_opcodes,
           "band_max": bm_results, "band_max_rule": rule_results, "wide": wide_results}
    if args.out is not None:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"scan_ab": [{k: r[k] for k in ("shape", "scan", "chains", "Km",
                                                     "old_us_per_step", "new_us_per_step")}
                                  for r in results],
                      "step_loops": step_loops,
                      "traceback_ab": [{k: r[k] for k in (
                          "shape", "old_ms", "new_ms", "segments", "segments_longest_video",
                          "old_us_per_segment", "new_us_per_segment", "old_floor_ms",
                          "new_floor_ms") if k in r} for r in tb_results],
                      "band_grad_ab": [{k: r[k] for k in (
                          "shape", "old_ms", "new_ms", "old_stream_ms", "new_stream_ms",
                          "speedup", "differ_plain", "plain_st_denormals", "old_scratch_bytes",
                          "new_scratch_bytes", "plane_bytes", "old_floor", "new_floor")
                          if k in r} for r in bg_results],
                      "band_max_ab": [{k: v for k, v in r.items() if k not in (
                          "tile", "old_sm_mhz", "new_sm_mhz")} for r in bm_results],
                      "band_max_rule": [{k: v for k, v in r.items() if k not in (
                          "rule_sm_mhz", "warps_sm_mhz")} for r in rule_results],
                      "wide_ab": [{k: v for k, v in r.items() if not k.endswith("_sm_mhz")}
                                  for r in wide_results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
