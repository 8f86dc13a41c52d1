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
each.

K3 (csrc/band_max.cu) has three duration loops, none with a barrier in
it: a start's (the loop that loads dur and G2p and stores the slab's
entry, STS), its twin above the tile (no store), and an output's fold
(the loop of shared loads and maxima). Its instructions a duration are
the loop's over the durations it runs a turn (one STS, FMNMX or LDS
each; the compiler unrolls two of them). Its floor is those instructions x the durations
each loop runs at the launch's shape (the starts of each tile and its
halo, r from Km - 1 down; the outputs' r <= t), over 32 lanes a warp,
issued by the SMs' 4 schedulers.

Run from the repository root on a machine with the CUDA toolkit:

    python3 -m action_segmentation_torch.tools.scan_floor [--B 18] [--C 19] [--Km 19] [--T 1024] [--segments 760] [--sass-dir DIR]

With `--sass-dir`, DIR holds `hsmm_scan.sass`, `hsmm_viterbi.sass`,
`band_grad.sass` and `band_max.sass` (cuobjdump's output) and nothing is
built. `--segments` is the most segments in one video for the
traceback's floor in time; B, T, C and Km size the band kernels'
launches (their tiles from `hsmm_cuda.band_grad_tile` and
`band_max_tile`). Prints one line per serving instance, one for the
traceback, one for K4, one for K3, and a JSON object last.
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
    band_grad_tile,
    band_max_tile,
    scan_instance,
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


def traceback_floor(sass):
    """(chain cycles, instructions) of one segment of the traceback's walk
    in csrc/hsmm_viterbi.cu's SASS."""
    body = walk_loop(parse_function(sass, "viterbi_traceback_kernel"))
    return chain_cycles(body)[0], sum(1 for ins in body if ins[2] != "NOP")


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
    warps (B x tiles x warps a block), over `sms` SMs of 4 schedulers."""
    tile = band_grad_tile(B, T, C, Km, sms)
    warps = B * tile.tiles * -(-tile.threads // 32)
    return instructions * Km * warps / (sms * SCHEDULERS) / clock_mhz * 1e-3


def innermost_loops(insts):
    """Every loop body (a backward branch's) that holds no other."""
    bodies = loops(insts, lambda ops: True)
    spans = [(body[0][0], body[-1][0]) for body in bodies]
    return [body for body, (a, b) in zip(bodies, spans)
            if not any((a, b) != (c, d) and a <= c and d <= b for c, d in spans)]


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
    parser.add_argument("--sass-dir", type=Path, default=None)
    parser.add_argument("--clock-mhz", type=float, default=None,
                        help="SM clock for the floor in time (default: nvidia-smi's max)")
    args = parser.parse_args()

    sass = {}
    for lib in ("hsmm_scan", "hsmm_viterbi", "band_grad", "band_max"):
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
    insts, mufu = band_grad_floor(sass["band_grad"])
    bg = {"instructions_per_duration": insts, "mufu_per_duration": mufu, "B": args.B,
          "tile": band_grad_tile(args.B, args.T, args.C, args.Km)._asdict(),
          "issue_floor_ms": band_grad_issue_ms(insts, args.B, args.T, args.C, args.Km, clock)}
    print("band grad duration loop: {} instructions ({} MUFU) a duration; B={} T={} C={} Km={} "
          "-> issue floor {:.5f} ms".format(insts, mufu, args.B, args.T, args.C, args.Km,
                                            bg["issue_floor_ms"]))
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
    print(json.dumps({"scan_floor": results, "traceback_floor": tb, "band_grad_floor": bg,
                      "band_max_floor": bm,
                      "C": args.C, "Km": args.Km, "T": args.T, "clock_mhz": clock}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
