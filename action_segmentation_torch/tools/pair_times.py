"""Time the partition's transition cotangent on one card: the pair kernels
(csrc/pair_grad.cu: the tensor route, a float64 tensor-core product, and
the scalar route, one expf a term, which ``hsmm_pair_grad`` takes at C <=
32) against an earlier source in turns, beside the plain version and the
torch form, and how the tensor route splits each shape's tile-frames
between its product and its exact path.

The inputs are the backward's (``hsmm_grad._pair_inputs``) on the model's
centred potentials (``chip_smoke.serving_pots``, D=300, an expanded
table), from the kernel log scan and band gradient; ``fit`` is instead
the pair sum's inputs at each batch of phase 4c's constrained CrossTask
fit (``chip_smoke.run_crosstask_slice`` on a release written to a
temporary directory). Run from the repository root on a machine with a
CUDA card:

    python3 -m action_segmentation_torch.tools.pair_times [--old_csrc DIR] [--cuts] [--shapes NAME ...] [--out pair_times.json]
    python3 -m action_segmentation_torch.tools.pair_times --split [--device cpu] [--batch N] [--frames T] [--shapes NAME ...]

Shapes (B, T, C, K = 20): ``serving`` (18, 1,024, 19), ``fit`` (phase
4c's batches), ``s6`` (18, 1,024, 342), ``1577x1`` (1, 1,024, 1,577) and
``1577x18`` (18, 1,024, 1,577). At each shape it prints one JSON line:
``new``, the route ``hsmm_pair_grad`` takes, and at C <= 32 also
``tensor``, the tensor route on the same inputs, and ``scalar direct``,
the scalar route launched as the earlier source is (its lengths cast
once, outside the timed graph, where ``hsmm_pair_grad`` casts them on
each call); the tensor route held to
the plain version in float64 (each entry within the looser of rtol 1e-5 /
atol 1e-4 and the float32 plain version's own error at that entry),
the scalar route to the float32 plain version at rtol 1e-5 / atol 1e-4,
each the same bits in two launches; the tile-frames' split
(``hsmm_cuda.pair_grad_split``), each version's ms from replayed CUDA
graphs of 50 launches and the SM clock read through NVML inside those
windows, and the bounds: the tensor route's
(``chip_smoke.pair_grad_tensor_bound``: the larger of the bytes, 2 flops
a term at the FP64 tensor cores' 67 TFLOP/s and the operands' exps) and
the scalar kernel's (``chip_smoke.pair_grad_bound``: one expf a term at
the special-function units' 16 a clock per SM). With
``--old_csrc DIR`` (DIR/pair_grad.cu, an earlier source whose
``hsmm_pair_grad`` is the scalar kernel: ``git show
b6c8abb:action_segmentation_torch/csrc/pair_grad.cu``) that source is
built beside, held to the float32 plain version at rtol 1e-5 / atol
1e-4, and timed in the order old, new, new, old; each version's SASS
gives its loops' instructions (``scan_floor.pair_grad_floor``).
The scalar kernel's issue floor (its term loop's instructions a term,
``scan_floor.pair_grad_issue_ms``) goes beside each shape's times.
``--cuts`` times the scratch builds of ``PAIR_CUTS`` in the same turns (the
tensor route with its product, or its operands' exponentials, cut). The
plain version (one window of 2 calls) and the torch form (the least of 2
windows of 2, where its exponent fits 16 GiB) are timed once a shape. The
card's name and power limit lead the output.

``--split`` builds no kernel and runs on any device: the split and the
gaps' quantiles at each shape (``fit`` on a card only), its videos and
frames cut to ``--batch`` and ``--frames`` where given, then at
``chip_smoke.masked_pair_draw``'s draws (a masked pair dominating by 100,
800 and 5,000 nats).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

SHAPES = {"serving": (18, 1024, 19), "fit": None, "s6": (18, 1024, 342),
          "1577x1": (1, 1024, 1577), "1577x18": (18, 1024, 1577)}
# the torch form's exponent past this many bytes is not formed
TORCH_FORM_BYTES = 16 * 2 ** 30
# --cuts: scratch builds of csrc/pair_grad.cu with one part cut each (their
# sums are wrong; only their times are read): the product's mma (one FMA
# of the fragments kept, so that their loads stay), and the operands'
# exponentials (the staged value kept)
PAIR_CUTS = {
    "no product": [("mma_k8(acc[mb][nb], af[mb], bf[nb]);",
                    "acc[mb][nb][0] += af[mb][0] * bf[nb][0];")],
    "no operand exp": [("exp2_by_bits(fma((double)xs[f][sc], kLog2e, s.ya[f]))",
                        "((double)xs[f][sc])"),
                       ("exp2_by_bits(fma((double)ys[f][sc], kLog2e, s.yb[f]))",
                        "((double)ys[f][sc])")],
}


def torch_form(X, Y, trans, Z, lengths, fold):
    """The transition cotangent as the backward formed it at commit
    369c5f0: the whole exponent, - Z only where no chain folds."""
    import torch

    from action_segmentation_torch import BIG_NEG

    B, T, C = X.shape
    t_idx = torch.arange(T, device=X.device)[None, :]
    interior = (t_idx >= 1) & (t_idx < lengths[:, None])
    expo = X[:, :, None, :] + trans[:, None, :, :] + Y[:, :, :, None]
    if not fold:
        expo = expo - Z[:, None, None, None]
    pair = torch.exp(
        torch.where(interior[:, :, None, None], expo, torch.full_like(expo, BIG_NEG))
    )
    return pair.sum(dim=1)


def inputs(name, device, batch=None, frames=None):
    """The pair sum's inputs at shape `name` (its videos and frames cut to
    `batch` and `frames` where given) as the model's backward forms them
    (``chip_smoke.pair_inputs``)."""
    import numpy as np

    import chip_smoke as cs
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.ops.hsmm_grad import centre_emissions

    B, T, C = SHAPES[name]
    B, T = batch or B, frames or T
    pots, lengths = cs.serving_pots(np.random.RandomState(24), B, T, C, cs.K, device)
    L = lengths.long()
    pots = centre_emissions(pots, L)[0]
    scan = hc.hsmm_log_scan(*hc._stack_fwd_rev(pots, L))
    return cs.pair_inputs(pots, L, scan)


def fit_inputs(device):
    """The pair sum's inputs at each batch of phase 4c's constrained fit."""
    import contextlib

    import chip_smoke as cs

    root = tempfile.mkdtemp(prefix="pair_times_")
    with contextlib.redirect_stdout(sys.stderr):
        return cs.run_crosstask_slice(device, root)[4]


def split_line(pair_in):
    """The kernel's split of `pair_in`'s tile-frames and their gaps'
    quantiles (0, 0.5, 0.9, 0.99, 1)."""
    import numpy as np

    from action_segmentation_torch.ops import hsmm_cuda as hc

    _, _, _, gap, interior = hc.pair_scales(*pair_in)
    inside = gap[interior[:, :, None, None].expand_as(gap)].cpu().numpy()
    split = hc.pair_grad_split(*pair_in)
    return {"split": split._asdict(), "exact_share": split.exact_share,
            "gap_quantiles": (np.quantile(inside, [0, 0.5, 0.9, 0.99, 1]).tolist()
                              if inside.size else [])}


def run_split(opts, device):
    import numpy as np

    import chip_smoke as cs

    for name in opts.shapes:
        if name == "fit":
            if device.type != "cuda":
                continue
            batches = fit_inputs(device)
        else:
            batches = [inputs(name, device, opts.batch, opts.frames)]
        for k, pair_in in enumerate(batches):
            rec = {"shape": name, "batch": k, "B_T_C": list(pair_in[0].shape)}
            rec.update(split_line(pair_in))
            print(json.dumps(rec), flush=True)
    for C in (19, 342):
        for gaps in ((100.0,), (800.0,), (5000.0,), (100.0, 800.0, 5000.0)):
            pair_in = cs.masked_pair_draw(np.random.RandomState(C), 4, 256, C, gaps, device)
            rec = {"shape": "masked", "C": C, "gaps": list(gaps)}
            rec.update(split_line(pair_in))
            print(json.dumps(rec), flush=True)


def scalar_launcher(lib, pair_in, sms, symbol="hsmm_pair_grad"):
    """A call of a scalar kernel's launch, `symbol` of `lib` (the earlier
    source's ``hsmm_pair_grad``, or this tree's
    ``hsmm_pair_grad_scalar``), on `pair_in` in its own launch (32 x 32
    tiles, float32 partials), with its own counters and its lengths cast
    once, outside the call; returns the (B, C, C) cotangent."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc

    X, Y, trans, Z, L = pair_in
    B, T, C = X.shape
    tile = hc.pair_grad_tile(B, T, C, sms, "scalar")  # the scalar route's launch is its
    frames = tile.frames
    part = X.new_empty((tile.scratch_bytes // 4,)) if tile.runs > 1 else None
    tickets = torch.zeros(B * tile.tiles, dtype=torch.int32, device=X.device)
    L32 = L.to(torch.int32).contiguous()
    fn = getattr(lib, symbol)
    fn.argtypes = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)

    def run():
        out = X.new_empty((B, C, C))
        err = fn(*[None if t is None else t.data_ptr()
                   for t in (X, Y, trans, Z, L32, out, part, tickets)],
                 B, T, C, *trans.stride(), frames, X.device.index,
                 torch.cuda.current_stream(X.device).cuda_stream)
        if err:
            raise RuntimeError("{}: CUDA error {}".format(symbol, err))
        return out

    return run


def tensor_launcher(lib, pair_in, sms):
    """A launch of the ``hsmm_pair_grad`` of a library built from this
    tree's source (or a cut of it, ``PAIR_CUTS``) on `pair_in` in
    ``hsmm_cuda.pair_grad_tile``'s launch."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc

    X, Y, trans, Z, L = pair_in
    B, T, C = X.shape
    tile = hc.pair_grad_tile(B, T, C, sms, "tensor")
    L32 = L.to(torch.int32).contiguous()
    part = X.new_empty((tile.scratch_bytes // 8,), dtype=torch.float64) if tile.runs > 1 else None
    tickets = torch.zeros(B * tile.tiles, dtype=torch.int32, device=X.device)
    fn = lib.hsmm_pair_grad
    ints = [B, T, C, *trans.stride(), tile.frames]
    fn.argtypes = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * (len(ints) + 1) + (ctypes.c_void_p,)

    def run():
        out = X.new_empty((B, C, C))
        err = fn(*[None if t is None else t.data_ptr()
                   for t in (X, Y, trans, Z, L32, out, part, tickets)],
                 *ints, X.device.index, torch.cuda.current_stream(X.device).cuda_stream)
        if err:
            raise RuntimeError("hsmm_pair_grad: CUDA error {}".format(err))
        return out

    return run


def build_cuts(out_dir):
    """{cut: library} of scratch builds of this tree's csrc/pair_grad.cu,
    each with one part cut (``PAIR_CUTS``; each text must occur once), all
    nvcc at once."""
    from pathlib import Path

    from action_segmentation_torch.ops import _build
    from action_segmentation_torch.tools.scan_ab import build_old

    source = (_build.CSRC / "pair_grad.cu").read_text()
    libs = {}
    for name, edits in PAIR_CUTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError("cut {!r}: {!r} occurs {} times in csrc/pair_grad.cu".format(
                    name, old, text.count(old)))
            text = text.replace(old, new)
        d = Path(out_dir) / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "pair_grad.cu").write_text(text)
        libs[name] = d
    built = {}
    for name, d in libs.items():
        built[name] = build_old(d, d / "build", ("pair_grad",))["pair_grad"]
    return built


def time_shape(name, pair_in, versions, clock, sms, clock_mhz, scalar_ipt):
    """One shape's record: checks (none for a cut build), split, plain and
    torch form, each version's graph times in turns: the earlier source,
    this tree's versions, the same in reverse, the earlier source (old,
    new, new, old), and the scalar kernel's issue floor at `scalar_ipt`
    instructions a term."""
    import torch

    import chip_smoke as cs
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.tools.scan_ab import clock_summary, graph_ms
    from action_segmentation_torch.tools.scan_floor import pair_grad_issue_ms

    X, Y, trans, Z, L = pair_in
    B, T, C = X.shape
    fold = T > hc.SCAN_FOLD
    route = hc.pair_grad_tile(B, T, C, sms).route
    rec = {"shape": name, "B": B, "T": T, "C": C, "fold": fold, "route": route}
    rec.update(split_line(pair_in))
    want32 = hc._pair_grad_plain(*pair_in)
    want64 = hc._pair_grad_plain64(*pair_in)
    rec["plain_fp32_err"] = cs.max_err(want32, want64)
    for v, run in versions.items():
        if v.startswith("cut: "):
            continue
        got, again = run(), run()
        torch.cuda.synchronize()
        cs.check(cs.same_bits(got, again), "{} {}: two launches differ".format(name, v))
        if v in ("old", "scalar direct") or (v == "new" and route == "scalar"):  # scalar
            cs.assert_close("{} pair grad ({})".format(name, v), got, want32)
        else:
            cs.check_pair_rule("{} pair grad ({})".format(name, v), got, want32, want64)
        rec[v + "_max_abs_err_fp64"] = cs.max_err(got, want64)
    del want32, want64
    others = [v for v in versions if v != "old"]
    ends = ["old"] if "old" in versions else []
    order = ends + others + others[::-1] + ends
    times = {v: [] for v in versions}
    windows = {v: [] for v in versions}
    for v in order:
        ms, window = graph_ms(versions[v], cs.N_TIMED)
        times[v].append(ms)
        windows[v].append(window)
    for v in versions:
        rec[v + "_ms"] = times[v]
        rec[v + "_sm_mhz"] = clock_summary(clock.within(windows[v]))
    b_ms, _, b_kind, b_times = cs.pair_grad_tensor_bound(pair_in, sms, clock_mhz)
    s_ms, _, s_kind, _ = cs.pair_grad_bound(pair_in, sms, clock_mhz)
    rec.update(bound_ms=b_ms, bound_limit=b_kind, gemm_bound_ms=b_times["fp64 tensor"],
               operand_sfu_ms=b_times["sfu"], bytes_ms=b_times["bytes"],
               scalar_bound_ms=s_ms, scalar_bound_limit=s_kind,
               scalar_issue_floor_ms=pair_grad_issue_ms(scalar_ipt, cs.pair_terms(pair_in),
                                                        clock_mhz, sms))
    tile = hc.pair_grad_tile(B, T, C, sms, "tensor")
    rec.update(runs=tile.runs, frames=tile.frames, blocks=B * tile.tiles * tile.runs,
               waves=tile.waves)
    torch.cuda.synchronize()
    rec["plain_ms"] = cs.cuda_ms(lambda: hc._pair_grad_plain(*pair_in), 2, warmup=1)
    rec["torch_form_ms"] = None
    if 4 * B * T * C * C <= TORCH_FORM_BYTES:
        rec["torch_form_ms"] = min(cs.cuda_ms(lambda: torch_form(*pair_in, fold), 2, warmup=1)
                                   for _ in range(2))
    rec["library_ms"] = None
    return rec


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--old_csrc", default=None)
    cli.add_argument("--cuts", action="store_true",
                     help="also the scratch builds of PAIR_CUTS, in the same turns")
    cli.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    cli.add_argument("--split", action="store_true", help="the split alone, no kernel")
    cli.add_argument("--device", default="cuda")
    cli.add_argument("--batch", type=int, default=None)
    cli.add_argument("--frames", type=int, default=None)
    cli.add_argument("--out", default=None)
    opts = cli.parse_args(argv)
    sys.path.insert(0, os.getcwd())  # chip_smoke.py at the repository root
    import torch

    if opts.split:
        return run_split(opts, torch.device(opts.device))

    import chip_smoke as cs
    from action_segmentation_torch.ops import _build
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.tools.scan_ab import SmClock, build_old
    from action_segmentation_torch.tools.scan_floor import (
        built_sass,
        library_sass,
        max_sm_clock_mhz,
        pair_grad_floor,
    )

    if not torch.cuda.is_available():
        raise SystemExit("pair_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda")
    logs = _build.build(["hsmm_scan", "hsmm_scan_wide", "band_grad", "pair_grad"])
    for line in logs["pair_grad"].splitlines():
        if "pair_grad" in line or "registers" in line or "spill" in line:
            print("[ptxas] " + line.strip(), flush=True)
    floors = {"new": pair_grad_floor(built_sass("pair_grad"))}
    old_lib = None
    if opts.old_csrc:
        from pathlib import Path

        old = Path(opts.old_csrc)
        old_lib = build_old(old, old / "build", ("pair_grad",))["pair_grad"]
        floors["old"] = pair_grad_floor(library_sass(old / "build" / "libpair_grad.so"))
    print("floors " + json.dumps(floors), flush=True)
    scalar_ipt = next(v["instructions_per_term"] for v in floors["new"].values()
                      if v["design"] == "scalar")
    new_lib = _build.load_library("pair_grad")
    cut_libs = build_cuts(_build.BUILD / "pair_cuts") if opts.cuts else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    records = []
    with SmClock() as clock:
        for name in opts.shapes:
            batches = fit_inputs(device) if name == "fit" else [inputs(name, device)]
            for k, pair_in in enumerate(batches):
                versions = {}
                if old_lib is not None:
                    versions["old"] = scalar_launcher(old_lib, pair_in, sms)
                versions["new"] = lambda p=pair_in: hc.hsmm_pair_grad(*p)
                if pair_in[0].shape[2] <= hc.PAIR_NARROW_CLASSES:  # the tensor route beside
                    versions["tensor"] = tensor_launcher(new_lib, pair_in, sms)
                    # the scalar route launched as the earlier source is
                    versions["scalar direct"] = scalar_launcher(new_lib, pair_in, sms,
                                                                "hsmm_pair_grad_scalar")
                for cut, lib in cut_libs.items():
                    versions["cut: " + cut] = tensor_launcher(lib, pair_in, sms)
                rec = time_shape(name, pair_in, versions, clock, sms, clock_mhz, scalar_ipt)
                rec.update(batch=k, card=smi)
                records.append(rec)
                print(json.dumps(rec), flush=True)
                torch.cuda.empty_cache()
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"card": smi, "floors": floors, "shapes": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
