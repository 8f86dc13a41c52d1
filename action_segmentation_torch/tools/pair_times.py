"""Time the partition's transition cotangent on one card: the torch form,
its plain version and its kernel (csrc/pair_grad.cu).

The torch form is the chain that summed the pair posteriors before the
kernel (``ops/hsmm_grad.py`` ``_cotangents`` as of commit 369c5f0): the
whole (B, T, C, C) exponent formed, masked, exponentiated and summed over
frames, with no - Z where the chains fold (T > SCAN_FOLD), as it was
written there. The plain version (``hsmm_cuda._pair_grad_plain``) forms
the same exponent PAIR_CHUNK frames at a time. The inputs are the
backward's (``hsmm_grad._pair_inputs``) on the model's centred
potentials (``chip_smoke.serving_pots``, D=300, an expanded table), from
the kernel log scan and band gradient. Run from the repository root on a
machine with a CUDA card:

    python3 -m action_segmentation_torch.tools.pair_times [--step0] [--shapes NAME ...] [--out pair_times.json]

Shapes (B, T, C, K = 20): ``serving`` (18, 1,024, 19), ``s6`` (18, 1,024,
342), ``1577x1`` (1, 1,024, 1,577) and ``1577x18`` (18, 1,024, 1,577),
whose torch form (4 B T C^2 = 171 GiB) is not run. Each shape prints one
JSON line: the torch form's ms (CUDA events, the least of 2 windows of 2
calls after a warm call) and the memory it allocated past its inputs; with
no ``--step0``, also the plain version's ms (one window of 2), the kernel's
ms from a replayed CUDA graph of 50 launches, the kernel against the plain
version (rtol 1e-5 / atol 1e-4, the same bits in two launches) and its
bound (``chip_smoke.pair_grad_bound``: one expf a term at the
special-function units' 16 a clock per SM, fp32 operations, and the bytes
of X, Y, trans and the output). ``--step0`` times the torch form alone and
builds no pair kernel. The card's name and power limit lead the output.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"serving": (18, 1024, 19), "s6": (18, 1024, 342), "1577x1": (1, 1024, 1577),
          "1577x18": (18, 1024, 1577)}
# the torch form's exponent past this many bytes is not formed
TORCH_FORM_BYTES = 16 * 2 ** 30


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


def inputs(name, device):
    """The pair sum's inputs at shape `name` as the model's backward forms
    them (``chip_smoke.pair_inputs``), and whether its chains fold."""
    import numpy as np

    import chip_smoke as cs
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.ops.hsmm_grad import centre_emissions

    B, T, C = SHAPES[name]
    pots, lengths = cs.serving_pots(np.random.RandomState(24), B, T, C, cs.K, device)
    L = lengths.long()
    pots = centre_emissions(pots, L)[0]
    scan = hc.hsmm_log_scan(*hc._stack_fwd_rev(pots, L))
    return cs.pair_inputs(pots, L, scan), T > hc.SCAN_FOLD


def time_shape(name, device, step0, sms, clock_mhz):
    import torch

    import chip_smoke as cs
    from action_segmentation_torch.ops import hsmm_cuda as hc

    pair_in, fold = inputs(name, device)
    B, T, C = pair_in[0].shape
    rec = {"shape": name, "B": B, "T": T, "C": C, "fold": fold,
           "exponent_bytes": 4 * B * T * C * C, "torch_form_ms": None,
           "torch_form_alloc_mib": None}
    torch.cuda.synchronize()
    if 4 * B * T * C * C <= TORCH_FORM_BYTES:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        want = torch_form(*pair_in, fold)
        torch.cuda.synchronize()
        rec["torch_form_alloc_mib"] = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20
        rec["torch_form_ms"] = min(cs.cuda_ms(lambda: torch_form(*pair_in, fold), 2, warmup=0)
                                   for _ in range(2))
        del want
    if step0:
        return rec
    rec["plain_ms"] = cs.cuda_ms(lambda: hc._pair_grad_plain(*pair_in), 2, warmup=1)
    got, again = hc.hsmm_pair_grad(*pair_in), hc.hsmm_pair_grad(*pair_in)
    want = hc._pair_grad_plain(*pair_in)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, again), "{}: two launches differ".format(name))
    cs.assert_close("{} pair grad".format(name), got, want)
    tile = hc.pair_grad_tile(B, T, C, sms)
    bound_ms, bound_by, limit, times = cs.pair_grad_bound(pair_in, sms, clock_mhz)
    rec.update(ms=cs.graph_ms(lambda: hc.hsmm_pair_grad(*pair_in), cs.N_TIMED),
               max_abs_err=cs.max_err(got, want), bound_ms=bound_ms, bound_by=bound_by,
               bound_limit=limit, bytes_ms=times["bytes"], fp32_ms=times["fp32"],
               sfu_ms=times["sfu"], runs=tile.runs, frames=tile.frames,
               blocks=B * tile.tiles * tile.runs, waves=tile.waves, library_ms=None)
    return rec


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--step0", action="store_true", help="the torch form alone")
    cli.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    cli.add_argument("--out", default=None)
    opts = cli.parse_args(argv)
    sys.path.insert(0, os.getcwd())  # chip_smoke.py at the repository root
    import torch

    import chip_smoke as cs
    from action_segmentation_torch.ops import _build
    from action_segmentation_torch.tools.scan_floor import max_sm_clock_mhz

    if not torch.cuda.is_available():
        raise SystemExit("pair_times: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda")
    logs = _build.build(["hsmm_scan", "hsmm_scan_wide", "band_grad"]
                        + ([] if opts.step0 else ["pair_grad"]))
    for line in logs.get("pair_grad", "").splitlines():
        if "pair_grad" in line or "registers" in line or "spill" in line:
            print("[ptxas] " + line.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    records = []
    for name in opts.shapes:
        rec = time_shape(name, device, opts.step0, sms, clock_mhz)
        rec["card"] = smi
        records.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"card": smi, "step0": opts.step0, "shapes": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
