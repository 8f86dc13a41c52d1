"""The training partition's float32 accuracy on the compound model's
emissions, as the log scans' per-class fold limit and K4's chunk vary.

Two steps. First, on a machine with a card (or with ``--device cpu``):

    python3 -m action_segmentation_torch.tools.fold_sweep capture --out u7_pots.pt

writes ``chip_smoke.py`` phase 4c's CrossTask release into a temporary
directory, takes the U7 command's first unsupervised batch (phase 4h(b)'s
``first_step``) for the whole batch and for each of two ranks' shares
through the partition's kernels, prints the whole batch's gradients
against the shares' sum (the largest relative norm of a parameter's
difference), and saves the partition's inputs of the three (the centred
potentials and lengths the Function takes). Then, on the CPU:

    python3 -m action_segmentation_torch.tools.fold_sweep sweep u7_pots.pt [--limits inf 4096] [--chunks 1024 16]

evaluates the Function's gradients of logZ through the plain versions in
float32 for each (``SCAN_FOLD_LIMIT``, ``BAND_CHUNK``) pair, and prints,
by the largest relative norm over trans, init, lens and emit: the whole
batch's against the first share's on its videos (their inputs differ only
by the model's rounding between the two batch shapes), the whole batch's
against float64 (the PLAIN path in float64 on the same inputs), and the
frame marginals' largest |sum_c - 1|; then the same for float64 itself
and for autograd of the plain partition in float32 (JAX's route). First
it prints how often each limit's per-class fold fires on the whole
batch's forward chains.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

import torch

from action_segmentation_torch.ops import hsmm as th
from action_segmentation_torch.ops import hsmm_cuda as hc
from action_segmentation_torch.ops import hsmm_grad as hg

def capture(out, device):
    """Phase 4h(b)'s U7 first steps (the whole batch, rank 0's share, rank
    1's) through the kernels; saves each one's partition inputs."""
    import chip_smoke as cs
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.parallel.mesh import Mesh, single_mesh

    caught = []
    forward = hg.HsmmPartitionFB.forward

    def spy(ctx, trans, init, lens, emit, end_mask, lengths, kernels):
        caught.append([x.detach().cpu().clone()
                       for x in (trans, init, lens, emit, end_mask, lengths)])
        return forward(ctx, trans, init, lens, emit, end_mask, lengths, kernels)

    root = tempfile.mkdtemp(prefix="fold_sweep_")
    hg.HsmmPartitionFB.forward = staticmethod(spy)
    try:
        cs.write_ct_release(root)
        parser = port_main.build_parser()
        with contextlib.redirect_stdout(io.StringIO()):
            mixed = port_main.make_data_splits(parser.parse_args(cs.cli_argv(root)))["all"][0]
        args = parser.parse_args(cs.cli_argv(root, "--sm_component_model", "--epochs", "2"))
        steps = [cs.first_step(SemiMarkovModel.from_args(args, mixed, device=device), mixed,
                               mesh)
                 for mesh in (single_mesh(device), Mesh(None, 0, 2, device),
                              Mesh(None, 1, 2, device))]
    finally:
        hg.HsmmPartitionFB.forward = forward
        shutil.rmtree(root, ignore_errors=True)
    whole, shares = steps[0][1], steps[1:]
    worst = max(cs.rel_norm(shares[0][1][k] + shares[1][1][k], w) for k, w in whole.items())
    torch.save({"whole": caught[0], "share0": caught[1], "share1": caught[2]}, out)
    print(json.dumps({"device": str(device), "shapes": [list(c[3].shape) for c in caught],
                      "kernels_whole_vs_shares": worst, "out": out}))


def rel_norm(got, want):
    got, want = got.double(), want.double()
    scale = float(want.norm())
    return float((got - want).norm()) / scale if scale else float((got - want).norm())


def gradients(inputs, fn, dtype=torch.float32):
    """d sum(logZ) / d (trans, init, lens, emit) of `fn` (pots, lengths)."""
    xs = [x.to(dtype).clone().requires_grad_(True) for x in inputs[:5]]
    fn(th.HsmmPotentials(*xs), inputs[5]).sum().backward()
    return [x.grad for x in xs[:4]]


def scores(whole, share, exact, lengths):
    """(whole against share on the share's videos, whole against float64,
    the marginal gap)."""
    n = share[0].shape[0]
    emit = whole[3]
    live = torch.arange(emit.shape[1])[None] < lengths[:, None]
    return {"whole_vs_share": max(rel_norm(s, w[:n]) for s, w in zip(share, whole)),
            "vs_float64": max(rel_norm(w, x) for w, x in zip(whole, exact)),
            "marginal_gap": float((emit.sum(-1) - 1)[live].abs().max())}


def fold_rates(emit, lengths, limit):
    """The shares of a video's (class, step) pairs and of its steps at
    which ``_scan_plain``'s per-class fold fires on the forward chains."""
    B, T, C = emit.shape
    cum = torch.zeros(B, C, dtype=emit.dtype)
    fires = torch.zeros(B, T, C, dtype=torch.bool)
    for t in range(T):
        cum = cum + emit[:, t]
        fires[:, t] = cum.abs() > limit
        cum = torch.where(fires[:, t], torch.zeros_like(cum), cum)
        if t % hc.SCAN_FOLD == hc.SCAN_FOLD - 1:
            cum = torch.zeros_like(cum)
    live = torch.arange(T)[None] < lengths[:, None]
    return (float(fires[live].float().mean()), float(fires.any(-1)[live].float().mean()))


def sweep(path, limits, chunks):
    pots = torch.load(path)
    whole, share = pots["whole"], pots["share0"]
    lengths = whole[5].long()
    for limit in limits:
        pair, step = fold_rates(whole[3], lengths, limit)
        print(json.dumps({"fold_limit": limit, "fires_class_steps": pair,
                          "fires_chain_steps": step}), flush=True)
    plain64 = lambda p, L: hg.hsmm_partition_fast(p, L, hg.PLAIN)  # noqa: E731
    exact = gradients(whole, plain64, torch.float64)
    rows = [dict(path="float64", **scores(exact, gradients(share, plain64, torch.float64),
                                          exact, lengths))]
    autograd = lambda p, L: th.hsmm_partition(p, L)  # noqa: E731
    rows.append(dict(path="autograd float32", **scores(
        gradients(whole, autograd), gradients(share, autograd), exact, lengths)))
    saved = hc.SCAN_FOLD_LIMIT, hc.BAND_CHUNK
    try:
        for limit in limits:
            for chunk in chunks:
                hc.SCAN_FOLD_LIMIT, hc.BAND_CHUNK = limit, chunk
                fast = hg.hsmm_partition_fast
                rows.append(dict(path="plain float32", fold_limit=limit, chunk=chunk, **scores(
                    gradients(whole, fast), gradients(share, fast), exact, lengths)))
                print(json.dumps(rows[-1]), flush=True)
    finally:
        hc.SCAN_FOLD_LIMIT, hc.BAND_CHUNK = saved
    for row in rows[:2]:
        print(json.dumps(row))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="step", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("--out", required=True)
    cap.add_argument("--device", default="cuda")
    swp = sub.add_parser("sweep")
    swp.add_argument("pots")
    swp.add_argument("--limits", type=float, nargs="+", default=[float("inf"), 4096.0])
    swp.add_argument("--chunks", type=int, nargs="+", default=[1024, 256, 64, 16, 8])
    args = parser.parse_args(argv)
    if args.step == "capture":
        sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the repository root
        capture(args.out, torch.device(args.device))
    else:
        sweep(args.pots, args.limits, args.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
