"""Time the single path's host-bound legs of this tree against another
checkout's on one card, in turns.

The legs are ``chip_smoke.py`` phase 4g's cases (``run_host_cases``):
predict of the 18 S6 models over the val split, the constrained fit of 3
tasks, one ``--mix_tasks`` epoch through ``main.main`` and the U7 fit,
each streaming (``--sm_device_resident_mb 0``) and resident, none with
--data_parallel. Run from the repository root on a machine with a CUDA
card:

    python3 -m action_segmentation_torch.tools.fit_ab --old_tree OLD_DIR [--rounds N] [--wide [--repeats 3] | --step [--steps 20] [--classes 19]] [--out ab.json]

With ``--wide`` the legs are instead ``chip_smoke.py`` phase 4i(b)'s
serving over all 342 S6 classes: phase 4c's release, the S6 flags with
--mix_tasks, a closed-form fit, pickled and served by ``Segmenter.load``
with no valid_classes, ``segment_many`` over every val video once to warm
up and then `--repeats` times, each timed on the host clock to a device
sync; each turn prints the walls, frames/s and the wide kernels' launches
(the old tree's ``chip_smoke.py`` must have ``crosstask_args`` and phase
4c's constants, as from the wide DP's commit on).

With ``--step`` the leg is instead ``chip_smoke.py`` phase 4b's training
step: an unsupervised model of the synthetic corpus (C=19, K=20, D=300)
taking forward, backward, clip and Adam steps on one serving batch (B=18,
T=1024) already on the card, `--steps` steps a window on CUDA events,
three windows, the least kept, and the card's peak memory allocated over
them (the old tree's ``chip_smoke.py`` must have ``sm_args`` and
``cuda_ms``, as from the training slice's commit on). ``--classes
342,1577`` takes the same step at each of those widths instead, one
after another in each turn (a wide DP: W1 log, K4 wide, the pair sum),
on 18 videos where both trees sum the transition cotangent in
csrc/pair_grad.cu; where either tree forms the backward's whole (B, T,
C, C) pair exponent instead, on the most videos up to 18 whose exponent
fits 16 GiB (18 at 342 classes, 1 at 1,577), so that both trees take the
same batch. ``--old_tree .`` runs this tree alone, at 18 videos.

OLD_DIR is a checkout of an earlier commit, for example ``git archive
<commit> | tar -x -C OLD_DIR`` into a directory that .gitignore lists; its
``chip_smoke.py`` must have ``run_crosstask_slice`` and
``run_host_cases(device, root, models, mixed, smi, budget_mb)``, as from
the resident corpus's commit on. Each turn is a fresh process in one tree,
in the order old, new, new, old, `--rounds` times over: it builds the
tree's kernels, writes phase 4c's release and fits its 18 S6 models
(``run_crosstask_slice``), pays Adam's lazy imports, then runs the cases
streaming and resident and
prints one JSON line of each case's wall seconds, frames/s and busy share
(the kernels' time from a ``torch.profiler`` rerun over the wall). The
tool prints each case's walls by turn and the new/old ratios of the two
trees' mean and least walls, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import contextlib, io, json, shutil, sys, tempfile
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from action_segmentation_torch import main as port_main
from action_segmentation_torch.ops import _build

device = torch.device("cuda")
_build.build(["hsmm_scan", "band_max", "band_grad", "hsmm_viterbi"])
root = tempfile.mkdtemp(prefix="fit_ab_")
out = {}
try:
    with contextlib.redirect_stdout(sys.stderr):
        ct = cs.run_crosstask_slice(device, root)
        args = port_main.build_parser().parse_args(cs.cli_argv(root))
        with contextlib.redirect_stdout(io.StringIO()):
            mixed = port_main.make_data_splits(args)["all"][0]
        torch.optim.Adam([torch.zeros(1, requires_grad=True)])
        for budget in (0, None):
            cases = cs.run_host_cases(device, root, ct[-1], mixed, "", budget)
            for name, (rec, *_) in cases.items():
                out["{}, {}".format(rec["mode"], name)] = {
                    k: rec[k] for k in ("wall_s", "frames_per_s", "busy_share")}
finally:
    shutil.rmtree(root, ignore_errors=True)
print("FIT_AB " + json.dumps(out), flush=True)
"""


_WIDE_TURN = r"""
import contextlib, io, json, os, shutil, sys, tempfile, time
import numpy as np
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from action_segmentation_torch import checkpoint
from action_segmentation_torch import main as port_main
from action_segmentation_torch.api import Segmenter
from action_segmentation_torch.data import minigen
from action_segmentation_torch.data.crosstask import CrosstaskCorpus
from action_segmentation_torch.models.semimarkov import SemiMarkovModel
from action_segmentation_torch.ops import _build
from action_segmentation_torch.ops import hsmm_cuda as hc

device = torch.device("cuda")
_build.build(["hsmm_scan_wide", "hsmm_viterbi"])
root = tempfile.mkdtemp(prefix="fit_ab_")
wide = ("hsmm_viterbi_scan_wide", "hsmm_viterbi_traceback_wide")
try:
    with contextlib.redirect_stdout(sys.stderr):
        tasks = {t: ["step{}".format(i) for i in range(cs.CT_STEPS)]
                 for t in CrosstaskCorpus.TASK_IDS_BY_SET["primary"]}
        minigen.write_mini_crosstask(
            root, np.random.RandomState(0), tasks=tasks, related_tasks={}, n_train=cs.CT_TRAIN,
            n_val=cs.CT_VAL, dim_per_group=cs.CT_DIM_PER_GROUP, **cs.CT_RANGES)
        args = cs.crosstask_args(root, "--mix_tasks")
        with contextlib.redirect_stdout(io.StringIO()):
            train, _, val = port_main.make_data_splits(args)["all"]
        model = SemiMarkovModel.from_args(args, train, device=device)
        model.fit(train, use_labels=True)
        pkl = os.path.join(root, "s6_mix_tasks.pkl")
        checkpoint.save_pickle(model, pkl)
        seg = Segmenter.load(pkl)
        feats = [val[k]["features"] for k in val._tasks_and_video_names]
        frames = sum(f.shape[0] for f in feats)
        seg.segment_many(feats, batch_size=args.batch_size)
        walls = []
        for _ in range(int(sys.argv[1])):
            for n in wide:
                getattr(hc, n).launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg.segment_many(feats, batch_size=args.batch_size)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out = {"segment_many": {"wall_s": min(walls), "walls_s": walls,
                                "frames_per_s": frames / min(walls),
                                "launches": {n: getattr(hc, n).launches for n in wide}}}
finally:
    shutil.rmtree(root, ignore_errors=True)
print("FIT_AB " + json.dumps(out), flush=True)
"""


_STEP_TURN = r"""
import json, sys
import numpy as np
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from action_segmentation_torch.data.synthetic import SyntheticDatasplit
from action_segmentation_torch.models.base import clip_grads, make_optimizer
from action_segmentation_torch.models.semimarkov import SemiMarkovModel
from action_segmentation_torch.ops import _build
from action_segmentation_torch.ops import hsmm_cuda as hc

device = torch.device("cuda")
pair = hasattr(hc, "hsmm_pair_grad")  # csrc/pair_grad.cu: no (B, T, C, C) exponent
counted = ("hsmm_log_scan", "hsmm_band_grad", "hsmm_log_scan_wide", "hsmm_band_grad_wide") + (
    ("hsmm_pair_grad",) if pair else ())
classes = [int(c) for c in sys.argv[2].split(",")]
_build.build(["hsmm_scan", "band_grad"] + (["hsmm_scan_wide"] if max(classes) > 128 else [])
             + (["pair_grad"] if pair else []))
out = {}
for C in classes:
    train = SyntheticDatasplit(seed=0, num_videos=36, n_classes=C, max_len=cs.T, span_k=cs.K,
                               feature_dim=cs.D, shift=1.0)
    model = SemiMarkovModel.from_args(cs.sm_args(epochs=1), train, device=device)
    rng = np.random.RandomState(3)
    # where a tree of the comparison forms the backward's (B, T, C, C) pair
    # exponent, the most videos whose exponent fits 16 GiB
    T = cs.T
    B = cs.B if sys.argv[3] == "18" else max(1, min(cs.B, 2 ** 32 // (T * C * C)))
    batch = (torch.from_numpy(rng.randn(B, T, cs.D).astype(np.float32)).to(device),
             torch.full((B,), T, dtype=torch.int32, device=device),
             torch.arange(C, device=device), torch.arange(C, device=device),
             torch.zeros((B, T), dtype=torch.long, device=device),
             torch.zeros((B, T, C), device=device), torch.zeros((B, C), device=device),
             torch.ones((B,), device=device))
    params = list(model.module.parameters())
    optimizer, _ = make_optimizer(model.args, params)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss, _ = model._loss(*batch, use_labels=False)
        loss.backward()
        clip_grads(params, model.args.max_grad_norm)
        optimizer.step()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for n in counted:
        getattr(hc, n).launches = 0
    windows = [cs.cuda_ms(step, int(sys.argv[1])) for _ in range(3)]
    name = "train step" if classes == [cs.C] else "train step C={}".format(C)
    out[name] = {"wall_s": min(windows) / 1e3, "ms": windows, "B": B, "T": T,
                 "peak_mib": torch.cuda.max_memory_allocated(device) / 2 ** 20,
                 "launches": {n: getattr(hc, n).launches for n in counted}}
    del model, optimizer, params, batch, train
    torch.cuda.empty_cache()
print("FIT_AB " + json.dumps(out), flush=True)
"""


def turn(tree, wide=False, repeats=3, step=False, steps=20, classes="19", batch="18"):
    """One turn in `tree`: {case: {wall_s, frames_per_s, ...}}. `batch`:
    --step's videos, "18", or "rule" for the 16 GiB rule."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    if step:
        code = [_STEP_TURN, str(steps), classes, batch]
    else:
        code = [_WIDE_TURN, str(repeats)] if wide else [_TURN]
    proc = subprocess.run([sys.executable, "-c", *code], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("turn in {} failed ({}):\n{}".format(
            tree, proc.returncode, proc.stderr[-4000:]))
    line = [l for l in proc.stdout.splitlines() if l.startswith("FIT_AB ")][-1]
    return json.loads(line[len("FIT_AB "):])


def main(argv=None):
    cli = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_argument("--old_tree", required=True)
    cli.add_argument("--rounds", type=int, default=1)
    cli.add_argument("--wide", action="store_true",
                     help="phase 4i(b)'s segment_many over all 342 S6 classes")
    cli.add_argument("--repeats", type=int, default=3)
    cli.add_argument("--step", action="store_true",
                     help="phase 4b's unsupervised training step at the serving shape")
    cli.add_argument("--steps", type=int, default=20)
    cli.add_argument("--classes", default="19",
                     help="--step: the model's classes, one or several, comma-separated")
    cli.add_argument("--out", default=None)
    opts = cli.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    smi = smi.strip()
    order = [("old", opts.old_tree), ("new", "."), ("new", "."),
             ("old", opts.old_tree)] * opts.rounds
    pair_sum = all(os.path.exists(os.path.join(tree, "action_segmentation_torch", "csrc",
                                               "pair_grad.cu")) for tree in (opts.old_tree, "."))
    turns = []
    for which, tree in order:
        rec = turn(tree, opts.wide, opts.repeats, opts.step, opts.steps, opts.classes,
                   "18" if pair_sum else "rule")
        turns.append((which, rec))
        print(which, json.dumps(rec), flush=True)
    summary = {}
    for case in turns[0][1]:
        walls = {w: [rec[case]["wall_s"] for which, rec in turns if which == w]
                 for w in ("old", "new")}
        means = {w: sum(v) / len(v) for w, v in walls.items()}
        summary[case] = {"old_wall_s": walls["old"], "new_wall_s": walls["new"],
                         "new_over_old": means["new"] / means["old"],
                         "least_new_over_old": min(walls["new"]) / min(walls["old"]),
                         "busy": {w: [rec[case].get("busy_share") for which, rec in turns
                                      if which == w] for w in ("old", "new")},
                         "peak_mib": {w: [rec[case].get("peak_mib") for which, rec in turns
                                          if which == w] for w in ("old", "new")}}
        print("{}: old {} s, new {} s, new/old {:.4f} (means), {:.4f} (least){}; {}".format(
            case, ["{:.4f}".format(x) for x in walls["old"]],
            ["{:.4f}".format(x) for x in walls["new"]], summary[case]["new_over_old"],
            summary[case]["least_new_over_old"],
            "" if turns[0][1][case].get("peak_mib") is None else "; peak MiB old {}, new {}".format(
                summary[case]["peak_mib"]["old"], summary[case]["peak_mib"]["new"]), smi),
            flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"device": smi, "order": [w for w, _ in order], "turns": turns,
                       "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
