"""Drive the PyTorch/CUDA port's decode, training and exact-spans paths,
its command line, its compound model, its baselines, its resident
corpus, its data parallelism and its wide DP (to 342 classes, and past
1,024) on one card and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one or more lines each; any failure ends the run with a non-zero
exit and no result line:

  1. device  — card name, count, and nvidia-smi's name and power limit;
  2. build   — the six kernel sources from action_segmentation_torch/csrc
               with nvcc for sm_90a, all at once, printing ptxas'
               register/smem/spill lines (a serving scan instance, a wide
               kernel, a band kernel or a pair kernel that spills, or a
               band or pair kernel above the registers its tile rule
               assumes, fails the run);
  3. kernels — each decode kernel against its plain PyTorch version on the
               card at the serving width (B=18, T=1024, C=19, K=20, D=300)
               and at the edge cases (ragged lengths down to 1 with bucket
               padding, a BIG_NEG end mask, C=128, K=1, T=12,000, a batch
               shorter than the band): the gamma scan at rtol 1e-5 / atol
               1e-4, the band max's fm equal; and the kernels' labels
               against the traceback Viterbi;
  3b. kernels (train) — the log scan (gamma, alphas) and its forward-only
               form (alphas) against their plain versions at rtol 1e-5 /
               atol 1e-4, the band gradient's qg, sa and st equal to its
               plain version's (denormal sums included) and its lg at
               rtol 1e-5 / atol 1e-4 (summed over T by tiles), the pair
               sum (csrc/pair_grad.cu) on the backward's X, Y and Z, the
               same bits in two launches (an expanded table, a table a
               video, T <= 64 where Z = logZ): at C <= 32 its scalar
               route at rtol 1e-5 / atol 1e-4 of the float32 plain
               version, past it its tensor route against the plain
               version in float64, within the looser of that tolerance
               and the float32 plain version's own error,
               and logZ and
               the five gradients of the kernel forward/backward against
               the same Function through the plain versions (float32) at
               rtol 2e-3 / atol 2e-4, at the serving width and the same
               edge cases plus the masked-transition case; the Function
               against autograd of the plain partition at rtol 2e-3 /
               atol 2e-4, in float32 with unit-scale emissions over 256
               frames and in float64 at the full serving shape; and the
               frame-marginal sums' gap from 1 at the serving shape;
  3c. kernels (viterbi) — the backpointer scan (alphas at rtol 1e-5 /
               atol 1e-4, codes equal) and the traceback (spans equal)
               against their plain versions, the whole spans chain against
               its plain version, and the spans' frame labels against the
               labels chain's (equal except at near-ties that float64
               shows to be genuine), at the serving shape with unit-scale
               and D=300-scale emissions and at the edge cases;
  4. slice   — synthetic corpus, closed-form fit, SemiMarkovModel.predict
               and Segmenter.segment_many at batch 18, Accuracy MoF; the
               launch counters must show both decode kernels on both paths
               (the band max's inputs kept at each of its launches);
  4b. train slice — on the same corpus: an unsupervised fit of 3 epochs
               (its epoch loss must fall) and a closed-then-gradient
               discriminative fit of 2 epochs (MoF above 10x chance), each
               launching the log scan, the band gradient and the pair sum
               once per training batch; a no-grad partition through the
               forward-only scan; Segmenter.segment_with_marginals on 3
               videos, whose labels must equal segment's (segment_many of
               the one video: the same potentials' bits), with no pair sum
               (the marginals ask for d logZ / d emit alone);
  4c. crosstask slice — a CrossTask release on disk (the 18 primary
               tasks of 9 steps, D=300, written by data/minigen.py), the
               S6 flags through main.make_data_splits: per task a 342-class
               closed-form model whose predict decodes through the
               exact-spans kernels only (MoF and F1 by accuracy_corpus, MoF
               above 10x chance), Segmenter(task=).segment_many equal to
               predict, a constrained unsupervised fit (ordering and
               narration at train, its loss must fall, the training kernels
               once per batch; the band gradient's inputs kept at each of
               its launches) and a decode with narration at test;
  4d. cli    — the port's command line, action_segmentation_torch.main.main
               in process on the card, on 4c's release: the S6 closed-form
               command with model and prediction output (stats equal to
               4c's, a pickle a task, a prediction file a val video, the
               exact-spans kernels once a val batch); decoding from the
               saved models (the same stats; a pickle loads onto the card,
               and onto the CPU when asked); an unsupervised --mix_tasks
               run checkpointed every epoch, --epochs 2 then --epochs 3
               --resume, against an uninterrupted --epochs 3 (the resumed
               run runs epoch 2 alone; its loss and final parameters at
               rtol 1e-5; the log scan and band gradient launched; a
               --profile_dir trace naming both kernels); a Breakfast
               release at the fisher vectors' width (D=64) through the
               labels chain; each leg's wall time and frames/s;
  4e. u7     — the compound model: the paper's U7 command (the compound
               HSMM, unsupervised, canonical ordering and narration at
               train; 342 classes at D=300) through main.main on 4c's
               release, 2 epochs a task (finite losses whose mean falls,
               K2-log and K4 at least once a training batch, every decode
               through K6 and its traceback, MoF finite on each split, a
               compound pickle a task); decoding from those pickles on the
               card (stats equal); the U7 flags with --mix_tasks, --epochs 1
               then --epochs 2 --resume against an uninterrupted --epochs 2
               (the resumed epoch's loss and parameters bit for bit; a
               --profile_dir trace naming both training kernels); and the
               compound model with a 16-wide latent and the scaled flow on
               the synthetic corpus, 2 epochs through K2-log and K4 then a
               decode through K2-max and K3, and its resume bit-equal to
               the uninterrupted fit; each leg's wall time and launches,
               and the phase's;
  4f. baselines — the seven baselines through main.main on 4c's release:
               the Gaussian mixture with each --gm_covariance under the S6
               flags against the same command with device='cpu' (labels
               equal but at float64 near-ties, stats, the failed fp32
               Cholesky factors equal on both sides, cuSOLVER's verdicts
               printed beside them); the linear, 2-hidden-layer and BiLSTM
               taggers, 2 epochs, pickled and decoded (stats equal),
               parameters and Adam's moments on the card, the first step's
               loss (rtol 1e-5) and gradients (rtol 2e-3 / atol 2e-4)
               against the CPU's; the five host baselines under the JAX
               fixture's data flags against the CPU (the oracle's MoF 1.0);
               the mixture on a D=64 Breakfast release; every edit distance
               the phase computed against the numpy DP; accuracy_corpus
               native against plain; no kernel may launch;
  4g. resident — the resident corpus on 4c's release. Step 0: the
               streaming path (--sm_device_resident_mb 0), its host time a
               batch split by time.perf_counter into the datasplit reads,
               collation and padding, _batch_device_args and upload, and the
               card's busy share (the kernels' time from a torch.profiler
               rerun over the unprofiled wall time), for predict of the 18 S6
               models over val, the constrained fit, one --mix_tasks
               command-line epoch and the U7 fit on the --mix_tasks train
               split; then the same cases resident. (a) The constrained and U7
               fits, resident against streaming: epoch losses and parameters
               bit for bit, K2-log and K4 once a training batch; (b) predict:
               labels equal on every val frame, K6 and its traceback once a
               batch; (c) a resident --mix_tasks main.main run --epochs 2,
               then --epochs 3 --resume, against an uninterrupted --epochs 3
               (the resumed epoch's loss and parameters bit for bit); (d)
               --sm_device_resident_mb 1 streams and gives (c)'s first run's
               losses and stats; (e) the profiled resident U7 fit copies its
               corpus to the card once and, after it, no batch (no copy the
               size of a batch's features, fewer copies than batches); (f)
               streaming against resident: wall time, frames/s, busy share,
               the builds' time and bytes;
  4h. dp     — data parallelism over videos (parallel/mesh.py) on 4c's
               release. Step 0: two gloo ranks spawned on the card (NCCL
               refuses one card twice) and an NCCL group of one each
               all_reduce (SUM and MAX) and broadcast CUDA tensors. (a)
               World 1 under NCCL: 4d's unsupervised --mix_tasks command,
               --epochs 2, with --data_parallel against the same command
               without it: epoch losses, the last checkpoint's parameters,
               the pickled models' val labels and the stats bit for bit;
               K2-log and K4 once a training batch, K6 and its traceback
               once a decode batch. (b) Two gloo ranks on the card against
               4g's single resident runs: the first unsupervised step of
               the constrained and U7 fits (bit-equal to the two ranks'
               shares summed in one process; against the whole batch,
               loss rtol 1e-5, each gradient tensor within 1e-4 of its
               norm, which a rank's share alone is not; the whole batch's
               within 1e-3 of the same step with its partition in
               float64), the constrained
               fit (3 tasks x 2 epochs) and the U7 fit (each epoch's loss
               within rtol 1e-4 or twice the single path's own spread over
               two fits whose batches sum their videos in another order;
               each rank's parameters bit-equal to rank 0's), the
               constrained fit DP
               resident against DP streaming bit for bit, predict of the 18
               S6 models (labels equal on every val frame), the kernels
               once a batch on each rank. (c) A two-rank main.main
               --mix_tasks epoch with pickles and predictions: only rank 0
               writes, the ranks' stats equal, the epoch loss at rtol 1e-4
               and MoF/F1 within 0.05 of 4g's single run. (d)
               graft_entry.dryrun_multichip(2) on the card (every stage
               OK, the labels and training kernels launched) and
               graft_entry.entry's forward step (K1 once, logZ against the
               plain partition). (e) Each leg's wall, frames/s and busy
               share at 1 rank (4g's) and 2 ranks, and the collectives'
               share of each rank's wall;
  4i. wide   — a DP wider than 128 classes: (a) the wide kernels (the
               three instances of csrc/hsmm_scan_wide.cu, the traceback's
               wide instance, K4's wide kernel) at C = 129, 342 and 1,024, Km = 1,
               19, 25 and 64, ragged lengths down to 1, and at the S6
               shape (B=18, T=1024, C=342, K=20; the log scans' plain
               versions at its first 256 frames), each equal to its plain
               version, W1 on the route it picks and on the grid route's
               launches; (b) the S6 model over all 342 classes (the S6
               flags with --mix_tasks on 4c's release, closed form,
               pickled) served by Segmenter.load with no valid_classes:
               segment_many over every val video equal to the same
               Segmenter on the CPU but at float64-verified ties, through
               the wide kernels only; segment_with_marginals on 3 videos
               (labels equal, marginals against the PLAIN Function on
               the card at rtol 2e-3 / atol 2e-4, the sums' gap from 1
               reported; no pair sum); (c) an unsupervised 2-epoch fit at
               a 160-wide DP (its first step's loss at rtol 1e-5 and
               gradients at rtol 2e-3 / atol 2e-4 against the CPU's
               autograd path, falling losses, the wide log scan, K4's wide
               kernel and the pair sum once a batch) and a no-grad
               partition through the wide forward scan; the pair sum in
               (a) at every case and at B=2, T=1,024, C=342 against its
               plain version, and where a masked pair dominates each
               frame by 100 to 5,000 nats (the exact path's share
               printed), and with a NaN in X, Y, Z and trans (NaN where
               the plain version has it); (d) each wide kernel's time at the S6 shape
               beside its plain version's and its bound, K4's wide
               kernel's also beside its lg scratch, its floor with the
               cross-tile sum and the narrow kernel's time in its own
               tile on the same inputs, W1's also on the
               grid route (a finding: the cluster route runs there), W2's also beside
               its floor (the longest video's segments x its walk's chain
               from the SASS, plus its first tile's bytes at the memory
               rate), its ring's slots and rows and the earlier kernel's
               time, and the
               phase's seconds;
  4j. past1024 — a DP wider than 1,024 classes: (a) the wide kernels
               (W1 on the grid route, by the rule and with its table
               slab and ring in global memory and its chains over two
               launches; W2 at
               radix 2,048 and 4,096; K4's wide kernel) at C = 1,025,
               1,577, 2,048 and 3,000, Km = 1,
               20 and 64, ragged lengths down to 1, each equal to its
               plain version; (b) a release of the 18 primary and 65
               related tasks (2 training videos a related task, none for
               val) written by data/minigen.py, the S6 flags with
               --mix_tasks --crosstask_training_data primary related
               through main.main (closed form, val decoded within each
               video's task, pickled: 1,577 classes), Segmenter.load of the pickle with no
               valid_classes: segment_many over every val video against
               the same Segmenter's plain chain on the card and, on the 3
               shortest, the CPU Segmenter (labels equal but at float64-
               verified ties), the wide kernels only;
               segment_with_marginals on the 3 shortest against the PLAIN
               Function on the card; segment_with_marginals over all 1,577
               classes on one video of 8,192 frames (labels equal to
               segment_many's, marginals finite, the sums' gap within
               0.05, the peak allocation; no pair sum); one unsupervised
               gradient step of a 1,577-class model at B=18, T=1,024 (its
               ms and peak allocation; the pair sum once); the pair sum in
               (a) at every case and at B=2, T=1,024, C=1,577 against its
               plain version; (c) at B=18, T=1024, C=1,577, K=20
               each of those kernels' time beside its plain version's
               (the log and forward scans' at 128 frames), its bound and
               its floor from the SASS (K4's as in 4i (d); the grid route's with its
               barrier alone, the empty-step probe), each scan's grid,
               and the max and forward scans with the batch's one
               expanded table, the log scan with its two, and each with
               a table copied a chain, bit-equal, in turns;
  5. times   — CUDA-event kernel and plain-version times at the serving
               shape beside the roofline bound, the traceback's also beside
               its serial floor (the longest video's segments x one
               segment's dependent chain, read from the kernel's SASS by
               tools/scan_floor.py) and at each CrossTask predict batch
               (spans equal to the plain version's there too); the band
               gradient from a replayed CUDA graph and launched one by
               one, with its wrapper's host time a call, beside its bound
               (the larger of bytes, fp32 operations and the special-
               function units' three transcendentals a term) and its issue
               floor (the duration loop's instructions from the SASS x Km
               x the launch's warps over the SMs' schedulers), at the
               serving shape and at each batch of the constrained
               CrossTask fit (checked against the plain version there
               too, qg, sa and st equal to the plain version's); the band
               max the same way (its issue floor from its
               two duration loops' instructions, read from the SASS, which
               must hold no barrier), at the serving shape and at each
               predict and segment_many batch of the synthetic slice (fm
               equal to the plain version's there too); the pair sum's
               scalar route from a replayed CUDA graph beside its bound
               (the larger of bytes, fp32 operations and one expf a term
               on the special-function units), its issue floor, the
               tensor route's kernel on the same inputs, the torch form
               (the whole (B, T, C, C) exponent) and its plain version,
               at the serving shape and at each batch of the constrained
               CrossTask fit (against the plain version there too); the
               tensor route's at the S6 shape (4i) and at 1,577 classes
               (4j) beside the scalar route's kernel and its bound (the
               FP64 tensor cores' rate);
               segment_many
               frames/s, one training step's time, the fit's frames/s and
               the CrossTask predict's frames/s.

The line before the last is one JSON object {"kernels": [...]} (each
kernel's launches on the slices' paths, and its cli_, u7_, baseline_,
resident_ and dp_launches on phases 4d-4h, dp_ every rank's summed; the
wide kernels' launches, K4's wide kernel's among them, are phase 4i's;
each wide kernel's past_1024_ keys are phase 4j's, the pair sum's tensor
route, hsmm_pair_grad, among them; its scalar route, hsmm_pair_grad_narrow,
counts the narrow paths'); the last is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import argparse
import contextlib
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# serving shape: one CrossTask task (steps + per-step backgrounds), three
# 100-dim PCA feature groups, the default --sm_max_span_length, a
# CrossTask-length video, 18 videos per batch
B, T, C, K, D = 18, 1024, 19, 20, 300
N_TIMED = 50
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 op/s;
# special-function-unit operations a clock per SM (CUDA programming guide,
# compute capability 9.0)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# the FP64 tensor cores' peak, flops a second (NVIDIA's data sheet, H100 SXM)
PEAK_FP64_TENSOR = 67e12
SFU_PER_SM_CLOCK = 16
# tolerances of the JAX package's own tests: scores (tests/test_hsmm_pallas.py)
# and the partition's gradients (tests/test_hsmm_grad.py)
RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
GRAD_NAMES = ("logZ", "trans", "init", "lens", "emit", "end_mask")
# the model's partition over centred emissions against float64 at the D=300
# serving case (B=1, T=1024, C=19) and at B=2, T=12,000 (serving_pots, seed
# 0, lengths 12,000 and 7,001): max |sum_c marginal - 1| and the gradients'
# max abs errors (tests/test_torch_centred_partition.py,
# tests/test_torch_long_video.py)
CENTRED_BOUNDS = {"serving case": dict(gap=0.01, emit=0.01, trans=0.5, lens=1.0),
                  "T=12000": dict(gap=0.05, emit=0.05)}
TPU_FILE = "action_segmentation_tpu/ops/hsmm_pallas.py"
# the crosstask slice: every primary CrossTask task with 9 steps; with
# --annotate_background_with_previous a task has 2 * 9 + 1 = 19 classes
# (20 after the class bucket) and the model 18 * 19 = 342
CT_STEPS, CT_TRAIN, CT_VAL, CT_DIM_PER_GROUP = 9, 6, 4, 100
# tasks of the constrained unsupervised fit (one model each)
CT_FIT_TASKS = 3
CT_RANGES = dict(bkg_range=(10, 60), step_range=(30, 90), gap_range=(5, 30))
# phase 4f's per-task legs (the Gaussian mixtures, the taggers) run on a
# release written as phase 4c's with these training and val videos a task:
# every task and its model's width stay, the legs take half the time
BASELINE_TRAIN, BASELINE_VAL = 3, 2
S6_FLAGS = ("--dataset", "crosstask", "--features", "pca", "--task_specific_steps",
            "--annotate_background_with_previous")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, msg):
    print("[{}] {}".format(name, msg), flush=True)


def serving_pots(rng, b, t, c, k, device, lengths=None, end_mask=None):
    """Potentials as bench.build_inputs draws them (same numpy stream):
    features, Gaussian means, covariance, transition/init logits, Poisson
    log-rates; through the port's distributions on `device`."""
    import torch

    from action_segmentation_torch.ops.distributions import (
        gaussian_emission_log_probs,
        initial_log_probs,
        poisson_length_log_probs,
        transition_log_probs,
    )
    from action_segmentation_torch.ops.hsmm import HsmmPotentials

    feats = rng.randn(b, t, D).astype(np.float32)
    means = rng.randn(c, D).astype(np.float32)
    cov = np.abs(rng.randn(D).astype(np.float32)) + 0.5
    trans_logits = rng.randn(c, c).astype(np.float32)
    init_logits = rng.randn(c).astype(np.float32)
    log_rates = rng.randn(c).astype(np.float32) * 0.3 + 1.5
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    emit = gaussian_emission_log_probs(dev(feats), dev(means), dev(cov))
    if lengths is None:
        lengths = np.full(b, t, np.int32)
    # zero the padding like collate does
    emit = emit * (torch.arange(t, device=device)[None, :, None] < dev(lengths)[:, None, None])
    trans = transition_log_probs(dev(trans_logits))
    init = initial_log_probs(dev(init_logits))
    lens = poisson_length_log_probs(dev(log_rates), k)
    if end_mask is None:
        end_mask = np.zeros((b, c), np.float32)
    pots = HsmmPotentials(
        trans=trans.expand(b, c, c),
        init=init.expand(b, c),
        lens=lens.expand((b,) + lens.shape),
        emit=emit.contiguous(),
        end_mask=dev(end_mask),
    )
    return pots, dev(lengths)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def assert_close(name, got, want, rtol=RTOL, atol=ATOL):
    import torch

    check(bool(torch.isfinite(got).all()), name + ": non-finite values")
    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    except AssertionError as e:
        raise RuntimeError("{}: kernel disagrees with its plain version\n{}".format(name, e))


def check_equal(name, got, want):
    import torch

    check(torch.equal(got, want), "{}: {} of {} entries differ from the plain version".format(
        name, int((got != want).sum()), got.numel()))


def grad_inputs(pots, lengths, gamma, alphas, offsets):
    """K4's inputs (G1m, G2p, band) as the partition's backward forms them
    (``_grad_band_inputs``: a launch over each video's chunks, at every
    width) from a log scan's planes of the stacked chains and their
    offsets."""
    from action_segmentation_torch.ops.hsmm_cuda import _grad_band_inputs
    from action_segmentation_torch.ops.hsmm_grad import _log_partition

    B = pots.emit.shape[0]
    lse, _ = _log_partition(alphas[:B], offsets[:B], lengths, pots.end_mask)
    gb = _grad_band_inputs(pots, lengths, gamma, offsets, lse)
    return gb.G1m, gb.G2p, gb.band


def check_band_grad(name, got, want):
    """K4's qg, sa and st equal to the plain version's (the same float32
    operations in the same order, denormal sums included); lg within the
    score tolerance (its sum over T is associated by the kernel's tiles)."""
    for n, k, p in zip(("qg", "sa", "st"), got, want):
        check_equal("{} {}".format(name, n), k, p)
    assert_close(name + " lg", got[3], want[3])


def pair_inputs(pots, lengths, scan_out):
    """The pair sum's inputs (X, Y, trans, Z, lengths) as the partition's
    backward forms them (``hsmm_grad._pair_inputs``) from a log scan's
    planes of the stacked chains and their offsets: K4 (its wide kernel
    above 128 classes) over the band inputs, then X, Y and Z."""
    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_grad_chunked,
        _grad_band_inputs,
        hsmm_band_grad,
    )
    from action_segmentation_torch.ops.hsmm_grad import _log_partition, _pair_inputs

    gamma, alphas, offsets = scan_out
    B, T = pots.emit.shape[:2]
    L = lengths.long().clamp(min=1)
    lse, _ = _log_partition(alphas[:B], offsets[:B], L, pots.end_mask)
    gb = _grad_band_inputs(pots, L, gamma, offsets, lse)
    qg = _band_grad_chunked(hsmm_band_grad, gb, T)[0]
    X, Y, Z = _pair_inputs(pots, gb, qg, alphas[:B], lse)
    return X, Y, pots.trans, Z, L


def check_pair_rule(name, got, want32, want64, rtol=RTOL, atol=ATOL):
    """The pair kernel's sum `got` against the plain version in float64,
    `want64`: NaN where it is NaN and nowhere else, finite where it is
    finite, and each finite entry within the looser of rtol / atol and the
    float32 plain version's own error at that entry (|want32 - want64|,
    none where want32 is not finite). Returns (the kernel's max abs error
    against float64, the float32 plain version's, the entries within that
    error and past rtol / atol), over the finite entries."""
    import torch

    nan = want64.isnan()
    check(torch.equal(got.isnan(), nan), "{}: NaN in {} entries where the plain version in "
          "float64 has it in {}".format(name, int(got.isnan().sum()), int(nan.sum())))
    live = torch.isfinite(want64)
    check(bool(torch.isfinite(got[live]).all()),
          name + ": non-finite values where the plain version in float64 is finite")
    w = want64[live]
    gap = (got.double()[live] - w).abs()
    err32 = (want32.double()[live] - w).abs()
    err32 = torch.where(torch.isfinite(err32), err32, torch.zeros_like(err32))
    tol = atol + rtol * w.abs()
    bad = gap > torch.maximum(tol, err32)
    check(not bool(bad.any()), "{}: {} of {} entries past the looser of rtol {} / atol {} and "
          "the float32 plain version's own error there against float64 (largest {:g})".format(
              name, int(bad.sum()), bad.numel(), rtol, atol, float(gap.max())))
    if not gap.numel():
        return 0.0, 0.0, 0
    return float(gap.max()), float(err32.max()), int((gap > tol).sum())


def same_bits(a, b):
    """Whether two float32 tensors hold the same bits (NaN included)."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# the pair sum's largest error against the plain version in float64 on
# each route, over every check_pair_grad of the run (the kernels line's)
PAIR_ERRS = {"tensor": 0.0, "scalar": 0.0}


def check_pair_grad(name, pair_in):
    """The pair sum on the route ``hsmm_pair_grad`` takes, against the plain
    version on the same inputs, the same bits in two launches (NaN
    included): the tensor route against the plain version in float64
    (``check_pair_rule``), the
    scalar route (C <= 32) against the float32 plain version at rtol 1e-5 /
    atol 1e-4 (each term the same float32 operations, the sum over frames
    associated by pass, thread and run). Prints the route's error against
    float64 beside the float32 plain version's (and on the tensor route
    the entries held by the float32 error alone), and how the tensor route
    splits (or would split) the tile-frames: product, exact path, left out.
    Returns the route's max abs error against float64 and adds it to
    PAIR_ERRS."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import (
        PAIR_NARROW_CLASSES,
        _pair_grad_plain,
        _pair_grad_plain64,
        hsmm_pair_grad,
        pair_grad_split,
    )

    got, again = hsmm_pair_grad(*pair_in), hsmm_pair_grad(*pair_in)
    want32, want64 = _pair_grad_plain(*pair_in), _pair_grad_plain64(*pair_in)
    torch.cuda.synchronize()
    route = "scalar" if pair_in[0].shape[2] <= PAIR_NARROW_CLASSES else "tensor"
    held = 0
    if route == "scalar":
        assert_close(name + " pair grad", got, want32)
        err, err32 = max_err(got, want64), max_err(want32, want64)
    else:
        err, err32, held = check_pair_rule(name + " pair grad", got, want32, want64)
    check(same_bits(got, again), name + " pair grad: two launches differ")
    PAIR_ERRS[route] = max(PAIR_ERRS[route], err)
    split = pair_grad_split(*pair_in)
    phase("pair grad", "{} {}: the {} route; max |kernel - fp64 plain| {:g} (fp32 plain's {:g}; "
          "{} entries past rtol / atol within it); two launches equal; the tensor route's split "
          "of {} tile-frames: {} product, {} exact path ({:.6f}), {} left out".format(
              name, tuple(pair_in[0].shape), route, err, err32, held, split.frames,
              split.product, split.exact, split.exact_share, split.dead))
    return err


def pair_masked_cases(device):
    """The tensor route where a masked pair dominates each frame
    (``masked_pair_draw``, B=4, T=300): gaps of 100, 800 and 5,000 nats
    mixed a frame at C = 70 and 342 (the product, the exact path and the
    left-out tile-frames in one launch), and every frame 5,000 nats at C =
    64, one tile whose every interior tile-frame takes the exact path;
    each finite and against the plain version in float64
    (``check_pair_grad``); and NaN among the mixed draw's X, Y, Z and
    trans at C = 70 (``nan_pair_draw``), NaN where the plain version has
    it. Returns {case: (max abs error, exact-path share)}."""
    from action_segmentation_torch.ops.hsmm_cuda import pair_grad_split

    out = {}
    for Cn, gaps in ((70, (100.0, 800.0, 5000.0)), (342, (100.0, 800.0, 5000.0)),
                     (64, (5000.0,))):
        pair_in = masked_pair_draw(np.random.RandomState(Cn), 4, 300, Cn, gaps, device)
        name = "masked C={} gaps {}".format(Cn, "/".join("{:g}".format(g) for g in gaps))
        out[name] = (check_pair_grad(name, pair_in), pair_grad_split(*pair_in).exact_share)
    check(out["masked C=64 gaps 5000"][1] == 1.0,
          "the 5,000-nat draw at one tile did not take the exact path on every tile-frame")
    pair_in = nan_pair_draw(np.random.RandomState(7), 300, 70, device)
    out["NaN C=70"] = (check_pair_grad("NaN C=70", pair_in), pair_grad_split(*pair_in).exact_share)
    return out


def masked_pair_draw(rng, b, t, c, gaps, device):
    """Pair-sum inputs (X, Y, trans, Z, lengths) where a masked pair
    dominates every frame: a class drawn a frame stands `gap` above the
    others in X and in Y (X, Y = -gap / 2 + 3 N(0, 1), that class's +gap),
    the gap drawn a frame from `gaps`, and the table's diagonal BIG_NEG
    (log-Dirichlet rows, expanded over the batch), so that the masked
    pair's exponent is about gap above the best unmasked pair's (about 0;
    Z = 0.1 N(0, 1)); lengths ragged down to 1."""
    import torch

    from action_segmentation_torch import BIG_NEG

    gap = np.asarray(gaps, np.float64)[rng.randint(len(gaps), size=(b, t))]
    top = rng.randint(c, size=(b, t))
    X = rng.randn(b, t, c) * 3 - gap[..., None] / 2
    Y = rng.randn(b, t, c) * 3 - gap[..., None] / 2
    bi, ti = np.meshgrid(np.arange(b), np.arange(t), indexing="ij")
    X[bi, ti, top] += gap
    Y[bi, ti, top] += gap
    trans = np.log(rng.dirichlet(np.ones(c), size=c))
    trans[np.arange(c), np.arange(c)] = BIG_NEG
    Z = rng.randn(b) * 0.1
    lengths = rng.randint(1, t + 1, size=b)
    lengths[0] = t
    if b > 1:
        lengths[-1] = 1
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)  # noqa: E731
    return (dev(X), dev(Y), dev(trans).expand(b, c, c), dev(Z),
            torch.from_numpy(lengths).long().to(device))


def nan_pair_draw(rng, t, c, device):
    """``masked_pair_draw`` (6 videos of `t` frames, gaps of 100, 800 and
    5,000 nats, a table of each video's own) with a NaN in each of its
    inputs: X of video 0 at interior frame 1 (and at frame 0, which no sum
    reads), Y of video 1 at frame 1, Z of video 2, trans of video 3, and Z
    and trans of video 4, whose one frame has no interior boundary (its sum
    stays 0); videos 0-3 at least 2 frames."""
    X, Y, trans, Z, L = masked_pair_draw(rng, 6, t, c, (100.0, 800.0, 5000.0), device)
    X, Y, trans, Z, L = X.clone(), Y.clone(), trans.contiguous(), Z.clone(), L.clone()
    nan = float("nan")
    X[0, 1, 3 % c] = X[0, 0, (c - 1) // 2] = nan
    Y[1, 1, c - 1] = nan
    Z[2] = Z[4] = nan
    trans[3, c // 3, c - 1] = trans[4, 0, 0] = nan
    L[:4] = L[:4].clamp(min=2)
    L[4] = 1
    return X, Y, trans, Z, L


def unit_pots(rng, b, t, c, k, device, lengths=None, end_mask=None):
    """Potentials as the JAX package's gradient tests draw them:
    log-softmax transitions and initial scores, unit normal durations
    and emissions. Float32 holds the partition's gradient to the
    gradient tolerance over a few hundred frames at this scale."""
    import torch

    from action_segmentation_torch.ops.hsmm import HsmmPotentials

    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    trans = torch.log_softmax(dev(rng.randn(b, c, c).astype(np.float32)), dim=1)
    init = torch.log_softmax(dev(rng.randn(b, c).astype(np.float32)), dim=1)
    lens = rng.randn(b, k, c).astype(np.float32)
    lens[:, 0] = -1e9
    emit = rng.randn(b, t, c).astype(np.float32)
    if lengths is None:
        lengths = np.full(b, t, np.int32)
    if end_mask is None:
        end_mask = np.zeros((b, c), np.float32)
    return HsmmPotentials(trans, init, dev(lens), dev(emit), dev(end_mask)), dev(lengths)


def value_and_grads(pots, partition):
    """[logZ, d/dtrans, d/dinit, d/dlens, d/demit, d/dend_mask] of
    partition(the five potentials).sum()."""
    xs = [x.detach().clone().requires_grad_(True) for x in pots]
    z = partition(*xs)
    z.sum().backward()
    return [z.detach()] + [x.grad for x in xs]


def partition_grads(pots, lengths, kernels=None):
    """value_and_grads of the kernel forward/backward, or of the same
    Function through `kernels` (the plain versions: ``PLAIN``)."""
    from action_segmentation_torch.ops.hsmm_grad import KERNELS, hsmm_partition_fb

    return value_and_grads(
        pots, lambda *xs: hsmm_partition_fb(*xs, lengths, kernels or KERNELS))


def autograd_grads(pots, lengths):
    """value_and_grads of autograd through the plain partition."""
    from action_segmentation_torch.ops.hsmm import HsmmPotentials, hsmm_partition

    return value_and_grads(pots, lambda *xs: hsmm_partition(HsmmPotentials(*xs), lengths))


def centred_grads(pots, lengths):
    """value_and_grads of the model's partition: the kernel forward/backward
    over emissions centred frame by frame, plus their offset
    (``hsmm_partition_centred``)."""
    from action_segmentation_torch.ops.hsmm import HsmmPotentials
    from action_segmentation_torch.ops.hsmm_grad import hsmm_partition_centred

    return value_and_grads(
        pots, lambda *xs: hsmm_partition_centred(HsmmPotentials(*xs), lengths))


def d300_case(device, b=1, t=1024, c=19, seed=10):
    """The CPU tests' D=300 case (tests/test_torch_centred_partition.py,
    B=1, T=1024, C=19, K=20, seed 10): the same numpy draws and the port's
    distributions on the CPU, then copied to `device`; each video's own
    rows."""
    import torch

    from action_segmentation_torch.ops.distributions import (
        gaussian_emission_log_probs,
        initial_log_probs,
        poisson_length_log_probs,
        transition_log_probs,
    )
    from action_segmentation_torch.ops.hsmm import HsmmPotentials

    rng = np.random.RandomState(seed)
    feats, means = rng.randn(b, t, D), rng.randn(c, D)
    cov = np.abs(rng.randn(D)) + 0.5
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    pots = [
        transition_log_probs(f32(rng.randn(c, c))).expand(b, c, c),
        initial_log_probs(f32(rng.randn(c))).expand(b, c),
        poisson_length_log_probs(f32(rng.randn(c) * 0.3 + 1.5), K).expand(b, K, c),
        gaussian_emission_log_probs(f32(feats), f32(means), f32(cov)),
        torch.zeros(b, c),
    ]
    return (HsmmPotentials(*(x.contiguous().to(device) for x in pots)),
            torch.full((b,), t, dtype=torch.int32, device=device))


def float64_errors(name, got, exact, lengths, finite=True):
    """{"gap": max |sum_c marginal - 1|, and each gradient's max abs error
    against `exact`} of `got` (value_and_grads lists); with `finite`,
    every value of `got` must be finite."""
    out = {"gap": marginal_gap(got[4], lengths)}
    out.update((n, max_err(g, x)) for n, g, x in zip(GRAD_NAMES, got, exact))
    check(not finite or all(bool(g.isfinite().all()) for g in got),
          "{}: non-finite logZ or gradients".format(name))
    return out


def assert_grads_close(name, got, want):
    for n, g, w in zip(GRAD_NAMES, got, want):
        assert_close("{} {}".format(name, n), g, w, GRAD_RTOL, GRAD_ATOL)
    return max(max_err(g, w) for g, w in zip(got, want))


def check_labels(name, pots, lengths, got, want, got_scores, want_scores, few_ties=True,
                 gaps=None):
    """Labels equal except at frames where the two are a genuine tie:
    their float64 max-marginals (the plain chain rerun in float64 on the
    same potentials) differ by less than the score tolerance; with
    `few_ties`, at most max(2, length // 200) such frames a video. Scores
    within RTOL/ATOL. Returns the number of tie frames; each tie frame's
    (float64 gap, tolerance) is appended to the list `gaps` where given."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_max_plain,
        _gamma_scan_plain,
        _max_marginals,
    )

    assert_close(name + " scores", got_scores, want_scores)
    Tn = got.shape[1]
    valid = torch.arange(Tn, device=got.device)[None, :] < lengths.long().clamp(min=1)[:, None]
    check(bool((got[~valid] == -1).all()), name + ": labels past length are not -1")
    mism = (got != want) & valid
    n_mism = int(mism.sum())
    if n_mism == 0:
        return 0
    pots64 = type(pots)(*(x.double() for x in pots))
    fm64 = _max_marginals(pots64, lengths, _gamma_scan_plain, _band_max_plain)
    b_idx, t_idx = mism.nonzero(as_tuple=True)
    best = fm64[b_idx, t_idx].amax(dim=1)
    picked = fm64[b_idx, t_idx, got[b_idx, t_idx]]
    gap = best - picked
    tol = RTOL * best.abs() + ATOL
    if gaps is not None:
        gaps.extend(zip(gap.tolist(), tol.tolist()))
    per_video = mism.sum(dim=1)
    bound = torch.clamp(lengths.long() // 200, min=2)
    check(
        (not few_ties or bool((per_video <= bound).all())) and bool((gap <= tol).all()),
        "{}: {} label mismatches, float64 gaps {} (tolerance {})".format(
            name, n_mism, gap[:8].tolist(), tol[:8].tolist()
        ),
    )
    return n_mism


def kernel_case(name, pots, lengths):
    """Both kernels and the whole labels chain against their plain
    versions on the same inputs; returns per-kernel max abs errors."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_inputs,
        _band_max_plain,
        _gamma_scan_plain,
        _stack_fwd_rev,
        hsmm_band_max,
        hsmm_gamma_scan,
        hsmm_viterbi_labels,
        hsmm_viterbi_labels_plain,
    )

    L = lengths.long().clamp(min=1)
    scan_in = _stack_fwd_rev(pots, L)
    gamma_k, _ = hsmm_gamma_scan(*scan_in)
    gamma_p, _ = _gamma_scan_plain(*scan_in)
    torch.cuda.synchronize()
    assert_close(name + " gamma", gamma_k, gamma_p)

    band_in = _band_inputs(pots, L, gamma_k)
    fm_k = hsmm_band_max(*band_in)
    fm_p = _band_max_plain(*band_in)
    torch.cuda.synchronize()
    check_equal(name + " band max", fm_k, fm_p)

    labels_k, scores_k = hsmm_viterbi_labels(pots, lengths)
    labels_p, scores_p = hsmm_viterbi_labels_plain(pots, lengths)
    ties = check_labels(name, pots, lengths, labels_k, labels_p, scores_k, scores_p)
    errs = {"gamma": max_err(gamma_k, gamma_p), "band": max_err(fm_k, fm_p)}
    phase(
        "kernels",
        "{}: B={} T={} C={} K={} gamma max_abs_err={:g} band max_abs_err={:g} "
        "label ties={}".format(
            name, pots.emit.shape[0], pots.emit.shape[1], pots.emit.shape[2],
            pots.lens.shape[1], errs["gamma"], errs["band"], ties,
        ),
    )
    return errs, scan_in, band_in


def log_scans_case(name, pots, lengths):
    """K2 log and K1 against their plain versions on the same inputs,
    gamma, alphas and offsets each equal (the fold included); returns
    ((gamma, alphas, offsets) of K2 log, the stacked inputs, the forward
    chains' inputs, {"log_scan", "forward_scan": max abs errors})."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import (
        _forward_scan_plain,
        _log_scan_plain,
        _stack_fwd_rev,
        hsmm_forward_scan,
        hsmm_log_scan,
    )

    B = pots.emit.shape[0]
    scan_in = _stack_fwd_rev(pots, lengths.long().clamp(min=1))
    got = hsmm_log_scan(*scan_in)
    want = _log_scan_plain(*scan_in)
    fwd_in = tuple(x[:B] for x in scan_in)  # the primal's forward chains
    fwd_got = hsmm_forward_scan(*fwd_in)
    fwd_want = _forward_scan_plain(*fwd_in)
    torch.cuda.synchronize()
    for what, k, p in zip(("gamma", "alphas", "offsets"), got, want):
        check_equal("{} log scan {}".format(name, what), k, p)
    for what, k, p in zip(("alphas", "offsets"), fwd_got, fwd_want):
        check_equal("{} forward scan {}".format(name, what), k, p)
    errs = {"log_scan": max(max_err(k, p) for k, p in zip(got, want)),
            "forward_scan": max(max_err(k, p) for k, p in zip(fwd_got, fwd_want))}
    return got, scan_in, fwd_in, errs


def train_case(name, pots, lengths):
    """The four training kernels and the kernel forward/backward against
    their plain versions on the same inputs (the scans equal, K4 on each
    video's chunks, the pair sum on the backward's X, Y and Z); returns
    max abs errors and the serving inputs of each kernel."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import _band_grad_plain, hsmm_band_grad
    from action_segmentation_torch.ops.hsmm_grad import PLAIN

    B = pots.emit.shape[0]
    L = lengths.long().clamp(min=1)
    (gamma_k, alphas_k, offsets_k), scan_in, fwd_in, errs = log_scans_case(name, pots, lengths)
    grad_in = grad_inputs(pots, L, gamma_k, alphas_k, offsets_k)
    bg_k = hsmm_band_grad(*grad_in)
    bg_p = _band_grad_plain(*grad_in)
    torch.cuda.synchronize()
    check_band_grad("{} band grad ({} chunks)".format(name, grad_in[0].shape[0] // B), bg_k,
                    bg_p)

    pair_in = pair_inputs(pots, L, (gamma_k, alphas_k, offsets_k))
    pair_err = check_pair_grad(name, pair_in)

    fb_kernel = partition_grads(pots, lengths)
    fb_err = assert_grads_close(name + " partition_fb kernels vs plain", fb_kernel,
                                partition_grads(pots, lengths, PLAIN))
    errs.update(band_grad=max(max_err(k, p) for k, p in zip(bg_k, bg_p)), pair_grad=pair_err,
                partition_fb=fb_err)
    phase(
        "kernels (train)",
        "{}: B={} T={} C={} K={} log scan max_abs_err={:g} forward scan {:g} band grad "
        "{:g} pair grad {:g} ({} trans, Z {}; two launches equal); logZ and grads kernels "
        "vs plain max_abs_err={:g}; kernel path's max |sum_c marginal - 1| {:g}, max "
        "|d logZ / d emit| {:g}".format(
            name, B, pots.emit.shape[1], pots.emit.shape[2], pots.lens.shape[1],
            errs["log_scan"], errs["forward_scan"], errs["band_grad"], pair_err,
            "expanded" if pots.trans.stride(0) == 0 else "per-video",
            "logZ" if pots.emit.shape[1] <= 64 else "0 (anchored per chunk)", fb_err,
            marginal_gap(fb_kernel[4], lengths), float(fb_kernel[4].abs().max()),
        ),
    )
    return errs, scan_in, fwd_in, grad_in, pair_in


def masked_transition_pots(device):
    """The JAX package's test_grads_finite_with_masked_transitions case:
    two confident segments whose boundary wants the forbidden 0 -> 1."""
    import torch

    from action_segmentation_torch.ops.hsmm import HsmmPotentials

    b, t, c, k = 1, 20, 3, 6
    trans = np.full((b, c, c), np.log(0.5), np.float32)
    trans[:, 1, 0] = -1e9
    lens = np.zeros((b, k, c), np.float32)
    lens[:, 0] = -1e9
    emit = np.full((b, t, c), -200.0, np.float32)
    emit[:, :10, 0] = 0.0
    emit[:, 10:, 1] = 0.0
    zeros = np.zeros((b, c), np.float32)
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    pots = HsmmPotentials(dev(trans), dev(zeros), dev(lens), dev(emit), dev(zeros))
    return pots, dev(np.full(b, t, np.int32))


def marginal_gap(marg, lengths):
    """max over real frames of |sum_c marginal - 1|."""
    gaps = [(marg[b, :L].sum(dim=-1) - 1).abs().max() for b, L in
            enumerate(lengths.long().clamp(min=1).tolist())]
    return float(max(gaps))


def run_train_kernels(device):
    """Phase 3b; returns the serving case's errors and kernel inputs, and
    the marginal-sum gaps."""
    import torch

    from action_segmentation_torch.ops.hsmm import hsmm_frame_marginals
    from action_segmentation_torch.ops.hsmm_grad import (
        PLAIN,
        centre_emissions,
        hsmm_frame_marginals_fast,
    )

    rng = np.random.RandomState(10)
    pots, lengths = serving_pots(rng, B, T, C, K, device)
    serving = train_case("serving", pots, lengths)
    rl = rng.randint(1, T + 1, size=B).astype(np.int32)
    rl[[0, 5]] = 1
    rl[1] = T
    train_case("ragged", *serving_pots(rng, B, T + 32, C, K, device, lengths=rl))
    end = np.zeros((B, C), np.float32)
    end[:, rng.rand(C) < 0.5] = -1e9
    end[:, 0] = 0.0
    train_case("end_mask", *serving_pots(rng, B, T, C, K, device, end_mask=end))
    train_case("C=128", *serving_pots(rng, 4, T, 128, K, device))
    train_case("K=1", *serving_pots(rng, B, T, C, 1, device))
    # no chain folds: the pair sum's X = alphas and Z = logZ; and a table a
    # video, which the pair kernel reads through its batch stride as it
    # reads the expanded one
    train_case("T=64", *serving_pots(rng, B, 64, C, K, device, lengths=rl.clip(max=64)))
    train_case("per-video trans", *unit_pots(rng, B, T, C, K, device))
    # the template's other instances under the fold: two warps, and the
    # carry's tail past 24 rows (its durations staged in shared memory, and
    # read from global memory where they do not fit beside the ring)
    train_case("C=48", *serving_pots(rng, 8, T, 48, K, device))
    train_case("tail Km=39", *serving_pots(rng, 8, T, C, 40, device))
    train_case("C=48 tail Km=39", *serving_pots(rng, 8, T, 48, 40, device))
    log_scans_case("global tail C=9 Km=3300", *serving_pots(rng, 2, 300, 9, 3301, device))
    # the CPU tests' long videos (tests/test_torch_long_video.py): seed 0
    long_case = serving_pots(np.random.RandomState(0), 2, 12000, C, K, device,
                             lengths=np.array([12000, 7001], np.int32))
    train_case("T=12000", *long_case)
    train_case("masked transitions", *masked_transition_pots(device))
    # the model's path: the same kernels on the serving batch's centred emissions
    centred_pots = centre_emissions(pots, lengths)[0]
    train_case("serving, centred", centred_pots, lengths)

    # the Function against autograd of the plain partition: float32 where
    # float32 holds (unit-scale emissions, 256 frames), float64 at the full
    # serving shape and scale
    t_cut = 256
    rl = rng.randint(1, t_cut + 1, size=B).astype(np.int32)
    rl[[0, 5]] = 1
    rl[1] = t_cut
    end = np.zeros((B, C), np.float32)
    end[:, rng.rand(C) < 0.5] = -1e9
    end[:, 0] = 0.0
    cases = [
        ("serving width", unit_pots(rng, B, t_cut, C, K, device, lengths=rl, end_mask=end)),
        ("C=128", unit_pots(rng, 4, t_cut, 128, K, device)),
        ("K=1", unit_pots(rng, B, t_cut, C, 2, device, lengths=rl)),
        ("masked transitions", masked_transition_pots(device)),
    ]
    for name, (p, l) in cases:
        err = assert_grads_close("{} partition_fb vs autograd (float32)".format(name),
                                 partition_grads(p, l), autograd_grads(p, l))
        phase("kernels (train)", "{}: B={} T={} C={} K={} logZ and grads vs autograd of "
              "hsmm_partition, float32: max_abs_err={:g}".format(
                  name, p.emit.shape[0], p.emit.shape[1], p.emit.shape[2],
                  p.lens.shape[1], err))
    pots64 = type(pots)(*(x.double() for x in pots))
    exact = partition_grads(pots64, lengths, PLAIN)
    err = assert_grads_close("serving partition_fb vs autograd (float64)", exact,
                             autograd_grads(pots64, lengths))
    phase("kernels (train)", "serving: logZ and grads of the Function's plain path vs "
          "autograd of hsmm_partition, float64: max_abs_err={:g}".format(err))

    # float32 cancellation at the D=300 emission scale, and its repair on the
    # model's path (the DP over centred emissions, the log scans' fold, the
    # band inputs anchored per chunk)
    t0 = time.perf_counter()
    gaps = {
        "kernel_fp32": marginal_gap(hsmm_frame_marginals_fast(pots, lengths), lengths),
        "plain_fp32": marginal_gap(hsmm_frame_marginals_fast(pots, lengths, PLAIN), lengths),
        "plain_fp64": marginal_gap(exact[4], lengths),
        "autograd_fp32": marginal_gap(hsmm_frame_marginals(pots, lengths), lengths),
        "kernel_centred": marginal_gap(centred_grads(pots, lengths)[4], lengths),
    }
    phase("kernels (train)", "serving batch (B={}): max |sum_c marginal - 1| over real frames: "
          "{}".format(B, ", ".join("{} {:g}".format(k, v) for k, v in gaps.items())))
    batch_err = float64_errors("serving batch centred", centred_grads(pots, lengths), exact,
                               lengths)
    for name, bound in CENTRED_BOUNDS["serving case"].items():
        check(batch_err[name] <= bound, "the serving batch's centred {} error {:g} against "
              "float64 is above {:g}".format(name, batch_err[name], bound))
    centred = {}
    for name, (p, L) in (("serving case", d300_case(device)), ("T=12000", long_case)):
        want = partition_grads(type(p)(*(x.double() for x in p)), L, PLAIN)
        centred[name] = {
            "centred": float64_errors(name + " centred", centred_grads(p, L), want, L),
            "as is": float64_errors(name + " as is", partition_grads(p, L), want, L,
                                    finite=False)}
        phase("kernels (train)", "{} (B={} T={} C={} K={} D={}), the kernel path against the "
              "plain path in float64: centred {}; as is {}".format(
                  name, p.emit.shape[0], p.emit.shape[1], p.emit.shape[2], K, D,
                  *("{" + ", ".join("{} {:g}".format(k, v) for k, v in centred[name][w].items())
                    + "}" for w in ("centred", "as is"))))
    for case, bounds in CENTRED_BOUNDS.items():
        for name, bound in bounds.items():
            err = centred[case]["centred"][name]
            check(err <= bound, "the {}'s centred {} error {:g} is above {:g}".format(
                case, name, err, bound))
    gaps.update(serving_case=centred["serving case"]["centred"]["gap"],
                serving_case_as_is=centred["serving case"]["as is"]["gap"],
                t12000_centred=centred["T=12000"]["centred"]["gap"],
                t12000_as_is=centred["T=12000"]["as is"]["gap"])
    phase("kernels (train)", "centred against float64: the serving batch and case and T=12000 "
          "within {}; {:.1f} s".format(CENTRED_BOUNDS, time.perf_counter() - t0))
    return serving, gaps


def run_train_slice(device, num_videos, max_len, shift):
    """Phase 4b: the two fits and the no-grad partition (the training
    path), then segment_with_marginals; returns the e2e record and the
    training path's launches of (log scan, forward scan, band grad, pair
    grad on the tensor route and on the scalar route: the serving width, C
    = 19, takes the scalar kernel)."""
    import torch

    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data.batching import iter_batches
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.base import clip_grads, make_optimizer
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops.hsmm_cuda import (
        hsmm_band_grad,
        hsmm_forward_scan,
        hsmm_log_scan,
        hsmm_pair_grad,
        hsmm_pair_grad_narrow,
    )
    from action_segmentation_torch.ops.hsmm_grad import (
        PLAIN,
        hsmm_partition_centred,
        hsmm_partition_fast,
    )

    kw = dict(num_videos=num_videos, n_classes=C, max_len=max_len, span_k=K,
              feature_dim=D, shift=shift)
    train = SyntheticDatasplit(seed=0, **kw)
    test = SyntheticDatasplit(seed=1, **kw)
    n_batches = -(-num_videos // B)
    frames = sum(int(train._samples[n]["features"].shape[0]) for n in train._samples)
    kernels = (hsmm_log_scan, hsmm_forward_scan, hsmm_band_grad, hsmm_pair_grad,
               hsmm_pair_grad_narrow)
    for k in kernels:
        k.launches = 0

    def counts():
        return [k.launches for k in kernels]

    # the process's first torch.optim.Adam pays PyTorch's lazy imports;
    # timed apart from the fit
    t0 = time.perf_counter()
    torch.optim.Adam([torch.nn.Parameter(torch.zeros(1, device=device))])
    optimizer_setup_s = time.perf_counter() - t0

    # unsupervised: the marginal likelihood
    unsup = SemiMarkovModel.from_args(sm_args(epochs=3), train, device=device)
    losses, stamps = [], []

    def on_epoch(epoch, stats):
        losses.append(stats["train_loss"])  # the epoch's one fetch has synced
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unsup.fit(train, use_labels=False, callback_fn=on_epoch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steady = 2 * frames / (stamps[2] - stamps[0])  # epochs 2 and 3
    n_unsup = counts()
    phase("train slice", "unsupervised fit: 3 epochs x {} batches, epoch losses {}, "
          "launches log/forward/band grad/pair grad (tensor, scalar route) = {}, {:.3f} s = {:.0f} frames/s ({:.0f} frames/s "
          "over epochs 2-3; the first Adam of the process took {:.3f} s before)".format(
              n_batches, losses, n_unsup, fit_s, 3 * frames / fit_s, steady,
              optimizer_setup_s))
    check(n_unsup == [3 * n_batches, 0, 3 * n_batches, 0, 3 * n_batches],
          "unsupervised fit launches {} != one log scan, band grad and pair grad per "
          "batch".format(n_unsup))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "unsupervised epoch loss did not fall: {}".format(losses))
    before = counts()
    unsup_preds = unsup.predict(test)
    mof_unsup = mof(test, unsup_preds, matched=True)
    check(counts() == before, "predict launched a training kernel")
    phase("train slice", "unsupervised fit: predict MoF {:.4f} Hungarian-matched, {:.4f} "
          "unmatched (chance {:.4f})".format(mof_unsup, mof(test, unsup_preds), 1.0 / C))

    # discriminative, from the closed form
    disc = SemiMarkovModel.from_args(
        sm_args(epochs=2, sm_supervised_method="closed-then-gradient",
                sm_train_discriminatively=True), train, device=device)
    disc_losses = []
    disc.fit(train, use_labels=True,
             callback_fn=lambda e, s: e >= 0 and disc_losses.append(s["train_loss"]))
    n_disc = [a - b for a, b in zip(counts(), n_unsup)]
    mof_disc = mof(test, disc.predict(test))
    phase("train slice", "closed-then-gradient discriminative fit: 2 epochs, epoch losses {}, "
          "launches log/forward/band grad/pair grad (tensor, scalar route) = {}, predict MoF {:.4f}".format(
              disc_losses, n_disc, mof_disc))
    check(n_disc == [2 * n_batches, 0, 2 * n_batches, 0, 2 * n_batches],
          "discriminative fit launches {} != one log scan, band grad and pair grad per "
          "batch".format(n_disc))
    check(mof_disc > 10.0 / C, "discriminative MoF {:.4f} is not above 10x chance".format(mof_disc))

    # the partition without gradients: the forward-only scan over the
    # centred emissions, as the loss takes it
    names = sorted(test._samples)[:3]
    feats = [test._samples[n]["features"] for n in names]
    batch = next(iter_batches(test, batch_size=B, batch_by_task=True, shuffle=False))
    dev = disc._training_batch(batch)
    with torch.no_grad():
        pots, _, _ = disc.module.compute_potentials(dev[0], dev[1], dev[2], dev[5], dev[6])
        before = hsmm_forward_scan.launches
        logZ = hsmm_partition_centred(pots, dev[1])
        check(hsmm_forward_scan.launches == before + 1, "no-grad partition did not take K1")
        assert_close("no-grad partition", logZ, hsmm_partition_centred(
            pots, dev[1], lambda p, L: hsmm_partition_fast(p, L, PLAIN)))

    # the training path ends here: both fits and the no-grad partition
    launches = counts()
    phase("train slice", "train path launches log/forward/band grad/pair grad (tensor, scalar route) = "
          "{}".format(launches))

    # labels and marginals from one serving entry point, the labels held to
    # segment's: a video alone, as segment_with_marginals takes it (in a
    # batch of others its emissions' GEMM rounds otherwise, and the labels
    # chain may pick another float32-tied class)
    seg = Segmenter(disc)
    want = [seg.segment(f) for f in feats]
    gaps = []
    for f, w in zip(feats, want):
        labels, marg = seg.segment_with_marginals(f)
        check(np.array_equal(labels, w), "segment_with_marginals labels != segment's")
        check(marg.shape == (f.shape[0], C) and np.isfinite(marg).all(),
              "segment_with_marginals marginals: shape {} or non-finite".format(marg.shape))
        gaps.append(float(np.abs(marg.sum(axis=1) - 1).max()))
    n_seg = [a - b for a, b in zip(counts(), launches)]
    phase("train slice", "segment_with_marginals: 3 videos, labels == segment's, "
          "max |sum marginal - 1| {}, launches log/forward/band grad/pair grad (tensor, scalar route) = "
          "{}".format(gaps, n_seg))
    check(n_seg == [3, 0, 3, 0, 0], "segment_with_marginals launches {} != one log scan and "
          "band grad per video and no pair grad (d logZ / d emit alone)".format(n_seg))
    e2e = {
        "fit_frames_per_s": 3 * frames / fit_s,
        "fit_steady_frames_per_s": steady,
        "fit_s": fit_s,
        "optimizer_setup_s": optimizer_setup_s,
        "fit_frames": 3 * frames,
        "unsup_epoch_losses": losses,
        "disc_epoch_losses": disc_losses,
        "mof_disc_predict": mof_disc,
        "mof_unsup_predict": mof_unsup,
        "segment_with_marginals_sum_gap": max(gaps),
    }

    # one unsupervised training step on a serving batch already on the card
    rng = np.random.RandomState(3)
    step_batch = (
        torch.from_numpy(rng.randn(B, T, D).astype(np.float32)).to(device),
        torch.full((B,), T, dtype=torch.int32, device=device),
        torch.arange(C, device=device),
        torch.arange(C, device=device),
        torch.zeros((B, T), dtype=torch.long, device=device),
        torch.zeros((B, T, C), device=device),
        torch.zeros((B, C), device=device),
        torch.ones((B,), device=device),
    )
    params = list(unsup.module.parameters())
    optimizer, _ = make_optimizer(unsup.args, params)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss, _ = unsup._loss(*step_batch, use_labels=False)
        loss.backward()
        clip_grads(params, unsup.args.max_grad_norm)
        optimizer.step()

    torch.cuda.reset_peak_memory_stats()
    e2e["train_step_ms"] = cuda_ms(step, 10)
    e2e["train_step_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    return e2e, launches


def sm_args(**overrides):
    from action_segmentation_torch.models.base import add_training_args
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    parser = argparse.ArgumentParser()
    SemiMarkovModel.add_args(parser)
    add_training_args(parser)
    parser.add_argument("--batch_size", type=int, default=B)
    args = parser.parse_args([])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def mof(datasplit, predictions, matched=False):
    """MoF of `predictions`, with `matched` after the Hungarian matching
    of predicted to true classes (an unsupervised fit's classes are its
    own)."""
    from action_segmentation_torch.evaluation.accuracy import Accuracy

    acc = Accuracy(verbose=False, corpus=datasplit.corpus)
    for name in sorted(predictions):
        acc.add_gt_labels(datasplit[(datasplit.task, name)]["gt"])
        acc.add_predicted_labels(predictions[name])
    acc.mof(optimal_assignment=matched)
    return acc.mof_val()


def run_slice(device, num_videos, max_len, shift):
    """Closed-form fit, predict and segment_many on synthetic CrossTask-
    width data; returns the e2e record, the main path's launches and the
    band max's inputs at each of its predict and segment_many batches."""
    import torch

    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops.hsmm_cuda import hsmm_band_max, hsmm_gamma_scan

    kw = dict(num_videos=num_videos, n_classes=C, max_len=max_len, span_k=K,
              feature_dim=D, shift=shift)
    train = SyntheticDatasplit(seed=0, **kw)
    test = SyntheticDatasplit(seed=1, **kw)
    model = SemiMarkovModel.from_args(sm_args(), train, device=device)
    model.fit(train, use_labels=True)
    n_batches = -(-num_videos // B)
    kernels = (hsmm_gamma_scan, hsmm_band_max)

    def counted(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        return out, [k.launches for k in kernels]

    preds, n_predict = counted(lambda: model.predict(test))
    mof_predict = mof(test, preds)
    names = sorted(test._samples)
    feats = [test._samples[n]["features"] for n in names]
    seg = Segmenter(model)
    seg.segment_many(feats, batch_size=B)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, n_segment = counted(lambda: seg.segment_many(feats, batch_size=B))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mof_segment = mof(test, dict(zip(names, labels)))
    frames = sum(f.shape[0] for f in feats)
    # the band max's inputs at each decode batch, timed in phase 5
    bm_batches = {path: capture_launch_inputs("_launch_band_max", fn)[0] for path, fn in (
        ("predict", lambda: model.predict(test)),
        ("segment_many", lambda: seg.segment_many(feats, batch_size=B)))}
    phase("slice", "predict: {} videos, launches gamma/band = {}, MoF {:.4f}".format(
        len(preds), n_predict, mof_predict))
    phase("slice", "segment_many: launches gamma/band = {}, MoF {:.4f}, {} frames "
          "in {:.4f} s = {:.0f} frames/s".format(
              n_segment, mof_segment, frames, seconds, frames / seconds))
    if device.type == "cuda":
        for path, counts in (("predict", n_predict), ("segment_many", n_segment)):
            check(counts == [n_batches, n_batches],
                  "{}: kernel launches {} != {} batches".format(path, counts, n_batches))
    chance = 1.0 / C
    for path, m in (("predict", mof_predict), ("segment_many", mof_segment)):
        check(m > 10 * chance, "{} MoF {:.4f} is not far above chance {:.4f}".format(
            path, m, chance))
    e2e = {
        "segment_many_frames_per_s": frames / seconds,
        "segment_many_s": seconds,
        "frames": frames,
        "videos": len(feats),
        "batch_size": B,
        "mof_predict": mof_predict,
        "mof_segment_many": mof_segment,
    }
    if device.type == "cuda":
        # device time of one whole decode (potentials, both kernels, the
        # glue between them) on a serving batch already on the card
        rng = np.random.RandomState(2)
        batch = (
            torch.from_numpy(rng.randn(B, T, D).astype(np.float32)).to(device),
            torch.full((B,), T, dtype=torch.int32, device=device),
            torch.arange(C, device=device),
            torch.zeros((B, T, C), device=device),
            torch.zeros((B, C), device=device),
        )
        e2e["decode_batch_ms"] = cuda_ms(lambda: model._decode(*batch), 20)
    launches = [a + b for a, b in zip(n_predict, n_segment)]
    return e2e, launches, bm_batches


def viterbi_case(name, pots, lengths):
    """K6's scan and the traceback against their plain versions on the
    same inputs, the spans chain against its plain version, and the spans'
    labels against the labels chain's; returns the max abs errors and the
    two kernels' inputs."""
    import torch

    from action_segmentation_torch.ops.hsmm import _durations, _finals, hsmm_gold_score
    from action_segmentation_torch.ops.hsmm_cuda import (
        _traceback_plain,
        _viterbi_scan_plain,
        hsmm_viterbi_labels,
        hsmm_viterbi_scan,
        hsmm_viterbi_spans,
        hsmm_viterbi_spans_plain,
        hsmm_viterbi_traceback,
    )
    from action_segmentation_torch.ops.span_codec import spans_to_labels

    L = lengths.long().clamp(min=1)
    scan_in = (pots.trans.contiguous(), pots.init.contiguous(),
               _durations(pots.lens).contiguous(), pots.emit.contiguous())
    alphas_k, bp_k = hsmm_viterbi_scan(*scan_in)
    alphas_p, bp_p = _viterbi_scan_plain(*scan_in)
    torch.cuda.synchronize()
    assert_close(name + " viterbi scan alphas", alphas_k, alphas_p)
    check(torch.equal(bp_k, bp_p), "{}: {} of {} backpointer codes differ from the plain "
          "version's".format(name, int((bp_k != bp_p).sum()), bp_k.numel()))
    c_last = _finals(alphas_k, L, pots.end_mask).argmax(dim=-1)
    tb_in = (bp_k, L, c_last)
    spans_k = hsmm_viterbi_traceback(*tb_in)
    spans_p = _traceback_plain(*tb_in)
    torch.cuda.synchronize()
    check(torch.equal(spans_k, spans_p), "{}: traceback spans differ from the plain "
          "version's at {} frames".format(name, int((spans_k != spans_p).sum())))

    spans, scores = hsmm_viterbi_spans(pots, lengths)
    want_spans, want_scores = hsmm_viterbi_spans_plain(pots, lengths)
    assert_close(name + " spans chain scores", scores, want_scores)
    check(torch.equal(spans, want_spans), name + ": spans chain differs from its plain version")
    # the two decode chains on the same potentials: each one's label must
    # be a float64 best wherever they differ. Where float32 cannot part two
    # paths (an ulp of |alpha| ~ 1e6 is 0.125 nats) the chains may pick
    # different ones, which differ over a stretch of frames, so the count
    # of tie frames is not bounded here; instead the spans' whole path must
    # score, in float64, within the score tolerance of the float64 best
    t = torch.arange(spans.shape[1], device=spans.device)[None, :]
    span_labels = torch.where(t < L[:, None], spans_to_labels(spans), -1)
    labels, label_scores = hsmm_viterbi_labels(pots, lengths)
    ties = check_labels(name + " labels chain vs spans", pots, lengths, labels, span_labels,
                        label_scores, scores, few_ties=False)
    check_labels(name + " spans vs labels chain", pots, lengths, span_labels, labels,
                 scores, label_scores, few_ties=False)
    pots64 = type(pots)(*(x.double() for x in pots))
    path64 = hsmm_gold_score(pots64, lengths, spans)
    best64 = hsmm_viterbi_spans_plain(pots64, lengths)[1]
    path_gap = float((best64 - path64).max())
    check(bool((best64 - path64 <= RTOL * best64.abs() + ATOL).all()),
          "{}: the spans' path is {:g} nats below the float64 best".format(name, path_gap))
    errs = {"scan": max_err(alphas_k, alphas_p), "traceback": 0.0,
            "bit_exact": bool(torch.equal(alphas_k, alphas_p))}
    phase("kernels (viterbi)", "{}: B={} T={} C={} K={} scan alphas max_abs_err={:g} "
          "(bit-exact {}), codes equal, traceback spans equal, {} segments; labels chain "
          "vs spans: {} tie frames, the spans' path {:g} nats below the float64 best".format(
              name, pots.emit.shape[0], pots.emit.shape[1], pots.emit.shape[2],
              pots.lens.shape[1], errs["scan"], errs["bit_exact"],
              int((spans >= 0).sum()), ties, path_gap))
    return errs, scan_in, tb_in


def run_viterbi_kernels(device):
    """Phase 3c; returns the D=300-scale serving case's errors and the
    kernels' inputs there."""
    rng = np.random.RandomState(20)
    viterbi_case("serving, unit scale", *unit_pots(rng, B, T, C, K, device))
    serving = viterbi_case("serving, D=300 scale", *serving_pots(rng, B, T, C, K, device))
    viterbi_case("C=128", *serving_pots(rng, 4, T, 128, K, device))
    viterbi_case("K=1", *serving_pots(rng, B, T, C, 1, device))
    end = np.full((B, C), -1e9, np.float32)
    end[np.arange(B), rng.randint(C, size=B)] = 0.0
    viterbi_case("end_mask", *serving_pots(rng, B, T, C, K, device, end_mask=end))
    rl = rng.randint(1, T + 1, size=B).astype(np.int32)
    rl[[0, 5]] = 1
    rl[1] = T
    viterbi_case("ragged", *serving_pots(rng, B, T + 32, C, K, device, lengths=rl))
    viterbi_case("T=12000", *serving_pots(
        rng, 2, 12000, C, K, device, lengths=np.array([12000, 7001], np.int32)))
    return serving


def capture_launch_inputs(launch_name, fn):
    """Runs fn() with hsmm_cuda.<launch_name> (the traceback's, a band
    kernel's or the pair sum's launch, which the wrapper looks up at each
    call) keeping a
    copy of the tensor inputs of each launch (all but the tile); returns
    them and fn's result."""
    from action_segmentation_torch.ops import hsmm_cuda

    kept, launch = [], getattr(hsmm_cuda, launch_name)

    def keep(*args):
        kept.append(tuple(a.clone() for a in args[:-1]))
        return launch(*args)

    setattr(hsmm_cuda, launch_name, keep)
    try:
        out = fn()
    finally:
        setattr(hsmm_cuda, launch_name, launch)
    return kept, out


def crosstask_args(root, *extra):
    """The S6 flags on the release under `root`, the model's and the
    training flags' defaults, and `extra`."""
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.base import add_training_args
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    parser = argparse.ArgumentParser()
    port_main.add_data_args(parser)
    SemiMarkovModel.add_args(parser)
    add_training_args(parser)
    return parser.parse_args([*S6_FLAGS, "--data_root", root, "--pca_components_per_group",
                              str(CT_DIM_PER_GROUP), *extra])


def run_crosstask_slice(device, root):
    """Phase 4c: on-disk corpus (written under `root`) -> loader ->
    closed-form fit -> decode through the exact-spans kernels -> MoF/F1,
    Segmenter(task=), then the constrained unsupervised fit of
    CT_FIT_TASKS tasks and a decode with narration at test. Returns the
    e2e record, the decode path's launches of (viterbi scan, traceback),
    the traceback's inputs at each predict batch, the band gradient's and
    the pair sum's at each batch of the fit, and the closed-form models'
    per-split stats ({split: {task: stats}}, F1 sampled from numpy's seed
    0)."""
    import torch

    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops.hsmm_cuda import (
        hsmm_band_grad,
        hsmm_band_max,
        hsmm_forward_scan,
        hsmm_gamma_scan,
        hsmm_log_scan,
        hsmm_pair_grad_narrow,
        hsmm_viterbi_scan,
        hsmm_viterbi_traceback,
    )

    decode_kernels = (hsmm_viterbi_scan, hsmm_viterbi_traceback, hsmm_gamma_scan,
                      hsmm_band_max)
    # a task's classes (19 or 20): the pair sum's scalar route
    train_kernels = (hsmm_log_scan, hsmm_forward_scan, hsmm_band_grad, hsmm_pair_grad_narrow)

    def reset(kernels):
        for k in kernels:
            k.launches = 0

    def counts(kernels):
        return [k.launches for k in kernels]

    t0 = time.perf_counter()
    tasks = write_ct_release(root)
    n_classes = len(tasks) * (2 * CT_STEPS + 1)
    write_s = time.perf_counter() - t0

    # 1-2. the S6 flags' splits (one per task), a closed-form model each
    args = crosstask_args(root)
    t0 = time.perf_counter()
    splits = port_main.make_data_splits(args)
    load_s = time.perf_counter() - t0
    check(len(splits) == len(tasks), "{} splits for {} tasks".format(len(splits), len(tasks)))
    models = []
    t0 = time.perf_counter()
    for train, _, val in splits.values():
        model = SemiMarkovModel.from_args(args, train, device=device)
        check(model.n_classes == n_classes, "{} classes, not {}".format(
            model.n_classes, n_classes))
        model.fit(train, use_labels=True)
        models.append((val._tasks_and_video_names[0][0], model, train, val))
    fit_s = time.perf_counter() - t0
    lengths = [len(val[key]["gt_single"]) for *_, val in models
               for key in val._tasks_and_video_names]
    widths = {len(val[val._tasks_and_video_names[0]]["task_indices"]) for *_, val in models}
    phase("crosstask slice", "{} tasks x {} steps, {} classes, task widths {}; {} train + "
          "{} val videos a task, val frames {}-{}, D={}; written in {:.2f} s, loaded in "
          "{:.2f} s; 18 closed-form fits in {:.2f} s".format(
              len(tasks), CT_STEPS, n_classes, sorted(widths), CT_TRAIN, CT_VAL,
              min(lengths), max(lengths), 3 * CT_DIM_PER_GROUP, write_s, load_s, fit_s))
    check(widths == {2 * CT_STEPS + 1}, "task widths {}".format(widths))

    # 3. predict on val: the exact-spans kernels only
    n_batches = sum(-(-len(val._tasks_and_video_names) // args.batch_size)
                    for *_, val in models)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset(decode_kernels)
    t0 = time.perf_counter()
    preds = [model.predict(val) for _, model, _, val in models]
    predict_s = time.perf_counter() - t0  # predict's drain ends in a sync
    launches = counts(decode_kernels)
    frames = sum(lengths)
    # the traceback's inputs at each predict batch, timed in phase 5
    tb_batches, _ = capture_launch_inputs(
        "_launch_traceback", lambda: [model.predict(val) for _, model, _, val in models])

    # 4. MoF and F1 per task by the datasplit's accuracy_corpus
    correct = total = 0
    f1s = []
    stats_by_split = {}
    for split, (task, _, _, val), pred in zip(splits, models, preds):
        np.random.seed(0)  # F1 samples frames from numpy's global stream
        stats = val.accuracy_corpus(False, lambda v: pred[v.name], verbose=False)[task]
        stats_by_split[split] = {task: stats}
        correct += float(stats["mof"][0])
        total += float(stats["mof"][1])
        f1s.append(float(stats["f1"][0]) / max(float(stats["f1"][1]), 1e-12))
    mof_val = correct / total
    phase("crosstask slice", "predict: {} batches, {} frames in {:.4f} s = {:.0f} frames/s, "
          "launches viterbi scan/traceback/gamma scan/band max = {}; MoF {:.4f} (chance "
          "{:.4f}), mean F1 {:.4f}".format(
              n_batches, frames, predict_s, frames / predict_s, launches, mof_val,
              1.0 / (2 * CT_STEPS + 1), float(np.mean(f1s))))
    if device.type == "cuda":
        check(launches == [n_batches, n_batches, 0, 0],
              "crosstask predict launches {} != one viterbi scan and traceback per batch "
              "and no labels chain".format(launches))
    check(mof_val > 10.0 / (2 * CT_STEPS + 1),
          "crosstask MoF {:.4f} is not above 10x chance".format(mof_val))

    # 5. the serving entry point on one task's videos
    task, model, _, val = models[0]
    names = [name for _, name in val._tasks_and_video_names]
    vc = val[(task, names[0])]["task_indices"]
    seg = Segmenter(model, valid_classes=vc, task=task)
    got = seg.segment_many([val[(task, n)]["features"] for n in names],
                           batch_size=args.batch_size)
    for name, labels in zip(names, got):
        check(np.array_equal(labels, preds[0][name]),
              "Segmenter(task=).segment_many labels != predict's for " + name)
    phase("crosstask slice", "Segmenter(model, valid_classes, task={}).segment_many: {} "
          "videos, labels == predict's".format(task, len(names)))

    # 6. the constrained unsupervised fit, through the training kernels
    uargs = crosstask_args(root, "--sm_constrain_transitions",
                           "--sm_constrain_with_narration", "train", "--epochs", "2")
    reset(train_kernels)
    fit_batches = 0
    unsup = []

    def fit_tasks():
        for _, _, train, val in models[:CT_FIT_TASKS]:
            model = SemiMarkovModel.from_args(uargs, train, device=device)
            losses = []
            model.fit(train, use_labels=False,
                      callback_fn=lambda e, s, losses=losses: losses.append(s["train_loss"]))
            check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                  "constrained unsupervised epoch loss did not fall: {}".format(losses))
            unsup.append((model, val, losses))

    # the band gradient's and the pair sum's inputs at each batch of the
    # fit, timed in phase 5
    t0 = time.perf_counter()
    pair_batches, (bg_batches, _) = capture_launch_inputs(
        "_launch_pair_grad", lambda: capture_launch_inputs("_launch_band_grad", fit_tasks))
    unsup_s = time.perf_counter() - t0
    for _, _, train, _ in models[:CT_FIT_TASKS]:
        fit_batches += 2 * -(-len(train._tasks_and_video_names) // uargs.batch_size)
    n_train = counts(train_kernels)
    phase("crosstask slice", "constrained unsupervised fit (ordering, narration at train): "
          "{} tasks x 2 epochs, {} batches in {:.3f} s, epoch losses {}, launches log/"
          "forward/band grad/pair grad = {}".format(CT_FIT_TASKS, fit_batches, unsup_s,
                                          [u[2] for u in unsup], n_train))
    if device.type == "cuda":
        check(n_train == [fit_batches, 0, fit_batches, fit_batches],
              "constrained fit launches {} != one log scan, band grad and pair grad per "
              "batch".format(n_train))

    # 7. narration at test
    model, val, _ = unsup[0]
    model.args.sm_constrain_with_narration = ["test"]
    reset(decode_kernels)
    pred = model.predict(val)
    n_test = counts(decode_kernels)
    n_val_batches = -(-len(val._tasks_and_video_names) // uargs.batch_size)
    allowed = set(val[val._tasks_and_video_names[0]]["task_indices"].tolist())
    check(all(set(p.tolist()) <= allowed for p in pred.values()),
          "narration-at-test labels outside the task's classes")
    phase("crosstask slice", "decode with narration at test: {} videos, launches viterbi "
          "scan/traceback/gamma scan/band max = {}".format(len(pred), n_test))
    if device.type == "cuda":
        check(n_test == [n_val_batches, n_val_batches, 0, 0],
              "narration-at-test decode launches {}".format(n_test))
    e2e = {
        "crosstask_predict_frames_per_s": frames / predict_s,
        "crosstask_predict_s": predict_s,
        "crosstask_frames": frames,
        "crosstask_batches": n_batches,
        "crosstask_mof": mof_val,
        "crosstask_mean_f1": float(np.mean(f1s)),
        "crosstask_unsup_epoch_losses": [u[2] for u in unsup],
    }
    return e2e, launches[:2], tb_batches, bg_batches, pair_batches, stats_by_split, models


def assert_stats_equal(name, got, want):
    """{split: {task: stats}} equal, numerators and denominators."""
    check(list(got) == list(want), "{}: splits {} != {}".format(name, list(got), list(want)))
    for split in want:
        for task, w in want[split].items():
            g = got[split].get(task)
            check(g is not None and g.keys() == w.keys(), "{}: {} {} stat keys".format(
                name, split, task))
            for key in w:
                check(np.array_equal(np.asarray(g[key]), np.asarray(w[key])),
                      "{}: {} {} {}: {} != {}".format(name, split, task, key, g[key], w[key]))


@contextlib.contextmanager
def cli_recorder(port_main, model_cls):
    """Run the command line with two pass-through shims: every test() call
    starts numpy's global stream at seed 0 (F1 samples frames from it, so
    two runs that consumed it differently draw the same samples), and
    every fit's epoch callback is recorded as (epoch, train_loss). The
    port's debug log (per-task accuracy tables, epoch lines) is held
    back meanwhile."""
    from action_segmentation_torch.utils import logger

    test, fit, level = port_main.test, model_cls.fit, logger.level
    epochs = []

    def seeded_test(*args, **kwargs):
        np.random.seed(0)
        return test(*args, **kwargs)

    def recorded_fit(self, train_data, use_labels, callback_fn=None):
        def callback(epoch, stats):
            epochs.append((epoch, stats.get("train_loss")))
            if callback_fn:
                callback_fn(epoch, stats)
        return fit(self, train_data, use_labels, callback_fn=callback)

    port_main.test, model_cls.fit = seeded_test, recorded_fit
    logger.setLevel(logging.INFO)
    try:
        yield epochs
    finally:
        port_main.test, model_cls.fit = test, fit
        logger.setLevel(level)


# the kernels' wrappers as the command-line phases name them
CLI_KERNELS = ("viterbi scan", "traceback", "gamma scan", "band max", "log scan", "band grad",
               "forward scan", "pair grad", "pair grad narrow")


def pair_sum(n):
    """`n` (launches by CLI_KERNELS name) with "pair sum": the pair sum's
    launches on either route."""
    return dict(n, **{"pair sum": n["pair grad"] + n["pair grad narrow"]})


def cli_kernel_wrappers():
    """The kernels' wrappers in CLI_KERNELS's order."""
    from action_segmentation_torch.ops import hsmm_cuda as hc

    return (hc.hsmm_viterbi_scan, hc.hsmm_viterbi_traceback, hc.hsmm_gamma_scan,
            hc.hsmm_band_max, hc.hsmm_log_scan, hc.hsmm_band_grad, hc.hsmm_forward_scan,
            hc.hsmm_pair_grad, hc.hsmm_pair_grad_narrow)


def cli_runner(legs, totals):
    """run(leg, argv): the port's command line, main.main(argv) in process
    with no device (so on the card), with every kernel's launch counter
    reset before it and read after. Adds the run's wall time to
    legs[leg] and its launches to totals (by wrapper name); returns
    (stats, launches by CLI_KERNELS name, the recorded (epoch,
    train_loss) pairs, stdout)."""
    import torch

    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops import hsmm_cuda as hc

    kernels = cli_kernel_wrappers()
    for k in kernels:
        totals.setdefault(k.__name__, 0)

    def run(leg, argv):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cli_recorder(port_main, SemiMarkovModel) as epochs, \
                contextlib.redirect_stdout(io.StringIO()) as out:
            stats = port_main.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(zip(CLI_KERNELS, (k.launches for k in kernels)))
        for k in kernels:
            totals[k.__name__] += k.launches
        legs.setdefault(leg, {"s": 0.0, "runs": 0})
        legs[leg]["s"] += seconds
        legs[leg]["runs"] += 1
        return stats, launches, epochs, out.getvalue()

    return run


def trace_kernels(trace_dir, first):
    """The kernels of the Chrome trace `first` in `trace_dir`: (events
    naming scan_kernel and band_grad_kernel, kernel us, span us)."""
    with open(os.path.join(trace_dir, first)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    named = {k: sum(k in str(e.get("name", "")) for e in events)
             for k in ("scan_kernel", "band_grad_kernel")}
    check(all(named.values()), "the trace names no scan or band-gradient kernel: "
          "{}".format(named))
    # the card's busy share of the traced epoch: its kernels' time over
    # the trace's span (the epoch's host and device events)
    kernel_us = sum(float(e.get("dur", 0)) for e in events if e.get("cat") == "kernel")
    span_us = (max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
               - min(float(e["ts"]) for e in events))
    return named, kernel_us, span_us


def run_cli_slice(root, ct_stats, smi):
    """Phase 4d: the port's command line, action_segmentation_torch.main.main
    in process with no device (so on the card), on phase 4c's CrossTask
    release under `root`: (1) the S6 closed-form command with model and
    prediction output, (2) decoding from the saved models, (3) an
    unsupervised --mix_tasks run checkpointed, resumed and profiled
    against an uninterrupted one, (4) a Breakfast release at the fisher
    vectors' width. Each leg resets the kernels' launch counters before
    it and reads them after. Returns the e2e record."""
    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.data import minigen

    names = CLI_KERNELS
    legs, cli_launches = {}, {}
    run = cli_runner(legs, cli_launches)

    def leg_line(leg, frames, what):
        s = legs[leg]["s"]
        legs[leg].update(frames=frames, frames_per_s=frames / s)
        phase("cli", "{}: {} main.main run(s) in {:.3f} s, {} {} = {:.0f} frames/s; {}".format(
            leg, legs[leg]["runs"], s, frames, what, frames / s, smi))

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        s6 = ["--classifier", "semimarkov", "--training", "supervised", *S6_FLAGS,
              "--data_root", root, "--pca_components_per_group", str(CT_DIM_PER_GROUP)]
        with contextlib.redirect_stdout(io.StringIO()):
            splits = port_main.make_data_splits(port_main.build_parser().parse_args(s6))
        val_names = sorted(n for *_, val in splits.values()
                           for _, n in val._tasks_and_video_names)
        val_frames = sum(len(val[key]["gt_single"]) for *_, val in splits.values()
                         for key in val._tasks_and_video_names)
        batch = port_main.build_parser().parse_args(s6).batch_size
        val_batches = sum(-(-len(val._tasks_and_video_names) // batch)
                          for *_, val in splits.values())

        # 1. the stage-3 S6 command: closed form, pickles and predictions
        models, preds = os.path.join(out_dir, "s6"), os.path.join(out_dir, "pred")
        stats, n, _, _ = run("s6 closed form", s6 + ["--model_output_path", models,
                                                     "--prediction_output_path", preds])
        assert_stats_equal("s6 closed form vs phase 4c", stats, ct_stats)
        check(sorted(os.listdir(models)) == sorted("{}.pkl".format(k) for k in splits),
              "one pickle a task: {}".format(sorted(os.listdir(models))))
        check(sorted(os.listdir(preds)) == val_names, "one prediction file a val video")
        check([n[k] for k in names[:4]] == [val_batches, val_batches, 0, 0],
              "s6 launches {}: one viterbi scan and traceback a val batch ({}), no labels "
              "chain".format(n, val_batches))
        leg_line("s6 closed form", val_frames, "val frames decoded")
        phase("cli", "s6 closed form: {} splits, stats == phase 4c's, {} pickles, {} "
              "prediction files, launches {}".format(len(stats), len(splits), len(val_names), n))

        # 2. decode from the saved models, on the card
        decoded, n, _, printed = run("s6 from saved models", s6 + ["--model_input_path", models])
        assert_stats_equal("decode from saved models", decoded, stats)
        check("serialized model args differ" in printed, "no args-differ warning")
        check([n[k] for k in names[:4]] == [val_batches, val_batches, 0, 0],
              "decode from saved models launches {}".format(n))
        one = os.path.join(models, sorted(os.listdir(models))[0])
        on_card = checkpoint.load_pickle(one)
        on_cpu = checkpoint.load_pickle(one, device="cpu")
        check(on_card.device.type == "cuda" and all(
            t.is_cuda for t in on_card.module.state_dict().values()), "a pickle not on the card")
        check(on_cpu.device.type == "cpu" and all(
            torch.equal(t, on_card.module.state_dict()[k].cpu())
            for k, t in on_cpu.module.state_dict().items()), "the pickle on the CPU differs")
        leg_line("s6 from saved models", val_frames, "val frames decoded")
        phase("cli", "s6 from saved models: stats == leg 1's, launches {}; a pickle written on "
              "the card loads onto it by default and with device='cpu' onto the CPU".format(n))

        # 3. unsupervised, checkpointed every epoch, resumed, profiled
        unsup = [a if a != "supervised" else "unsupervised" for a in s6] + [
            "--mix_tasks", "--sm_constrain_transitions", "--sm_constrain_with_narration",
            "train", "--checkpoint_every", "1"]
        ck, whole, trace = (os.path.join(out_dir, d) for d in ("ck", "ck_whole", "trace"))
        leg = "unsupervised, resumed"
        _, n_first, first, _ = run(leg, unsup + ["--epochs", "2", "--checkpoint_dir", ck,
                                                 "--profile_dir", trace])
        _, n_resumed, resumed, _ = run(leg, unsup + ["--epochs", "3", "--resume",
                                                     "--checkpoint_dir", ck,
                                                     "--profile_dir", trace])
        _, n_whole, uninterrupted, _ = run(leg, unsup + ["--epochs", "3",
                                                         "--checkpoint_dir", whole])
        check([e for e, _ in first] == [0, 1] and [e for e, _ in resumed] == [2]
              and [e for e, _ in uninterrupted] == [0, 1, 2],
              "epochs run: {}, resumed {}, uninterrupted {}".format(first, resumed, uninterrupted))
        loss_diff = abs(resumed[0][1] - uninterrupted[2][1])
        check(loss_diff <= 1e-5 * abs(uninterrupted[2][1]),
              "resumed epoch-2 loss {} != uninterrupted {}".format(resumed[0][1],
                                                                  uninterrupted[2][1]))
        got, _, _ = checkpoint.load_checkpoint(ck, 2)
        want, _, _ = checkpoint.load_checkpoint(whole, 2)
        param_diff = 0.0
        for k, w in want["params"].items():
            g = got["params"][k]
            check(torch.allclose(g, w, rtol=1e-5, atol=0), "resumed param {} differs".format(k))
            param_diff = max(param_diff, float((g - w).abs().max()))
        for k in ("log scan", "band grad", "pair sum"):
            check(min(pair_sum(n)[k] for n in (n_first, n_resumed, n_whole)) > 0,
                  "{} not launched: {} {} {}".format(k, n_first, n_resumed, n_whole))
        traces = sorted(os.listdir(trace))
        check(traces == ["epoch_0.pt.trace.json", "epoch_2.pt.trace.json"],
              "traces {}".format(traces))
        named, kernel_us, span_us = trace_kernels(trace, traces[0])
        train_frames = sum(len(train[key]["gt_single"]) for train, *_ in splits.values()
                           for key in train._tasks_and_video_names)
        leg_line(leg, 6 * train_frames, "train frames over 6 epochs, with the per-epoch "
                 "train and dev decodes")
        phase("cli", "unsupervised --mix_tasks: epochs {} then --resume {} against {}; epoch-2 "
              "loss {:.6f} vs {:.6f} (|diff| {:.3g}), params' largest |diff| {:.3g}, both at "
              "rtol 1e-5; launches log scan/band grad {}/{}, {}/{}, {}/{}; trace events naming "
              "{}; the traced epoch 0: kernels {:.3f} ms of a {:.3f} ms span, the card busy "
              "{:.4f} of it".format(
                  [e for e, _ in first], [e for e, _ in resumed], [e for e, _ in uninterrupted],
                  resumed[0][1], uninterrupted[2][1], loss_diff, param_diff, n_first["log scan"],
                  n_first["band grad"], n_resumed["log scan"], n_resumed["band grad"],
                  n_whole["log scan"], n_whole["band grad"], named, kernel_us / 1e3,
                  span_us / 1e3, kernel_us / span_us))

        # 4. Breakfast at the fisher vectors' published width
        bf_root = os.path.join(out_dir, "bf")
        minigen.write_mini_breakfast(bf_root, np.random.RandomState(0), dim=64)
        bf = ["--classifier", "semimarkov", "--training", "supervised", "--dataset",
              "breakfast", "--features", "raw", "--data_root", bf_root]
        bf_stats, n, _, _ = run("breakfast", bf)
        correct = sum(float(s["mof"][0]) for by in bf_stats.values() for s in by.values())
        total = sum(float(s["mof"][1]) for by in bf_stats.values() for s in by.values())
        check(correct / total >= 0.9, "breakfast MoF {:.4f}".format(correct / total))
        check(n["gamma scan"] > 0 and n["band max"] > 0 and n["viterbi scan"] == 0,
              "breakfast launches {}: not the labels chain".format(n))
        leg_line("breakfast", int(total), "test frames decoded")
        phase("cli", "breakfast (D=64, {} held-out splits): MoF {:.4f} (chance 1/3 a task: "
              "10x chance is above 1, so the leg asks for 0.9), launches {}".format(
                  len(bf_stats), correct / total, n))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"cli_legs": legs, "cli_launches": cli_launches,
            "cli_resume_loss_abs_diff": loss_diff, "cli_resume_param_max_abs_diff": param_diff,
            "cli_traced_epoch_kernel_ms": kernel_us / 1e3, "cli_traced_epoch_span_ms":
            span_us / 1e3, "cli_traced_epoch_busy_share": kernel_us / span_us,
            "cli_breakfast_mof": correct / total}


def run_u7_slice(device, root, smi):
    """Phase 4e: the compound model. (1) The paper's U7 command (the
    compound HSMM, unsupervised, canonical ordering and narration at
    train) through main.main on the card on phase 4c's CrossTask release,
    at D=300 and 342 classes, --epochs 2, with model output; (2) decoding
    from its compound pickles; (3) the U7 flags --mix_tasks, --epochs 1
    then --epochs 2 --resume against an uninterrupted --epochs 2 (the
    resumed epoch's loss and parameters bit for bit, a --profile_dir
    trace naming both training kernels); (4) on the synthetic corpus
    (19 classes, D=300), the compound model with a 16-wide latent and
    the scaled flow, 2 unsupervised epochs through K2-log and K4, then a
    decode through K2-max and K3, and --epochs 1 then 2 --resume of it
    against the uninterrupted fit (bit for bit: the latent's noise and
    the cuDNN LSTM's gradients). Each leg resets the launch counters
    before it and reads them after. Returns the e2e record."""
    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.compound import ComponentHsmm
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.ops import hsmm_cuda as hc

    legs, totals = {}, {}
    run = cli_runner(legs, totals)
    t_phase = time.perf_counter()

    def leg_line(leg, what):
        phase("u7", "{}: {} run(s) in {:.3f} s; {}; {}".format(
            leg, legs[leg]["runs"], legs[leg]["s"], what, smi))

    def fell(epochs):
        """Per model (epoch 0, then 1, ...): the epoch losses, finite."""
        runs = []
        for epoch, loss in epochs:
            check(loss is not None and math.isfinite(loss), "epoch loss {}".format(loss))
            if epoch == 0:
                runs.append([])
            runs[-1].append(loss)
        return runs

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_u7_")
    try:
        u7 = ["--classifier", "semimarkov", "--training", "unsupervised", *S6_FLAGS,
              "--data_root", root, "--pca_components_per_group", str(CT_DIM_PER_GROUP),
              "--sm_constrain_transitions", "--sm_component_model",
              "--sm_constrain_with_narration", "train"]
        args = port_main.build_parser().parse_args(u7)
        with contextlib.redirect_stdout(io.StringIO()):
            splits = port_main.make_data_splits(args)
        train_batches = sum(-(-len(train._tasks_and_video_names) // args.batch_size)
                            for train, *_ in splits.values())

        # 1. the U7 command: 18 per-task compound models, 2 epochs each
        models = os.path.join(out_dir, "u7")
        stats, n, epochs, _ = run("u7", u7 + ["--epochs", "2", "--model_output_path", models])
        losses = fell(epochs)
        check(len(losses) == len(splits) and all(len(x) == 2 for x in losses),
              "u7 epochs {}".format(epochs))
        falls = sum(x[1] < x[0] for x in losses)
        mean0, mean1 = (float(np.mean([x[i] for x in losses])) for i in (0, 1))
        check(mean1 < mean0, "u7 mean epoch loss {} -> {}: did not fall".format(mean0, mean1))
        check(min(n["log scan"], n["band grad"], pair_sum(n)["pair sum"]) >= 2 * train_batches,
              "u7 launches {}: below one log scan, band grad and pair grad a batch ({} "
              "batches)".format(
                  n, 2 * train_batches))
        check(n["viterbi scan"] > 0 and n["viterbi scan"] == n["traceback"]
              and n["gamma scan"] == n["band max"] == 0,
              "u7 launches {}: not the exact-spans decode".format(n))
        mofs = {(split, task): float(s["mof"][0]) / float(s["mof"][1])
                for split, by in stats.items() for task, s in by.items()}
        check(all(math.isfinite(v) for v in mofs.values()), "u7 MoF {}".format(mofs))
        pickles = sorted(f for f in os.listdir(models) if "_epoch-" not in f)
        check(pickles == sorted("{}.pkl".format(k) for k in splits),
              "one pickle a task: {}".format(pickles))
        leg_line("u7", "{} models, mean epoch loss {:.4f} -> {:.4f} ({} of {} fell), "
                 "launches {}, {} train batches an epoch, MoF {:.4f}-{:.4f} over {} "
                 "split-tasks".format(len(losses), mean0, mean1, falls, len(losses), n,
                                      train_batches, min(mofs.values()), max(mofs.values()),
                                      len(mofs)))

        # 2. decode from the compound pickles, written and read on the card
        decoded, n, _, _ = run("u7 from saved models", u7 + ["--model_input_path", models])
        assert_stats_equal("u7 decode from saved models", decoded, stats)
        check(n["viterbi scan"] > 0 and n["gamma scan"] == 0 and n["log scan"] == 0,
              "u7 decode launches {}".format(n))
        one = checkpoint.load_pickle(os.path.join(models, pickles[0]))
        check(isinstance(one.module, ComponentHsmm) and all(
            t.is_cuda for t in one.module.state_dict().values()),
              "the pickle is not a compound model on the card")
        leg_line("u7 from saved models", "stats equal to leg u7's, launches {}".format(n))

        # 3. resume, one model over every task
        mixed = u7 + ["--mix_tasks", "--checkpoint_every", "1"]
        ck, whole, trace = (os.path.join(out_dir, d) for d in ("ck", "whole", "trace"))
        leg = "u7 resumed"
        _, n_first, first, _ = run(leg, mixed + ["--epochs", "1", "--checkpoint_dir", ck,
                                                 "--profile_dir", trace])
        _, n_resumed, resumed, _ = run(leg, mixed + ["--epochs", "2", "--resume",
                                                     "--checkpoint_dir", ck])
        _, n_whole, uninterrupted, _ = run(leg, mixed + ["--epochs", "2",
                                                         "--checkpoint_dir", whole])
        check([e for e, _ in first] == [0] and [e for e, _ in resumed] == [1]
              and [e for e, _ in uninterrupted] == [0, 1],
              "epochs run: {}, resumed {}, uninterrupted {}".format(first, resumed,
                                                                    uninterrupted))
        check(resumed[0][1] == uninterrupted[1][1], "resumed epoch-1 loss {} != "
              "uninterrupted {}".format(resumed[0][1], uninterrupted[1][1]))
        got, _, _ = checkpoint.load_checkpoint(ck, 1)
        want, _, _ = checkpoint.load_checkpoint(whole, 1)
        check(sorted(got["params"]) == sorted(want["params"]), "checkpoint keys differ")
        differ = [k for k, w in want["params"].items() if not torch.equal(got["params"][k], w)]
        check(not differ, "resumed params differ from the uninterrupted run's: {}".format(differ))
        for k in ("log scan", "band grad", "pair sum"):
            check(min(pair_sum(n)[k] for n in (n_first, n_resumed, n_whole)) > 0,
                  "{} not launched: {} {} {}".format(k, n_first, n_resumed, n_whole))
        named, kernel_us, span_us = trace_kernels(trace, "epoch_0.pt.trace.json")
        leg_line(leg, "epochs {} then --resume {} against {}; epoch-1 loss {!r} == {!r}, {} "
                 "parameter tensors equal; trace events naming {}; the traced epoch 0: "
                 "kernels {:.3f} ms of a {:.3f} ms span, the card busy {:.4f} of it".format(
                     [e for e, _ in first], [e for e, _ in resumed],
                     [e for e, _ in uninterrupted], resumed[0][1], uninterrupted[1][1],
                     len(want["params"]), named, kernel_us / 1e3, span_us / 1e3,
                     kernel_us / span_us))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # 4. the latent and the flow on the synthetic corpus, <= 128 classes
    kernels = (hc.hsmm_log_scan, hc.hsmm_band_grad, hc.hsmm_gamma_scan, hc.hsmm_band_max)
    for k in kernels:
        k.launches = 0
    kw = dict(num_videos=36, n_classes=C, max_len=T, span_k=K, feature_dim=D, shift=1.0)
    train, test = SyntheticDatasplit(seed=0, **kw), SyntheticDatasplit(seed=1, **kw)
    syn_dir = tempfile.mkdtemp(prefix="chip_smoke_u7_synthetic_")

    def fit(epochs, ck, *extra):
        args = port_main.build_parser().parse_args([
            "--classifier", "semimarkov", "--training", "unsupervised", "--sm_component_model",
            "--sm_component_z_dim", "16", "--sm_feature_projection", "--flow_scale",
            "--batch_size", str(B), "--epochs", str(epochs), "--checkpoint_every", "1",
            "--checkpoint_dir", os.path.join(syn_dir, ck), *extra])
        model = SemiMarkovModel.from_args(args, train, device=device)
        stats = []
        model.fit(train, use_labels=False, callback_fn=lambda e, st: stats.append(
            (e, st["train_loss"], st["train_kl_vid_avg"])))
        return model, stats

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, syn_losses = fit(2, "whole")
        n_fit = [k.launches for k in kernels]
        preds = model.predict(test)
        torch.cuda.synchronize()
        syn_s = time.perf_counter() - t0
        n_all = [k.launches for k in kernels]
        # the latent's noise and the cuDNN LSTM across a resume
        fit(1, "split")
        _, syn_resumed = fit(2, "split", "--resume")
        got, _, _ = checkpoint.load_checkpoint(os.path.join(syn_dir, "split"), 1)
        want, _, _ = checkpoint.load_checkpoint(os.path.join(syn_dir, "whole"), 1)
    finally:
        shutil.rmtree(syn_dir, ignore_errors=True)
    n_batches = -(-kw["num_videos"] // B)
    check(all(math.isfinite(x) for e in syn_losses for x in e[1:]) and
          [e[0] for e in syn_losses] == [0, 1], "synthetic compound losses {}".format(syn_losses))
    check(n_fit == [2 * n_batches, 2 * n_batches, 0, 0],
          "synthetic compound fit launches {}: not one log scan and band grad a batch".format(
              n_fit))
    check(n_all[2:] == [n_batches, n_batches],
          "synthetic compound decode launches {}: not one gamma scan and band max a "
          "batch".format(n_all))
    check([e[0] for e in syn_resumed] == [1] and syn_resumed[0][1] == syn_losses[1][1],
          "synthetic resumed epoch {} != uninterrupted {}".format(syn_resumed, syn_losses))
    differ = [k for k, w in want["params"].items() if not torch.equal(got["params"][k], w)]
    check(not differ and sorted(got["params"]) == sorted(want["params"]),
          "synthetic resumed params differ: {}".format(differ))
    for k, count in zip(kernels, n_all):
        totals[k.__name__] += count
    syn_mof = mof(test, preds)
    check(math.isfinite(syn_mof) and len(preds) == kw["num_videos"], "synthetic MoF")
    legs["synthetic z and flow"] = {"s": syn_s, "runs": 1}
    phase("u7", "synthetic z and flow: 2 epochs x {} batches then predict in {:.3f} s; "
          "(epoch, loss, kl a video) {}; launches log scan/band grad/gamma scan/band max {}; "
          "MoF {:.4f}; resumed epoch 1 {!r} == {!r}, {} parameter tensors equal (the encoder's "
          "LSTM among them); {}".format(n_batches, syn_s, syn_losses, n_all, syn_mof,
                                        syn_resumed[0][1], syn_losses[1][1],
                                        len(want["params"]), smi))
    phase_s = time.perf_counter() - t_phase
    phase("u7", "phase 4e: {:.3f} s".format(phase_s))
    return {"u7_legs": legs, "u7_launches": totals, "u7_phase_s": phase_s,
            "u7_epoch_losses": losses, "u7_resume_loss": resumed[0][1],
            "u7_traced_epoch_busy_share": kernel_us / span_us,
            "u7_synthetic_launches": n_all, "u7_synthetic_mof": syn_mof,
            "u7_synthetic_losses": syn_losses}


# the JAX package's CrossTask fixture's data flags (tests/test_crosstask_pipeline.py):
# one background class a task, which the canonical and constraint baselines need
FIXTURE_FLAGS = ("--dataset", "crosstask", "--features", "pca", "--task_specific_steps",
                 "--mix_tasks")
GM_COVARIANCES = ("tied_diag", "diag", "full", "tied")


@contextlib.contextmanager
def baseline_recorder(port_main, cls):
    """Run the command line with pass-through shims on `cls`: test() seeds
    numpy's global stream at 0 (F1 and the sampled framewise baseline
    draw from it), and every fit and predict is recorded as (model,
    [(epoch, train_loss)]) and (model, datasplit, predictions); the
    optimizers the taggers build are kept. The debug log is held back."""
    from action_segmentation_torch.models import framewise, sequential
    from action_segmentation_torch.utils import logger

    test, fit, predict, level = port_main.test, cls.fit, cls.predict, logger.level
    makers = {mod: mod.make_optimizer for mod in (framewise, sequential)}
    rec = {"fits": [], "predicts": [], "optimizers": []}

    def seeded_test(*args, **kwargs):
        np.random.seed(0)
        return test(*args, **kwargs)

    def recorded_fit(self, train_data, use_labels, callback_fn=None):
        epochs = []
        rec["fits"].append((self, epochs))

        def callback(epoch, stats):
            epochs.append((epoch, stats.get("train_loss")))
            if callback_fn:
                callback_fn(epoch, stats)
        return fit(self, train_data, use_labels, callback_fn=callback)

    def recorded_predict(self, test_data):
        out = predict(self, test_data)
        rec["predicts"].append((self, test_data, out))
        return out

    def recorded_maker(mod):
        def make(*args, **kwargs):
            optimizer, scheduler = makers[mod](*args, **kwargs)
            rec["optimizers"].append(optimizer)
            return optimizer, scheduler
        return make

    port_main.test, cls.fit, cls.predict = seeded_test, recorded_fit, recorded_predict
    for mod in makers:
        mod.make_optimizer = recorded_maker(mod)
    logger.setLevel(logging.INFO)
    try:
        yield rec
    finally:
        port_main.test, cls.fit, cls.predict = test, fit, predict
        for mod, make in makers.items():
            mod.make_optimizer = make
        logger.setLevel(level)


def gmm_labels_agree(name, card_calls, cpu_calls):
    """The Gaussian mixture's labels on the card equal the CPU's except at
    frames where both picks are within the score tolerance of the
    float64 best (the CPU model's parameters, cast, with its log priors,
    over the video's classes). Returns (frames, differing frames)."""
    import torch

    frames = differ = 0
    check(len(card_calls) == len(cpu_calls), "{}: {} predicts on the card, {} on the CPU".format(
        name, len(card_calls), len(cpu_calls)))
    for (_, data, got), (model, _, want) in zip(card_calls, cpu_calls):
        check(got.keys() == want.keys(), name + ": predicted videos differ")
        m64 = type(model)(model.args, model.n_classes, model.feature_dim, device="cpu")
        m64.means, m64.cov = model.means.double().cpu(), model.cov.double().cpu()
        for key in data._tasks_and_video_names:
            a, b = np.asarray(got[key[1]]), np.asarray(want[key[1]])
            frames += len(b)
            idx = np.flatnonzero(a != b)
            if len(idx) == 0:
                continue
            differ += len(idx)
            sample = data[key]
            lp = m64.log_likelihoods(torch.from_numpy(sample["features"][idx]).double())
            lp = lp + model.log_priors.double().cpu()
            valid = np.zeros(lp.shape[1], bool)
            valid[np.asarray(sample["task_indices"])] = True
            lp[:, ~valid] = -np.inf
            best = lp.max(dim=1).values
            tol = RTOL * best.abs() + ATOL
            rows = torch.arange(len(idx))
            for picks in (a[idx], b[idx]):
                gap = best - lp[rows, torch.from_numpy(picks)]
                check(bool((gap <= tol).all()), "{}: {} frames of {} differ, float64 gaps {} "
                      "(tolerance {})".format(name, len(idx), key[1], gap[:8].tolist(),
                                              tol[:8].tolist()))
    return frames, differ


def module_of(model):
    """A tagger's nn.Module (the MLP or the BiLSTM tagger)."""
    import torch

    return next(m for m in vars(model).values() if isinstance(m, torch.nn.Module))


def failed_factors(calls, where="host"):
    """{(model index, class)} whose fp32 Cholesky failed, over the recorded
    full- or tied-covariance models: factored on the host, as
    ops.distributions.fullcov_factors does, or (where="device") on the
    model's device, by cuSOLVER on the card."""
    from action_segmentation_torch.ops.distributions import cholesky_or_nan

    failed = set()
    for i, (model, _, _) in enumerate(calls):
        cov = model.cov.cpu() if where == "host" else model.cov
        info = cholesky_or_nan(cov)[1].reshape(-1).cpu().numpy()
        failed |= {(i, int(c)) for c in np.flatnonzero(info)}
    return failed


def write_ct_release(root, n_train=CT_TRAIN, n_val=CT_VAL):
    """Phase 4c's CrossTask release under `root`: every primary task with
    CT_STEPS steps, `n_train` training and `n_val` val videos a task, no
    related tasks. Returns {task: steps}."""
    from action_segmentation_torch.data import minigen
    from action_segmentation_torch.data.crosstask import CrosstaskCorpus

    tasks = {task_id: ["step{}".format(i) for i in range(CT_STEPS)]
             for task_id in CrosstaskCorpus.TASK_IDS_BY_SET["primary"]}
    minigen.write_mini_crosstask(
        root, np.random.RandomState(0), tasks=tasks, related_tasks={}, n_train=n_train,
        n_val=n_val, dim_per_group=CT_DIM_PER_GROUP, **CT_RANGES)
    return tasks


def run_baselines_slice(root, smi, card=None):
    """Phase 4f: the seven baselines through main.main on the card (no
    device; `card` stands in for it in a rehearsal on the CPU): (1) the
    Gaussian mixture with each of the four covariance types under the S6
    flags, against the same command with device='cpu'; (2) the framewise
    tagger (linear and two hidden layers) and the BiLSTM tagger, 2 epochs,
    pickled, then decoded from the pickles, and their first training step
    against the CPU's, (1) and (2) on a release written as phase 4c's with
    BASELINE_TRAIN and BASELINE_VAL videos a task; (3) the host baselines
    under the JAX fixture's data flags, against the CPU, on phase 4c's
    release under `root`; (4) the Gaussian mixture on a D=64 Breakfast
    release. Every edit distance the phase's test() calls computed is
    checked against the numpy DP, accuracy_corpus is timed with each, and
    no kernel may launch. Returns the e2e record."""
    import platform

    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.data import minigen
    from action_segmentation_torch.data.batching import iter_batches
    from action_segmentation_torch.evaluation import accuracy, editdistance
    from action_segmentation_torch.models.framewise import (
        FramewiseBaseline,
        FramewiseDiscriminative,
        FramewiseGaussianMixture,
    )
    from action_segmentation_torch.models.sequential import SequentialDiscriminative
    from action_segmentation_torch.ops import hsmm_cuda as hc

    on_card = card is None or torch.device(card).type == "cuda"
    kernels = cli_kernel_wrappers()
    for k in kernels:
        k.launches = 0
    pairs = set()
    native_eval = editdistance.eval

    def recording_eval(a, b):
        pairs.add((tuple(int(x) for x in a), tuple(int(x) for x in b)))
        return native_eval(a, b)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    legs = {}

    def run(leg, argv, cls, side="card"):
        """main.main(argv) on the card, or with device='cpu' (`side`), with
        `cls` recorded; returns (stats, record). Adds the wall time to
        the leg."""
        sync()
        t0 = time.perf_counter()
        with baseline_recorder(port_main, cls) as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            stats = port_main.main(argv, device=card if side == "card" else "cpu")
        sync()
        legs.setdefault(leg, {"card_s": 0.0, "cpu_s": 0.0, "runs": 0})
        legs[leg][side + "_s"] += time.perf_counter() - t0
        legs[leg]["runs"] += 1
        return stats, rec

    def leg_line(leg, what):
        phase("baselines", "{}: {} main.main run(s), {:.3f} s on the card and {:.3f} s on the "
              "CPU; {}; {}".format(leg, legs[leg]["runs"], legs[leg]["card_s"],
                                   legs[leg]["cpu_s"], what, smi))

    def mof_of(stats, key="mof"):
        n = sum(float(s[key][0]) for by in stats.values() for s in by.values())
        d = sum(float(s[key][1]) for by in stats.values() for s in by.values())
        return n / d

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_baselines_")
    per_task = os.path.join(out_dir, "crosstask")
    write_ct_release(per_task, BASELINE_TRAIN, BASELINE_VAL)
    s6 = ["--training", "supervised", *S6_FLAGS, "--data_root", per_task,
          "--pca_components_per_group", str(CT_DIM_PER_GROUP)]
    fixture = [*FIXTURE_FLAGS, "--data_root", root, "--pca_components_per_group",
               str(CT_DIM_PER_GROUP)]
    accuracy.editdistance.eval = recording_eval
    t_phase = time.perf_counter()
    try:
        # 1. the Gaussian mixture, four covariance types, card against CPU
        for cov in GM_COVARIANCES:
            argv = ["--classifier", "framewise_gaussian_mixture", "--gm_covariance", cov, *s6]
            leg = "gmm " + cov
            got, card_rec = run(leg, argv, FramewiseGaussianMixture)
            want, cpu_rec = run(leg, argv, FramewiseGaussianMixture, "cpu")
            what = ""
            if cov in ("full", "tied"):
                # the port factors on the host on both sides; cuSOLVER's
                # verdicts on the card's matrices are read beside them
                fails = [failed_factors(r["predicts"]) for r in (card_rec, cpu_rec)]
                solver = failed_factors(card_rec["predicts"], where="device")
                what = ("factors failed (info != 0) {} on the card's run, {} on the CPU's, "
                        "of {} factors; cuSOLVER on the card's matrices would fail {} ({} not "
                        "among the host's, {} of the host's not)".format(
                            len(fails[0]), len(fails[1]), len(card_rec["predicts"]) * (
                                card_rec["predicts"][0][0].n_classes if cov == "full" else 1),
                            len(solver), len(solver - fails[0]), len(fails[0] - solver)))
                phase("baselines", "{}: {}".format(leg, what))
                check(fails[0] == fails[1], "{}: the failed factors differ, card only {}, CPU "
                      "only {}".format(leg, sorted(fails[0] - fails[1])[:8],
                                       sorted(fails[1] - fails[0])[:8]))
            frames, differ = gmm_labels_agree(leg, card_rec["predicts"], cpu_rec["predicts"])
            what = "{} val frames, {} labels differ (each a float64 near-tie){}".format(
                frames, differ, "; " + what if what else "")
            if differ == 0:
                assert_stats_equal(leg, got, want)
                what += ", stats equal"
            check(all(m.cov.device.type == ("cuda" if on_card else "cpu")
                      for m, _, _ in card_rec["predicts"]), leg + ": a model not on the card")
            leg_line(leg, "MoF {:.4f}; {}".format(mof_of(got), what))

        # 2. the trained taggers, 2 epochs, pickled and decoded from the pickles
        taggers = (
            ("framewise linear", FramewiseDiscriminative,
             ["--classifier", "framewise_discriminative"]),
            ("framewise 2 hidden", FramewiseDiscriminative,
             ["--classifier", "framewise_discriminative", "--ff_hidden_layers", "2"]),
            ("bilstm", SequentialDiscriminative,
             ["--classifier", "sequential_discriminative", "--seq_hidden_size", "200",
              "--seq_num_layers", "2"]),
        )
        step_errs, first_train = {}, None
        for leg, cls, flags in taggers:
            argv = [*flags, *s6, "--epochs", "2"]
            models = os.path.join(out_dir, leg.replace(" ", "_"))
            stats, rec = run(leg, argv + ["--model_output_path", models], cls)
            check(len(rec["fits"]) == len(stats), "{}: {} fits".format(leg, len(rec["fits"])))
            first, last = [], []
            for model, epochs in rec["fits"]:
                check([e for e, _ in epochs] == [0, 1] and all(
                    math.isfinite(x) for _, x in epochs), "{} epochs {}".format(leg, epochs))
                first.append(epochs[0][1])
                last.append(epochs[1][1])
                check(all(p.is_cuda == on_card for p in module_of(model).parameters()),
                      leg + ": a parameter off the card")
            moments = [t for opt in rec["optimizers"] for state in opt.state.values()
                       for k, t in state.items() if k != "step"]
            check(moments and all(t.is_cuda == on_card for t in moments),
                  leg + ": Adam's moments off the card")
            fell = sum(b < a for a, b in zip(first, last))
            mean0, mean1 = float(np.mean(first)), float(np.mean(last))
            check(mean1 < mean0, "{}: mean epoch loss {} -> {} did not fall".format(
                leg, mean0, mean1))
            decoded, _ = run(leg, argv + ["--model_input_path", models], cls)
            assert_stats_equal(leg + " from its pickles", decoded, stats)

            # the first training batch: one step's loss and gradients, card and CPU
            args = port_main.build_parser().parse_args(argv)
            if first_train is None:  # the taggers share the S6 data flags
                with contextlib.redirect_stdout(io.StringIO()):
                    first_train = next(iter(port_main.make_data_splits(args).values()))[0]
            train = first_train
            size = 1 if cls is FramewiseDiscriminative else args.batch_size
            batch = next(iter(iter_batches(train, batch_size=size, batch_by_task=False,
                                           shuffle=True, seed=(args.seed or 1))))
            losses, grads = [], []
            for device in (card, "cpu"):
                model = cls.from_args(args, train, device=device)
                module = module_of(model)
                loss = model.loss(batch)  # dropout off: the two devices' streams differ
                loss.backward()
                losses.append(loss.item())
                grads.append({k: p.grad.cpu() for k, p in module.named_parameters()})
            check(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]),
                  "{}: first-step loss {} on the card, {} on the CPU".format(leg, *losses))
            err = 0.0
            for k, g in grads[1].items():
                check(torch.allclose(grads[0][k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL),
                      "{}: first-step gradient {} differs".format(leg, k))
                err = max(err, float((grads[0][k] - g).abs().max()))
            step_errs[leg] = (losses, err)
            leg_line(leg, "{} models, mean epoch loss {:.4f} -> {:.4f} ({} fell), MoF {:.4f}; "
                     "decoded from its pickles: stats equal; first step (batch of {}) loss {!r} "
                     "on the card, {!r} on the CPU, gradients' largest |diff| {:.3g} (rtol "
                     "2e-3 / atol 2e-4); parameters and Adam's moments on the card".format(
                         len(first), mean0, mean1, fell, mof_of(stats), len(batch["lengths"]),
                         losses[0], losses[1], err))

        # 3. the host baselines under the fixture's data flags
        host = (
            ("majority class", FramewiseBaseline,
             ["--classifier", "framewise_baseline", "--framewise_baseline_type",
              "majority_class"]),
            ("sampled classes", FramewiseBaseline,
             ["--classifier", "framewise_baseline", "--framewise_baseline_type",
              "sample_class_distribution"]),
            ("canonical", None, ["--classifier", "sequential_canonical_baseline"]),
            ("constraints", None, ["--classifier", "sequential_predict_constraints"]),
            ("oracle", None, ["--classifier", "sequential_ground_truth"]),
        )
        host_mof = {}
        for leg, cls, flags in host:
            cls = cls or port_main.CLASSIFIERS[flags[1]]
            argv = [*flags, *fixture]
            got, _ = run(leg, argv, cls)
            want, _ = run(leg, argv, cls, "cpu")
            assert_stats_equal(leg, got, want)
            host_mof[leg] = (mof_of(got), mof_of(got, "mof_non_bg"))
            leg_line(leg, "stats equal to the CPU's, MoF {:.4f}, non-background MoF {:.4f}".format(
                *host_mof[leg]))
        check(host_mof["oracle"][0] == 1.0, "oracle MoF {}".format(host_mof["oracle"][0]))

        # 4. Breakfast at the fisher vectors' width
        bf_root = os.path.join(out_dir, "bf")
        minigen.write_mini_breakfast(bf_root, np.random.RandomState(0), dim=64)
        bf = ["--classifier", "framewise_gaussian_mixture", "--dataset", "breakfast",
              "--features", "raw", "--data_root", bf_root, "--epochs", "1"]
        bf_got, _ = run("breakfast", bf, FramewiseGaussianMixture)
        bf_want, _ = run("breakfast", bf, FramewiseGaussianMixture, "cpu")
        assert_stats_equal("breakfast", bf_got, bf_want)
        check(sorted(bf_got) == ["s1", "s2", "s3", "s4"], "breakfast splits")
        leg_line("breakfast", "{} held-out splits, MoF {:.4f}, stats equal to the CPU's".format(
            len(bf_got), mof_of(bf_got)))
    finally:
        accuracy.editdistance.eval = native_eval
        shutil.rmtree(out_dir, ignore_errors=True)

    # every edit distance the phase computed, native against the numpy DP
    t0 = time.perf_counter()
    bad = [(a, b) for a, b in pairs if native_eval(a, b) != editdistance._eval_plain(a, b)]
    check(not bad, "native edit distance differs from the numpy DP on {} of {} pairs".format(
        len(bad), len(pairs)))
    longest = max(max(len(a), len(b)) for a, b in pairs)
    phase("baselines", "edit distance: {} distinct (gt, predicted) segment sequences from the "
          "phase's test() calls, native == numpy DP on all (the longest {} segments; checked "
          "in {:.3f} s)".format(len(pairs), longest, time.perf_counter() - t0))

    # accuracy_corpus on one split, native against the numpy DP, in turns
    args = port_main.build_parser().parse_args(
        ["--classifier", "framewise_gaussian_mixture", *fixture])
    with contextlib.redirect_stdout(io.StringIO()):
        train, _, val = next(iter(port_main.make_data_splits(args).values()))
    model = FramewiseGaussianMixture.from_args(args, train, device=card)
    model.fit(train, use_labels=True)
    preds = model.predict(val)
    times = {"native": [], "plain": []}
    results = {}
    for kind in ("plain", "native", "native", "plain"):
        accuracy.editdistance.eval = native_eval if kind == "native" else \
            editdistance._eval_plain
        np.random.seed(0)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                results[kind] = val.accuracy_corpus(False, lambda v: preds[v.name],
                                                    prefix="val", verbose=False)
        finally:
            accuracy.editdistance.eval = native_eval
        times[kind].append(time.perf_counter() - t0)
    assert_stats_equal("accuracy_corpus native vs plain", {"val": results["native"]},
                       {"val": results["plain"]})
    cpu_name = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            names = [l.split(":", 1)[1].strip() for l in f if l.startswith("model name")]
        cpu_name = "{} ({} logical CPUs)".format(names[0] if names else cpu_name, len(names))
    n_segments = sum(len(a) + len(b) for a, b in pairs)
    phase("baselines", "accuracy_corpus over {} val videos (the mixed split, the tied-diagonal "
          "mixture's labels): {:.4f} s with the native edit distance, {:.4f} s with the numpy "
          "DP (each the mean of two runs in turns, plain/native/native/plain; equal stats); "
          "host {}".format(len(preds), float(np.mean(times["native"])),
                           float(np.mean(times["plain"])), cpu_name))

    launches = {k.__name__: k.launches for k in kernels}
    check(not any(launches.values()), "a baseline launched an HSMM kernel: {}".format(launches))
    phase_s = time.perf_counter() - t_phase
    phase("baselines", "kernel launches over the phase {} (all 0); phase 4f: {:.3f} s".format(
        launches, phase_s))
    return {"baseline_legs": legs, "baseline_launches": launches, "baseline_phase_s": phase_s,
            "baseline_step": step_errs, "baseline_host_mof": host_mof,
            "editdistance_pairs": len(pairs), "editdistance_segments": n_segments,
            "accuracy_corpus_native_s": float(np.mean(times["native"])),
            "accuracy_corpus_plain_s": float(np.mean(times["plain"])), "host_cpu": cpu_name}

# the host parts of a batch that phase 4g times: the streaming path's four
# (step 0) and the resident path's two
HOST_PARTS = ("reads", "collation", "device args", "upload", "build", "gather")


@contextlib.contextmanager
def host_split(regions):
    """Pass-through time.perf_counter timers on the host parts of a batch:
    the datasplit reads (Datasplit.__getitem__, with the .npy loads),
    collation and padding (batching.collate, SemiMarkovModel._pad_batch_rows),
    SemiMarkovModel._batch_device_args (the constraint expansion and the end
    masks), upload, the resident corpus's build (build_resident_corpus, its
    reads included) and its gathers (gather_resident_rows), each counted
    only inside a region (a call of one of the SemiMarkovModel methods named
    in `regions`) and outside the other parts. Yields the record: each
    part's seconds, the regions' seconds (whose rest is potentials, launches,
    glue and the region's closing wait for the card) and each region's, the
    batches and frames the regions trained (SemiMarkovModel._finish_epoch)
    and decoded (DeferredLabelDrain.add), and the corpora built and their
    bytes."""
    from action_segmentation_torch.data import batching, corpus
    from action_segmentation_torch.models import semimarkov
    from action_segmentation_torch.utils.drain import DeferredLabelDrain

    sm = semimarkov.SemiMarkovModel
    rec = dict.fromkeys(HOST_PARTS, 0.0)
    rec.update(regions=0.0, walls=[], batches=0, frames=0, builds=0, built_bytes=0,
               trained=0, decoded=0)
    state = {"depth": 0, "in_part": False}

    def part(fn, name):
        def timed(*args, **kwargs):
            if not state["depth"] or state["in_part"]:
                return fn(*args, **kwargs)
            state["in_part"] = True
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                rec[name] += time.perf_counter() - t0
                state["in_part"] = False
            if name == "build" and out is not None:
                rec["builds"] += 1
                rec["built_bytes"] += out.nbytes
            return out
        return timed

    def region(fn, _):
        def timed(*args, **kwargs):
            state["depth"] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                state["depth"] -= 1
                if not state["depth"]:
                    rec["walls"].append(time.perf_counter() - t0)
                    rec["regions"] += rec["walls"][-1]
        return timed

    def counted(fn, what):
        def count(*args, **kwargs):
            if state["depth"]:
                if what == "trained":  # (self, epoch, lr, stats, losses, log_rows, videos, frames
                    rec["batches"] += len(args[4])
                    rec["trained"] += len(args[4])
                    rec["frames"] += args[7]
                else:  # (self, (names, lengths), labels, n_rows)
                    n = kwargs.get("n_rows", args[3] if len(args) > 3 else None)
                    rec["batches"] += 1
                    rec["decoded"] += 1
                    rec["frames"] += int(np.asarray(args[1][1])[:n].sum())
            return fn(*args, **kwargs)
        return count

    shims = [(corpus.Datasplit, "__getitem__", part, "reads"),
             (batching, "collate", part, "collation"),
             (sm, "_pad_batch_rows", part, "collation"),
             (sm, "_batch_device_args", part, "device args"),
             (semimarkov, "upload", part, "upload"),
             (semimarkov, "build_resident_corpus", part, "build"),
             (semimarkov, "gather_resident_rows", part, "gather"),
             (sm, "_finish_epoch", counted, "trained"),
             (DeferredLabelDrain, "add", counted, "decoded")]
    shims += [(sm, name, region, None) for name in regions]
    saved = [(obj, name, vars(obj)[name]) for obj, name, _, _ in shims]
    try:
        for (obj, name, wrap, what), (_, _, orig) in zip(shims, saved):
            setattr(obj, name, wrap(orig, what))
        yield rec
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


# profiled's marks: host-to-card copies of sizes no case makes, PROFILE_LEAD
# of the first before fn and one of the second after it, with idle before
# the first and after the last (PROFILE_PADS_S, a try each). Late in a long
# process the trace has been seen to drop the card's records of a stretch at
# a run's start (the u7 fit's model and corpus copies, with every later copy
# kept), so a marked run whose trace lacks either mark runs again (a pad of
# 0.5 s lost the first marks of both U7 runs in every late run; 4 s kept them)
PROFILE_MARKS = (4099, 4101)
PROFILE_LEAD = 4
PROFILE_PADS_S = (4.0, 8.0, 16.0)


def profiled(fn, marked=False):
    """fn() under torch.profiler (the host and the card), then a sync:
    returns (fn's result, the kernels' summed us, the bytes of each Memcpy
    HtoD in time order) from its Chrome trace. `marked` (a single
    process's run, which may run fn again) brackets fn by PROFILE_MARKS on
    the card and returns the copies between the last first mark and the
    second, running fn anew, with a longer pad, while the trace lacks a
    mark."""
    import numpy as np
    import torch

    on_card = torch.cuda.is_available()  # a CPU rehearsal traces the host alone
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    marked = marked and on_card
    first, last = PROFILE_MARKS

    def mark(nbytes):
        torch.from_numpy(np.zeros(nbytes, np.int8)).to("cuda")
        torch.cuda.synchronize()

    for pad in PROFILE_PADS_S if marked else (0.0,):
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(pad)
            for _ in range(PROFILE_LEAD if marked else 0):
                mark(first)
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            if marked:
                mark(last)
            time.sleep(pad)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        events.sort(key=lambda e: float(e["ts"]))
        kernel_us = sum(float(e.get("dur", 0)) for e in events if e.get("cat") == "kernel")
        htod = [int(e.get("args", {}).get("bytes", 0)) for e in events
                if "Memcpy HtoD" in str(e.get("name", ""))]
        if not marked:
            return out, kernel_us, htod
        if first in htod and last in htod:
            start = len(htod) - htod[::-1].index(first)
            return out, kernel_us, htod[start:len(htod) - 1 - htod[::-1].index(last)]
        card = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        print("[profiled] pad {} s: the trace lacks a mark: {} of {} first marks, {} second; "
              "{} copies to the card ({}...), {} cudaMemcpyAsync calls; the card's first "
              "record {} s after the trace's start".format(
                  pad, htod.count(first), PROFILE_LEAD, htod.count(last), len(htod), htod[:6],
                  sum(e.get("name") == "cudaMemcpyAsync" for e in events),
                  (float(card[0]["ts"]) - float(events[0]["ts"])) / 1e6 if card else None),
              flush=True)
    check(False, "{} traces of one run each lacked a mark of {} bytes".format(
        len(PROFILE_PADS_S), PROFILE_MARKS))


def cli_argv(root, *extra):
    """The S6 flags' unsupervised command on the release under `root` (phase
    4d's third leg without its checkpoints)."""
    return ["--classifier", "semimarkov", "--training", "unsupervised", *S6_FLAGS,
            "--data_root", root, "--pca_components_per_group", str(CT_DIM_PER_GROUP),
            "--mix_tasks", "--sm_constrain_transitions", "--sm_constrain_with_narration",
            "train", *extra]


def run_host_cases(device, root, models, mixed, smi, budget_mb):
    """Phase 4g's cases at --sm_device_resident_mb `budget_mb` (0: the
    streaming path, step 0; None: the default, resident), each split by
    host_split with no profiler running, then run again under
    torch.profiler for the card's busy share (the kernels' summed time over
    the unprofiled regions' wall time) and its host-to-card copies: (1)
    predict of the 18 S6 models over the val split (resident: the corpora
    phase 4c built); (2) the constrained unsupervised fit of CT_FIT_TASKS
    tasks, 2 epochs; (3) one unsupervised --mix_tasks epoch through
    main.main (its fit and every predict of the run); (4) the U7 compound
    fit of 2 epochs on the --mix_tasks train split `mixed`. Returns
    {case: (record, the unprofiled run's result, the profiled run's
    result, its launches by CLI_KERNELS name)}."""
    import torch

    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    mode = "streaming" if budget_mb == 0 else "resident"
    budget = [] if budget_mb is None else ["--sm_device_resident_mb", str(budget_mb)]
    kernels = cli_kernel_wrappers()
    out = {}

    def case(name, work, regions, marked=False):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        with host_split(regions) as rec:
            result = work()
        launches = dict(zip(CLI_KERNELS, (k.launches for k in kernels)))
        again, kernel_us, htod = profiled(work, marked)
        n, wall, frames = rec["batches"], rec["regions"], rec["frames"]
        parts = {k: rec[k] for k in HOST_PARTS}
        parts["rest"] = wall - sum(parts.values())
        rec.update(mode=mode, wall_s=wall, frames_per_s=frames / wall,
                   ms_a_batch={k: 1e3 * v / n for k, v in parts.items()},
                   share={k: v / wall for k, v in parts.items()},
                   kernel_ms=kernel_us / 1e3, busy_share=kernel_us / 1e6 / wall,
                   htod=htod, htod_copies=len(htod), htod_bytes=sum(htod),
                   htod_max=max(htod, default=0), case_s=time.perf_counter() - t0)
        out[name] = (rec, result, again, launches)
        phase("resident", "{}, {}: {} batches, {} frames in {:.4f} s ({:.0f} frames/s); host "
              "ms a batch: {}; {} corpora built, {} bytes; the card busy {:.4f} ({:.3f} ms of "
              "kernels); {} host-to-card copies, {} bytes (the largest {}); launches {}; the "
              "case and its profiled run {:.1f} s; {}".format(
                  mode, name, n, frames, wall, frames / wall, ", ".join(
                      "{} {:.4f} ({:.1%})".format(k, rec["ms_a_batch"][k], rec["share"][k])
                      for k in parts), rec["builds"], rec["built_bytes"], rec["busy_share"],
                  rec["kernel_ms"], len(htod), sum(htod), rec["htod_max"], launches,
                  rec["case_s"], smi))

    # 1. predict over the val split
    args = models[0][1].args
    check(all(m.args is args for _, m, _, _ in models), "the S6 models share one args")
    default = args.sm_device_resident_mb
    args.sm_device_resident_mb = default if budget_mb is None else budget_mb
    try:
        case("predict", lambda: [m.predict(val) for _, m, _, val in models], ("predict",))
    finally:
        args.sm_device_resident_mb = default

    def fit_tasks(fargs, splits):
        fits = []
        for train in splits:
            model = SemiMarkovModel.from_args(fargs, train, device=device)
            losses = []
            model.fit(train, use_labels=False,
                      callback_fn=lambda e, st, losses=losses: losses.append(st["train_loss"]))
            fits.append((model, losses))
        return fits

    # 2. the constrained unsupervised fit's batches
    uargs = crosstask_args(root, "--sm_constrain_transitions", "--sm_constrain_with_narration",
                           "train", "--epochs", "2", *budget)
    trains = [train for _, _, train, _ in models[:CT_FIT_TASKS]]
    case("constrained fit", lambda: fit_tasks(uargs, trains), ("fit",))

    # 3. one --mix_tasks epoch through the command line
    argv = cli_argv(root, "--epochs", "1", *budget)

    def cli_epoch():
        with cli_recorder(port_main, SemiMarkovModel) as epochs, \
                contextlib.redirect_stdout(io.StringIO()):
            # no device, so the card (a CPU rehearsal passes its own)
            stats = port_main.main(argv, device=None if device.type == "cuda" else device)
        return stats, epochs

    # the fit (moment init, epoch, its train and dev decodes), the closing test
    case("cli --mix_tasks epoch", cli_epoch, ("fit", "predict"))

    # 4. the U7 compound fit on the --mix_tasks train split
    u7args = port_main.build_parser().parse_args(
        cli_argv(root, "--sm_component_model", "--epochs", "2", *budget))
    case("u7 fit", lambda: fit_tasks(u7args, [mixed]), ("fit",), marked=True)
    return out


def fits_equal(name, got, want):
    """Two fits' epoch losses and parameters bit for bit; returns the
    parameter tensors compared."""
    import torch

    check(len(got) == len(want), name + ": fit counts differ")
    for (gm, gl), (wm, wl) in zip(got, want):
        check(gl == wl, "{}: epoch losses {} != {}".format(name, gl, wl))
        gs, ws = gm.module.state_dict(), wm.module.state_dict()
        differ = [k for k, w in ws.items() if not torch.equal(gs[k], w)]
        check(sorted(gs) == sorted(ws) and not differ,
              "{}: parameters differ: {}".format(name, differ))
    return sum(len(m.module.state_dict()) for m, _ in got)


def run_resident_slice(device, root, models, smi):
    """Phase 4g: the resident corpus on phase 4c's release against the
    streaming path. Step 0: run_host_cases with --sm_device_resident_mb 0;
    then at the default budget. (a) The constrained fit and the U7 fit,
    resident and streaming: losses and parameters bit-equal, K2-log and K4
    once a training batch. (b) predict of the 18 S6 models: labels equal
    on every val frame, K6 and its traceback once a batch. (c) An
    unsupervised --mix_tasks main.main run --epochs 2, then --epochs 3
    --resume, resident, against an uninterrupted --epochs 3: the resumed
    epoch's loss and parameters bit for bit. (d) --sm_device_resident_mb 1
    streams (no gather) and gives (c)'s first run's stats and losses. (e)
    The profiled resident U7 fit: one corpus copy of its bytes, no copy a
    batch the size of a batch's features, fewer copies than batches. (f)
    Streaming against resident: wall, frames/s, busy share, builds.
    Returns the e2e record, the resident cases (run_host_cases's) and the
    --mix_tasks train split."""
    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main

    t_phase = time.perf_counter()
    args = port_main.build_parser().parse_args(cli_argv(root))
    with contextlib.redirect_stdout(io.StringIO()):
        mixed = port_main.make_data_splits(args)["all"][0]
    streamed = run_host_cases(device, root, models, mixed, smi, 0)
    resident = run_host_cases(device, root, models, mixed, smi, None)
    # every kernel's launches over the resident runs, by wrapper name
    totals = {k: sum(r[3][k] for r in resident.values()) for k in CLI_KERNELS}
    on_card = device.type == "cuda"  # a CPU rehearsal runs the plain versions

    # (a) the fits bit-equal, K2-log and K4 once a training batch
    n_params = {}
    for name in ("constrained fit", "u7 fit"):
        (rec, got, _, n), (_, want, _, _) = resident[name], streamed[name]
        n_params[name] = fits_equal(name, got, want)
        check(rec["builds"] == len(got) and rec["gather"] > 0 and rec["upload"] == 0,
              "{}: not resident: {} builds, gather {} s, upload {} s".format(
                  name, rec["builds"], rec["gather"], rec["upload"]))
        check(not on_card or n["log scan"] == n["band grad"] == pair_sum(n)["pair sum"]
              == rec["batches"]
              and n["forward scan"] == 0,
              "{} launches {}: not one log scan, band grad and pair grad a batch ({})".format(
                  name, n, rec["batches"]))
    phase("resident", "(a) constrained fit ({} tasks) and u7 fit (--mix_tasks), 2 epochs: "
          "resident == streaming, epoch losses and {} parameter tensors bit for bit; launches "
          "{} and {}".format(CT_FIT_TASKS, n_params, resident["constrained fit"][3],
                             resident["u7 fit"][3]))

    # (b) predict: labels equal on every val frame, K6 and its traceback a batch
    (rec, got, _, n), (_, want, _, _) = resident["predict"], streamed["predict"]
    frames = 0
    for g, w in zip(got, want):
        check(list(g) == list(w), "resident predict's videos differ")
        for video in w:
            check(np.array_equal(g[video], w[video]), "resident labels differ: " + video)
            frames += len(w[video])
    check((not on_card or n["viterbi scan"] == n["traceback"] == rec["batches"]
           and n["gamma scan"] == 0) and rec["gather"] > 0 and rec["upload"] == 0
          and rec["builds"] == 0,
          "resident predict launches {}, gather {} s, upload {} s, builds {}".format(
              n, rec["gather"], rec["upload"], rec["builds"]))
    built = [m._get_resident(val, False) for _, m, _, val in models]
    check(all(r is not None for r in built), "a val split has no resident corpus")
    phase("resident", "(b) predict, 18 S6 models: resident labels == streaming on all {} val "
          "frames; launches {} over {} batches; the 18 val corpora (built in phase 4c) {} "
          "bytes in {:.4f} s".format(frames, n, rec["batches"], sum(r.nbytes for r in built),
                                     sum(r.build_s for r in built)))

    # (c) resume, resident; (d) a 1 MB budget streams with the same results
    t_cli = time.perf_counter()
    legs, cli_totals = {}, {}
    run = cli_runner(legs, cli_totals)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_resident_")
    try:
        unsup = cli_argv(root, "--checkpoint_every", "1")
        ck, whole, trace = (os.path.join(out_dir, d) for d in ("ck", "whole", "trace"))
        stats_2, n_first, first, _ = run("resumed", unsup + [
            "--epochs", "2", "--checkpoint_dir", ck, "--profile_dir", trace])
        _, n_resumed, resumed, _ = run("resumed", unsup + [
            "--epochs", "3", "--resume", "--checkpoint_dir", ck])
        with host_split(("_train_epoch",)) as res_epochs:
            _, n_whole, uninterrupted, _ = run("resumed", unsup + [
                "--epochs", "3", "--checkpoint_dir", whole])
        with host_split(("_train_epoch",)) as str_epochs:
            stats_d, n_d, epochs_d, _ = run("streamed", unsup + [
                "--epochs", "2", "--sm_device_resident_mb", "1"])
        check([e for e, _ in first] == [0, 1] and [e for e, _ in resumed] == [2]
              and [e for e, _ in uninterrupted] == [0, 1, 2],
              "epochs run: {}, resumed {}, uninterrupted {}".format(first, resumed,
                                                                    uninterrupted))
        check(resumed[0][1] == uninterrupted[2][1], "resumed epoch-2 loss {!r} != "
              "uninterrupted {!r}".format(resumed[0][1], uninterrupted[2][1]))
        got, _, _ = checkpoint.load_checkpoint(ck, 2)
        want, _, _ = checkpoint.load_checkpoint(whole, 2)
        differ = [k for k, w in want["params"].items() if not torch.equal(got["params"][k], w)]
        check(sorted(got["params"]) == sorted(want["params"]) and not differ,
              "resumed params differ from the uninterrupted run's: {}".format(differ))
        for k in ("log scan", "band grad", "viterbi scan", "traceback"):
            check(not on_card or min(n_first[k], n_resumed[k], n_whole[k]) > 0,
                  "{} not launched: {} {} {}".format(k, n_first, n_resumed, n_whole))
        named, kernel_us, span_us = (trace_kernels(trace, "epoch_0.pt.trace.json") if on_card
                                     else ({}, 0.0, 1.0))
        for n in (n_first, n_resumed, n_whole):
            for k in CLI_KERNELS:
                totals[k] += n[k]
        check(str_epochs["gather"] == 0 and str_epochs["builds"] == 0
              and str_epochs["device args"] > 0, "--sm_device_resident_mb 1 did not stream")
        check(epochs_d == first, "streamed epoch losses {} != resident {}".format(
            epochs_d, first))
        assert_stats_equal("--sm_device_resident_mb 1 vs resident", stats_d, stats_2)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    phase("resident", "(c) --mix_tasks, resident: epochs {} then --resume {} against {}; "
          "epoch-2 loss {!r} == {!r}, {} parameter tensors equal; launches {}, {}, {}; trace "
          "events naming {}; the traced epoch 0: kernels {:.3f} ms of a {:.3f} ms span, busy "
          "{:.4f}; {}".format([e for e, _ in first], [e for e, _ in resumed],
                              [e for e, _ in uninterrupted], resumed[0][1],
                              uninterrupted[2][1], len(want["params"]), n_first, n_resumed,
                              n_whole, named, kernel_us / 1e3, span_us / 1e3,
                              kernel_us / span_us, smi))
    phase("resident", "(d) --sm_device_resident_mb 1: streamed (no gather, no build), epoch "
          "losses {} and stats == (c)'s first run's; launches {}; (c) and (d) {:.1f} s".format(
              epochs_d, n_d, time.perf_counter() - t_cli))

    # (e) the profiled resident U7 fit (the model built, its moment init,
    # the corpus, 2 epochs): one corpus copy, after it no copy a batch
    rec, _, again, _ = resident["u7 fit"]
    model = again[0][0]
    corpus = next(r for key, (_, r) in model._resident_cache.items() if key[0] == id(mixed))
    batch_bytes = args.batch_size * 32 * corpus.feat.shape[2] * 4  # the least batch's features
    at = [i for i, b in enumerate(rec["htod"]) if b == corpus.nbytes]
    after = rec["htod"][at[-1] + 1:] if at else []
    check(not on_card or len(at) == 1, "{} copies of the corpus's {} bytes".format(
        len(at), corpus.nbytes))
    check(max(after, default=0) < batch_bytes and len(after) < rec["batches"],
          "resident fit: {} host-to-card copies after the corpus over {} batches, the largest "
          "{} bytes (a batch's features: at least {})".format(
              len(after), rec["batches"], max(after, default=0), batch_bytes))
    srec = streamed["u7 fit"][0]
    phase("resident", "(e) the profiled u7 fit, 2 epochs x {} batches: resident, {} host-to-card "
          "copies: {} before the corpus (the model's parameters, the moment init), the corpus "
          "once ({} bytes), {} after it of {} bytes; streaming, {} copies of {} bytes".format(
              rec["batches"] // 2, len(rec["htod"]), at[0] if at else None, corpus.nbytes,
              len(after), after, srec["htod_copies"], srec["htod_bytes"]))

    # (f) streaming against resident
    times = {}
    for name in ("predict", "cli --mix_tasks epoch", "u7 fit"):
        a, b = streamed[name][0], resident[name][0]
        times[name] = {"streaming": a, "resident": b}
        phase("resident", "(f) {}: wall {:.4f} -> {:.4f} s ({:.2f}x), {:.0f} -> {:.0f} "
              "frames/s, busy {:.4f} -> {:.4f}; resident builds {} of {} bytes in {:.4f} s; "
              "{}".format(name, a["wall_s"], b["wall_s"], a["wall_s"] / b["wall_s"],
                          a["frames_per_s"], b["frames_per_s"], a["busy_share"],
                          b["busy_share"], b["builds"], b["built_bytes"], b["build"], smi))
    epochs = {"streaming": str_epochs["walls"], "resident": res_epochs["walls"]}
    phase("resident", "(f) the --mix_tasks training epochs of (d) and (c)'s uninterrupted run "
          "(wall s, no decodes): streaming {}, resident {}; epoch 1 {:.2f}x".format(
              epochs["streaming"], epochs["resident"],
              epochs["streaming"][1] / epochs["resident"][1]))
    phase_s = time.perf_counter() - t_phase
    phase("resident", "phase 4g: {:.3f} s".format(phase_s))

    def summary(rec):
        return {k: v for k, v in rec.items() if k not in ("htod", "walls")}

    return {"resident_step0": {k: summary(v[0]) for k, v in streamed.items()},
            "resident_cases": {k: summary(v[0]) for k, v in resident.items()},
            "resident_cli_epochs_s": epochs,
            "resident_launches": {k.__name__: totals[name] for name, k in zip(
                CLI_KERNELS, cli_kernel_wrappers())},
            "resident_u7_corpus_bytes": corpus.nbytes,
            "resident_u7_htod_after_corpus": after, "resident_phase_s": phase_s}, resident, mixed


# ----- phase 4h: data parallelism over videos -----

# the legs phase 4h times at 1 rank (phase 4g's resident cases) and 2 ranks
DP_LEGS = ("constrained fit", "u7 fit", "predict", "cli --mix_tasks epoch")
# the training legs and their single resident fits in phase 4g
DP_FITS = {"constrained fit": "constrained fit", "constrained fit, streaming": "constrained fit",
           "u7 fit": "u7 fit"}


# phase 4h(b): a first step's gradient tensors against the whole batch's, by
# relative norm |g - w| / |w|. Two ranks sum their shares in another order
# than one process sums the batch (U7's first step: about 1e-5 of the norm on
# an H100); a rank's share alone (the sum over ranks skipped) is the planted
# fault the limit must catch.
DP_GRAD_NORM_RTOL = 1e-4
# phase 4h(b): the whole batch's first step through the kernels against the
# same step with its partition in float64 (``exact_partition``), each
# gradient tensor by relative norm. On U7's emissions (about 1e4 nats a
# frame) the float32 partition was 0.41 of its norm off before the log
# scans' per-class fold and K4's chunks of 16 rows; the CPU's plain path on
# an H100's U7 potentials gives 2.1e-4 after them (PERF.md §6)
FP64_GRAD_NORM_BOUND = 1e-3


def rel_norm(got, want):
    """|got - want| / |want| in float64 (0 where both are 0)."""
    got, want = got.double(), want.double()
    den = float(want.norm())
    num = float((got - want).norm())
    return num / den if den > 0 else num


@contextlib.contextmanager
def process_group(backend, device=None):
    """A process group of one rank in this process (`backend` over a
    ``file://`` store in a temporary directory), destroyed on exit;
    yields its Mesh."""
    import torch.distributed as dist

    from action_segmentation_torch.parallel.mesh import COLLECTIVE_TIMEOUT, make_mesh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_") as tmp:
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                                rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
        try:
            yield make_mesh(1, device=device)
        finally:
            dist.destroy_process_group()


def transports(mesh):
    """Step 0 on one rank: an all_reduce SUM, an all_reduce MAX and a
    broadcast of tensors on the rank's device, each against its known
    result; returns the group's backend, the tensors' device and whether
    all three held."""
    import torch
    import torch.distributed as dist

    from action_segmentation_torch.parallel.mesh import all_reduce

    base = torch.arange(4, dtype=torch.float32, device=mesh.device)
    x = base + mesh.rank
    total = all_reduce(mesh, x.clone())
    top = all_reduce(mesh, x.clone(), dist.ReduceOp.MAX)
    sent = x.clone()
    dist.broadcast(sent, src=0, group=mesh.group)
    ok = (torch.equal(total, base * mesh.world + sum(range(mesh.world)))
          and torch.equal(top, base + mesh.world - 1) and torch.equal(sent, base))
    return {"backend": dist.get_backend(), "device": str(total.device), "world": mesh.world,
            "ok": bool(ok)}


@contextlib.contextmanager
def collective_timer():
    """Pass-through time.perf_counter shims on torch.distributed's all_reduce
    and broadcast, the port's two collectives: yields {"s", "calls"}. Under
    gloo on CUDA tensors a call blocks the host until its sum is back, so
    its time is the collective's, waits for the other rank included."""
    import torch.distributed as dist

    rec = {"s": 0.0, "calls": 0}
    saved = dist.all_reduce, dist.broadcast

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec["s"] += time.perf_counter() - t0
                rec["calls"] += 1
        return call

    dist.all_reduce, dist.broadcast = timed(saved[0]), timed(saved[1])
    try:
        yield rec
    finally:
        dist.all_reduce, dist.broadcast = saved


@contextlib.contextmanager
def exact_partition():
    """The model's partition (``semimarkov.hsmm_partition_fast``) through the
    Function's PLAIN path in float64 on the model's float32 potentials,
    rounded back: the exact gradient of the same loss, which phase 4h(b)
    holds the kernels' first step against."""
    from action_segmentation_torch.models import semimarkov
    from action_segmentation_torch.ops.hsmm_grad import PLAIN

    fast = semimarkov.hsmm_partition_fast

    def partition(pots, lengths):
        p64 = type(pots)(*(x.double() for x in pots))
        return fast(p64, lengths, PLAIN).to(pots.emit.dtype)

    semimarkov.hsmm_partition_fast = partition
    try:
        yield
    finally:
        semimarkov.hsmm_partition_fast = fast


def first_step(model, train, mesh, exact=False):
    """The first unsupervised batch of `model`'s fit on `train` (the moment
    init, rank 0's parameters, epoch 0's first batch, this rank's rows of
    it): (the batch's loss, its gradients by name and its loss-term sums on
    the CPU, its videos), summed over the mesh's ranks. A Mesh without a
    group, as a process makes one up for rank r of a world, sums nothing:
    that rank's share alone. `exact`: the partition in float64
    (``exact_partition``) instead of the kernels."""
    import torch

    from action_segmentation_torch.parallel.mesh import (
        all_reduce_grads,
        reduce_terms,
        replicate_module,
        terms_to_loss_aux,
    )

    model._moment_init(train)
    replicate_module(mesh, model.module)
    use_narration = "train" in model.args.sm_constrain_with_narration
    resident = model._get_resident(train, use_narration)
    seed = (model.args.seed or 1) + 0
    batches = (model._resident_batches(resident, seed, mesh) if resident is not None
               else model._streamed_batches(train, seed, use_narration, mesh))
    bix, size, _, batch, shard = next(iter(batches))
    with exact_partition() if exact else contextlib.nullcontext():
        loss, aux = model._loss(*batch, use_labels=False,
                                generator=model._noise_generator(0, bix, False), denom=size,
                                shard=shard)
        loss.backward()
    all_reduce_grads(mesh, list(model.module.parameters()))
    terms = reduce_terms(mesh, aux["terms"].clone())
    total, _ = terms_to_loss_aux(terms, torch.tensor(float(size), device=loss.device), False)
    grads = {n: p.grad.cpu() for n, p in model.module.named_parameters() if p.grad is not None}
    return total.item(), grads, terms.cpu(), size


def dp_fits(fargs, trains, device, mesh=None):
    """Unsupervised fits of `fargs` on each split: [(epoch losses, the
    parameters on the CPU, the state tensors unequal to rank 0's)]."""
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel
    from action_segmentation_torch.parallel.mesh import replicas_differ

    out = []
    for train in trains:
        model = SemiMarkovModel.from_args(fargs, train, device=device)
        losses = []
        model.fit(train, use_labels=False,
                  callback_fn=lambda e, st, losses=losses: losses.append(st["train_loss"]))
        out.append((losses, {k: v.detach().cpu() for k, v in model.module.state_dict().items()},
                    None if mesh is None else replicas_differ(mesh, model.module)))
    return out


def counted_cli(argv, device):
    """main.main(argv) on `device` under cli_recorder (numpy seeded at each
    test(), the epoch losses recorded, the log held back), counting the
    pickles and prediction sets this process wrote: (stats, epochs,
    writes)."""
    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    writes = {"pickles": 0, "predictions": 0}
    saved = checkpoint.save_pickle, port_main.write_predictions

    def counted(fn, what):
        def call(*args, **kwargs):
            writes[what] += 1
            return fn(*args, **kwargs)
        return call

    checkpoint.save_pickle = counted(saved[0], "pickles")
    port_main.write_predictions = counted(saved[1], "predictions")
    try:
        with cli_recorder(port_main, SemiMarkovModel) as epochs, \
                contextlib.redirect_stdout(io.StringIO()):
            stats = port_main.main(argv, device=device)
    finally:
        checkpoint.save_pickle, port_main.write_predictions = saved
    return stats, list(epochs), writes


def timed_leg(work, regions, device):
    """work() with every kernel's launch counter reset before it, under
    host_split(regions) and collective_timer, ended by a sync: (result,
    record: the regions' wall s, frames, trained and decoded batches,
    launches by CLI_KERNELS name, the collectives' s and calls)."""
    import torch

    kernels = cli_kernel_wrappers()
    if device.type == "cuda":
        torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    with host_split(regions) as rec, collective_timer() as coll:
        result = work()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return result, {"wall_s": rec["regions"], "frames": rec["frames"],
                    "trained": rec["trained"], "decoded": rec["decoded"],
                    "launches": dict(zip(CLI_KERNELS, (k.launches for k in kernels))),
                    "collective_s": coll["s"], "collective_calls": coll["calls"]}


def dp_rank(mesh, root, model_paths, out_dir, dim_per_group):
    """Phase 4h's rank body (spawned by parallel.mesh.run_ranks): step 0's
    transports, then (b) the first unsupervised steps of the constrained
    and U7 fits, the constrained fit of CT_FIT_TASKS tasks resident and
    streaming, the U7 fit on the --mix_tasks train split and predict of the
    18 S6 models (phase 4c's, from their pickles), and (c) one --mix_tasks
    main.main epoch with pickles and predictions, all with --data_parallel;
    each leg timed and counted (timed_leg), then run again under
    torch.profiler for the kernels' time. Returns CPU tensors and plain
    values. `dim_per_group` is the release's
    (a CPU rehearsal writes a narrower one), set in this fresh process."""
    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    global CT_DIM_PER_GROUP
    CT_DIM_PER_GROUP = dim_per_group
    device = mesh.device
    out = {"transports": transports(mesh)}
    with contextlib.redirect_stdout(io.StringIO()):
        splits = port_main.make_data_splits(crosstask_args(root))
        mixed = port_main.make_data_splits(
            port_main.build_parser().parse_args(cli_argv(root)))["all"][0]
    trains = [train for train, _, _ in list(splits.values())[:CT_FIT_TASKS]]
    vals = [val for _, _, val in splits.values()]
    flags = ("--sm_constrain_transitions", "--sm_constrain_with_narration", "train",
             "--epochs", "2", "--data_parallel")
    uargs = crosstask_args(root, *flags)
    sargs = crosstask_args(root, *flags, "--sm_device_resident_mb", "0")
    u7args = port_main.build_parser().parse_args(
        cli_argv(root, "--sm_component_model", "--epochs", "2", "--data_parallel"))
    out["first_steps"] = {
        "constrained": first_step(SemiMarkovModel.from_args(uargs, trains[0], device=device),
                                  trains[0], mesh),
        "u7": first_step(SemiMarkovModel.from_args(u7args, mixed, device=device), mixed, mesh)}
    models = [checkpoint.load_pickle(path, device=device) for path in model_paths]
    for model in models:
        model.args.data_parallel = True
    cli_dir = os.path.join(out_dir, "cli")
    argv = cli_argv(root, "--epochs", "1", "--data_parallel", "--model_output_path",
                    os.path.join(cli_dir, "models"), "--prediction_output_path",
                    os.path.join(cli_dir, "predictions"))
    legs = {
        "constrained fit": (lambda: dp_fits(uargs, trains, device, mesh), ("fit",)),
        "constrained fit, streaming": (lambda: dp_fits(sargs, trains, device, mesh), ("fit",)),
        "u7 fit": (lambda: dp_fits(u7args, [mixed], device, mesh), ("fit",)),
        "predict": (lambda: [m.predict(val) for m, val in zip(models, vals)], ("predict",)),
        "cli --mix_tasks epoch": (lambda: counted_cli(argv, device), ("fit", "predict")),
    }
    # as phase 4g found them in the single process: the val corpora built
    # (phase 4c) and Adam's lazy imports paid
    legs["predict"][0]()
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    for name, (work, regions) in legs.items():
        out[name] = timed_leg(work, regions, device)
    for name in DP_LEGS:
        _, kernel_us, _ = profiled(legs[name][0])
        out[name][1]["kernel_us"] = kernel_us
    return out


@contextlib.contextmanager
def reordered_batches(order):
    """Every resident batch of a fit gathers its real videos in the order
    ``order(B)`` (a permutation of range(B), on the CPU) gives: the same
    sums in another order, so a fit under it differs from the plain one
    by the single path's own float32 spread. For a model whose loss draws
    no noise a row (U7 has no latent)."""
    from action_segmentation_torch.models import semimarkov

    saved = semimarkov.gather_resident_rows

    def gather(res, table, b, with_gt=True, rows=None):
        table = table.clone()
        perm = order(b.size).to(table.device)
        table[b.row, :b.size] = table[b.row, :b.size][perm]
        return saved(res, table, b, with_gt, rows)

    semimarkov.gather_resident_rows = gather
    try:
        yield
    finally:
        semimarkov.gather_resident_rows = saved


def run_dp_slice(device, root, models, resident_cases, mixed, smi):
    """Phase 4h: data parallelism over videos on phase 4c's release. Step 0:
    the transports, two gloo ranks sharing the card (spawned) and an NCCL
    group of one. (a) World 1 under NCCL: 4d's unsupervised --mix_tasks
    command, --epochs 2, with --data_parallel against the same command
    without it, bit for bit (epoch losses, the last checkpoint's
    parameters, the pickled models' val labels, the stats), K2-log and K4
    once a training batch, K6 and its traceback once a decode batch. (b)
    Two gloo ranks on the card (dp_rank) against phase 4g's single resident
    runs: the first steps bit-equal to the shares' sum, their losses (rtol
    1e-5) and gradients (each tensor within DP_GRAD_NORM_RTOL of its norm,
    a rank's share alone not), the whole batch's within
    FP64_GRAD_NORM_BOUND of the same step with its partition in float64
    (``exact_partition``), the fits' epoch losses (rtol 1e-4, or twice
    the single path's spread under reordered_batches), the ranks' parameters
    bit-equal, predict's labels equal on every val frame, DP resident
    equal to DP streaming, the kernels once a batch on each rank. (c) A
    two-rank main.main epoch: only rank 0 writes, the ranks' stats equal,
    within tolerance of 4g's. (d) graft_entry.dryrun_multichip(2) on the
    card and graft_entry.entry (K1). (e) Each leg's wall and frames/s at 1
    and 2 ranks, the card's busy share at each, the collectives' share.
    Returns the e2e record with every kernel's dp_launches."""
    import torch

    from action_segmentation_torch import checkpoint, graft_entry
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.ops.hsmm import hsmm_partition
    from action_segmentation_torch.ops.hsmm_cuda import hsmm_forward_scan
    from action_segmentation_torch.parallel.mesh import (
        Mesh,
        run_ranks,
        single_mesh,
        terms_to_loss_aux,
    )

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    names = dict(zip(CLI_KERNELS, (k.__name__ for k in cli_kernel_wrappers())))
    dp_launches = dict.fromkeys(names.values(), 0)

    def add_launches(launches):
        for k, n in launches.items():
            dp_launches[names.get(k, k)] += n

    def once_a_batch(name, rec):
        n = rec["launches"]
        check(not on_card or (n["log scan"] == n["band grad"] == pair_sum(n)["pair sum"]
                              == rec["trained"]
                              and n["viterbi scan"] == n["traceback"] == rec["decoded"]
                              and n["forward scan"] == 0),
              "{}: launches {} against {} training and {} decode batches".format(
                  name, n, rec["trained"], rec["decoded"]))

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        # (a) world 1 under NCCL, against the same command without the flag
        t0 = time.perf_counter()
        argv = cli_argv(root, "--epochs", "2", "--checkpoint_every", "1")
        runs = {}
        with process_group("nccl" if on_card else "gloo", device=device) as mesh:
            nccl = transports(mesh)
            runs["dp"] = timed_leg(lambda: counted_cli(argv + [
                "--data_parallel", "--model_output_path", os.path.join(out_dir, "a_dp"),
                "--checkpoint_dir", os.path.join(out_dir, "a_dp_ck")], device),
                ("fit", "predict"), device)
        runs["single"] = timed_leg(lambda: counted_cli(argv + [
            "--model_output_path", os.path.join(out_dir, "a_single"),
            "--checkpoint_dir", os.path.join(out_dir, "a_single_ck")], device),
            ("fit", "predict"), device)
        check(nccl["ok"], "the NCCL group of one: {}".format(nccl))
        (dp_stats, dp_epochs, _), dp_rec = runs["dp"]
        (single_stats, single_epochs, _), single_rec = runs["single"]
        check(dp_epochs == single_epochs and len(dp_epochs) == 2,
              "world 1 epoch losses {} != {}".format(dp_epochs, single_epochs))
        assert_stats_equal("world 1 vs single", dp_stats, single_stats)
        got, _, _ = checkpoint.load_checkpoint(os.path.join(out_dir, "a_dp_ck"), 1)
        want, _, _ = checkpoint.load_checkpoint(os.path.join(out_dir, "a_single_ck"), 1)
        differ = [k for k, w in want["params"].items() if not torch.equal(got["params"][k], w)]
        check(sorted(got["params"]) == sorted(want["params"]) and not differ,
              "world 1 parameters differ: {}".format(differ))
        with contextlib.redirect_stdout(io.StringIO()):
            mixed_val = port_main.make_data_splits(
                port_main.build_parser().parse_args(cli_argv(root)))["all"][2]
        labels = [checkpoint.load_pickle(os.path.join(out_dir, d, "all.pkl"),
                                         device=device).predict(mixed_val)
                  for d in ("a_dp", "a_single")]
        check(list(labels[0]) == list(labels[1]) and all(
            np.array_equal(labels[0][v], labels[1][v]) for v in labels[1]),
            "world 1 pickled model's val labels differ")
        for name in ("dp", "single"):
            once_a_batch("(a) " + name, runs[name][1])
        add_launches(dp_rec["launches"])
        phase("dp", "step 0: an NCCL group of one on {}: all_reduce SUM and MAX and broadcast "
              "of CUDA tensors held ({}; NCCL never stages through the host)".format(
                  nccl["device"], nccl["backend"]))
        phase("dp", "(a) world 1 under NCCL, --mix_tasks --epochs 2 with --data_parallel == "
              "without it: epoch losses {}, {} parameter tensors, the pickled models' labels "
              "on {} val videos and the stats bit for bit; launches {} over {} training and {} "
              "decode batches; {:.3f} s, without the flag {:.3f} s; {:.1f} s".format(
                  dp_epochs, len(want["params"]), len(labels[1]), dp_rec["launches"],
                  dp_rec["trained"], dp_rec["decoded"], dp_rec["wall_s"],
                  single_rec["wall_s"], time.perf_counter() - t0))

        # (b), (c) and (e): two gloo ranks sharing the card
        t0 = time.perf_counter()
        paths = []
        for i, (_, model, _, _) in enumerate(models):
            paths.append(os.path.join(out_dir, "s6", "{}.pkl".format(i)))
            checkpoint.save_pickle(model, paths[-1])
        ranks = run_ranks(dp_rank, 2, root, paths, out_dir, CT_DIM_PER_GROUP, device=device,
                          backend="gloo", timeout=900)
        spawn_s = time.perf_counter() - t0
        for rank, r in enumerate(ranks):
            check(r["transports"]["ok"] and r["transports"]["backend"] == "gloo",
                  "rank {} transports: {}".format(rank, r["transports"]))
        phase("dp", "step 0: two gloo ranks spawned on {}: all_reduce SUM and MAX and broadcast "
              "of CUDA tensors held on both (gloo took the CUDA tensors directly; no staging "
              "by the port)".format(ranks[0]["transports"]["device"]))

        # the first steps against the single path's
        trains = [train for _, _, train, _ in models[:CT_FIT_TASKS]]
        uargs = crosstask_args(root, "--sm_constrain_transitions",
                               "--sm_constrain_with_narration", "train", "--epochs", "2")
        u7args = port_main.build_parser().parse_args(
            cli_argv(root, "--sm_component_model", "--epochs", "2"))
        from action_segmentation_torch.models.semimarkov import SemiMarkovModel

        first = {"constrained": (uargs, trains[0]), "u7": (u7args, mixed)}
        step_errs, fault_errs, fp64_errs = {}, {}, {}
        for name, (fargs, train) in first.items():
            want_loss, want_grads, _, size = first_step(
                SemiMarkovModel.from_args(fargs, train, device=device), train,
                single_mesh(device))
            # the kernels' step against the same step with its partition exact
            _, exact_grads, _, _ = first_step(
                SemiMarkovModel.from_args(fargs, train, device=device), train,
                single_mesh(device), exact=True)
            fp64_errs[name] = max(rel_norm(want_grads[k], x) for k, x in exact_grads.items())
            check(fp64_errs[name] <= FP64_GRAD_NORM_BOUND,
                  "{} first step: a gradient {} of its norm off the float64 partition's "
                  "(bound {})".format(name, fp64_errs[name], FP64_GRAD_NORM_BOUND))
            # the two ranks' shares in this process, summed here: what the
            # ranks' all_reduce must give, bit for bit
            shares = [first_step(SemiMarkovModel.from_args(fargs, train, device=device), train,
                                 Mesh(None, r, 2, device)) for r in (0, 1)]
            emu_loss = terms_to_loss_aux(shares[0][2] + shares[1][2],
                                         torch.tensor(float(size)), False)[0].item()
            emu = {k: shares[0][1][k] + shares[1][1][k] for k in shares[0][1]}
            # the planted fault: each rank's share alone, as if the sum were
            # skipped; the check must catch it on some rank
            flat = [torch.cat([g[k].reshape(-1) for k in sorted(want_grads)])
                    for g in (shares[0][1], shares[1][1], want_grads)]
            fault_errs[name] = [rel_norm(f, flat[2]) for f in flat[:2]]
            check(max(fault_errs[name]) > DP_GRAD_NORM_RTOL,
                  "{} first step: each rank's share alone is within {} of the whole batch's "
                  "gradients ({})".format(name, DP_GRAD_NORM_RTOL, fault_errs[name]))
            for rank, r in enumerate(ranks):
                loss, grads, _, _ = r["first_steps"][name]
                check(loss == emu_loss and sorted(grads) == sorted(emu) and all(
                    torch.equal(grads[k], emu[k]) for k in emu),
                      "{} first step, rank {}: not the two shares' sum".format(name, rank))
                check(abs(loss - want_loss) <= 1e-5 * abs(want_loss),
                      "{} first step, rank {}: loss {} != {}".format(name, rank, loss,
                                                                    want_loss))
                check(sorted(grads) == sorted(want_grads), name + ": gradients' names")
                for k, w in want_grads.items():
                    err = rel_norm(grads[k], w)
                    check(err <= DP_GRAD_NORM_RTOL,
                          "{} first step, rank {}: gradient {} off by {} of its norm".format(
                              name, rank, k, err))
                    step_errs[name] = max(step_errs.get(name, 0.0), err)

        # the fits against phase 4g's single resident fits, every epoch at
        # rtol 1e-4 or, where the single path's own float32 spread is wider,
        # within twice that spread: the largest gap of two single fits whose
        # batches sum their videos in another order (reversed, rotated by
        # one). Adam carries the first step's rounding on (U7's gradients
        # reach 1e5, so their sums round in units), and DP's two shares are
        # one more such order. The ranks' parameters equal.
        orders = {"reversed": lambda n: torch.arange(n - 1, -1, -1),
                  "rotated": lambda n: torch.roll(torch.arange(n), 1)}
        spread = {}
        for name, single in DP_FITS.items():
            if single in spread:
                continue
            fargs, trains_of = ((uargs, trains) if single == "constrained fit"
                                else (u7args, [mixed]))
            want = resident_cases[single][1]
            gaps = []
            for order in orders.values():
                with reordered_batches(order):
                    fits = dp_fits(fargs, trains_of, device)
                for (losses, _, _), (_, want_losses) in zip(fits, want):
                    gaps.append([abs(a - b) / abs(b) for a, b in zip(losses, want_losses)])
            spread[single] = np.max(gaps, axis=0).tolist()
        loss_gaps = {}
        for name, single in DP_FITS.items():
            want = resident_cases[single][1]
            limit = np.maximum(1e-4, 2.0 * np.asarray(spread[single]))
            for rank, r in enumerate(ranks):
                fits, rec = r[name]
                once_a_batch("(b) {}, rank {}".format(name, rank), rec)
                check(len(fits) == len(want), name + ": fit count")
                for (losses, params, differ), (_, want_losses), (_, params0, _) in zip(
                        fits, want, ranks[0][name][0]):
                    gap = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
                    loss_gaps[name] = np.maximum(loss_gaps.get(name, 0.0), gap).tolist()
                    check(len(losses) == len(want_losses) and all(np.asarray(gap) <= limit),
                          "{}, rank {}: epoch losses {} vs single {}: gaps {} over {} (the "
                          "single path's spread {})".format(
                              name, rank, losses, want_losses, gap, limit.tolist(),
                              spread[single]))
                    check(differ == [] and all(torch.equal(params[k], params0[k])
                                               for k in params0),
                          "{}, rank {}: parameters differ from rank 0's: {}".format(
                              name, rank, differ))
        for rank, r in enumerate(ranks):
            for (l_res, p_res, _), (l_str, p_str, _) in zip(
                    r["constrained fit"][0], r["constrained fit, streaming"][0]):
                check(l_res == l_str and all(torch.equal(p_res[k], p_str[k]) for k in p_res),
                      "rank {}: DP resident fit != DP streaming fit".format(rank))
        # predict: labels equal on every val frame
        want = resident_cases["predict"][1]
        frames = 0
        for rank, r in enumerate(ranks):
            got, rec = r["predict"]
            once_a_batch("(b) predict, rank {}".format(rank), rec)
            for g, w in zip(got, want):
                check(list(g) == list(w), "DP predict's videos differ")
                for video in w:
                    check(np.array_equal(g[video], w[video]),
                          "rank {}: DP labels differ: {}".format(rank, video))
                    frames += len(w[video]) if rank == 0 else 0
        for r in ranks:
            for name in ("constrained fit", "constrained fit, streaming", "u7 fit", "predict"):
                add_launches(r[name][1]["launches"])
        phase("dp", "(b) two gloo ranks on the card against phase 4g's single resident runs: "
              "the first steps bit-equal to the two shares' sum taken in this process, and "
              "against the whole batch: losses at rtol 1e-5, each gradient tensor within {} "
              "of its norm (largest {}; each rank's share alone, the planted fault, {}); the "
              "whole batch's against its partition in float64, each gradient within {} of its "
              "norm (largest {}); the "
              "constrained fit ({} tasks) and the U7 fit, 2 epochs, each epoch's loss within "
              "rtol 1e-4 or twice the single path's spread under reordered batches (gaps by "
              "epoch {}; spread {}; constrained {} vs {}; u7 {} vs {}), each rank's "
              "parameters bit-equal to rank 0's; DP resident == DP streaming bit for bit; "
              "predict of the 18 S6 models: labels equal on all {} val frames; launches on "
              "rank 0: {}".format(
                  DP_GRAD_NORM_RTOL, step_errs, fault_errs, FP64_GRAD_NORM_BOUND, fp64_errs,
                  CT_FIT_TASKS, loss_gaps, spread,
                  ranks[0]["constrained fit"][0][0][0],
                  resident_cases["constrained fit"][1][0][1], ranks[0]["u7 fit"][0][0][0],
                  resident_cases["u7 fit"][1][0][1],
                  frames, {k: ranks[0][k][1]["launches"] for k in DP_FITS}))

        # (c) the two-rank command line
        (s0, e0, w0), rec0 = ranks[0]["cli --mix_tasks epoch"]
        (s1, e1, w1), rec1 = ranks[1]["cli --mix_tasks epoch"]
        assert_stats_equal("the two ranks' command line", s1, s0)
        check(e0 == e1, "the ranks' epoch losses {} != {}".format(e0, e1))
        check(w0["pickles"] > 0 and w0["predictions"] > 0
              and w1 == {"pickles": 0, "predictions": 0},
              "writes: rank 0 {}, rank 1 {}".format(w0, w1))
        cli_dir = os.path.join(out_dir, "cli")
        pickles = sorted(os.listdir(os.path.join(cli_dir, "models")))
        written = len(os.listdir(os.path.join(cli_dir, "predictions")))
        n_val = len(mixed_val._tasks_and_video_names)
        check(pickles == ["all.pkl", "all_epoch-0.pkl"] and written == n_val,
              "the command line wrote {} and {} prediction files ({} val videos)".format(
                  pickles, written, n_val))
        (want_stats, want_epochs) = resident_cases["cli --mix_tasks epoch"][1]
        check(np.allclose([l for _, l in e0], [l for _, l in want_epochs], rtol=1e-4, atol=0),
              "two-rank epoch loss {} vs single {}".format(e0, want_epochs))
        gaps = []
        for task, w in want_stats["all"].items():
            for key in ("mof", "f1"):
                a, b = s0["all"][task][key], w[key]
                gaps.append(abs(float(a[0]) / float(a[1]) - float(b[0]) / float(b[1])))
        check(max(gaps) < 0.05, "two-rank MoF/F1 off the single run's by {}".format(max(gaps)))
        once_a_batch("(c) rank 0", rec0)
        for r in ranks:
            add_launches(r["cli --mix_tasks epoch"][1]["launches"])
        phase("dp", "(c) two-rank main.main --mix_tasks epoch: the ranks' stats equal, epoch "
              "loss {} (single {}), MoF/F1 within {:.4f} of the single run's; rank 0 wrote {} "
              "({} pickles, {} prediction sets), rank 1 nothing; launches {}; the ranks' "
              "run {:.1f} s with their spawn and loads".format(
                  e0, want_epochs, max(gaps), pickles, w0["pickles"], w0["predictions"],
                  rec0["launches"], spawn_s))

        # (d) the dry run on the card and the entry's forward step (K1)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as dry_out:
            dry = graft_entry.dryrun_multichip(2, device=device)
        stages = [line for line in dry_out.getvalue().splitlines() if line.startswith("dryrun")]
        check(len(stages) == 6 and all(" OK" in line for line in stages),
              "dry run: {}".format(stages))
        for launches in dry["launches"]:
            check(not on_card or (launches["hsmm_gamma_scan"] > 0 and
                                  launches["hsmm_band_max"] > 0 and
                                  launches["hsmm_log_scan"] == launches["hsmm_band_grad"]
                                  == launches["hsmm_pair_grad_narrow"] > 0),
                  "dry run launches {}".format(launches))
            add_launches(launches)
        hsmm_forward_scan.launches = 0
        fn, example = graft_entry.entry(device)
        logz = fn(*example)
        k1 = hsmm_forward_scan.launches
        with torch.no_grad():
            pots, log_det, _ = example[0].compute_potentials(*example[1:])
            want_logz = hsmm_partition(pots, example[2]) + log_det
        assert_close("entry forward", logz, want_logz)
        check(not on_card or k1 == 1, "entry launched the forward scan {} times".format(k1))
        add_launches({"forward scan": k1})
        for line in stages:
            phase("dp", "(d) " + line)
        phase("dp", "(d) the dry run's ranks launched {}; graft_entry.entry: logZ + log_det "
              "{} against the plain partition at rtol 1e-5 / atol 1e-4, the forward scan "
              "(K1) {} time; {:.1f} s".format(dry["launches"], logz.tolist(), k1,
                                              time.perf_counter() - t0))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # (e) times at 1 rank (phase 4g's resident cases) and 2 ranks
    times = {}
    for name in DP_LEGS:
        one = resident_cases[name][0]
        recs = [r[name][1] for r in ranks]
        wall = max(rec["wall_s"] for rec in recs)
        kernel_us = sum(rec["kernel_us"] for rec in recs)
        times[name] = {
            "one_rank": {"wall_s": one["wall_s"], "frames_per_s": one["frames_per_s"],
                         "busy_share": one["busy_share"]},
            "two_ranks": {"wall_s": wall, "frames_per_s": recs[0]["frames"] / wall,
                          "busy_share": kernel_us / 1e6 / wall,
                          "kernel_ms": kernel_us / 1e3,
                          "collective_share": [rec["collective_s"] / rec["wall_s"]
                                               for rec in recs],
                          "collective_calls": recs[0]["collective_calls"],
                          "batches": recs[0]["trained"] + recs[0]["decoded"]}}
        two = times[name]["two_ranks"]
        phase("dp", "(e) {}: 1 rank {:.4f} s, {:.0f} frames/s, busy {:.4f}; 2 gloo ranks on the "
              "card {:.4f} s ({:.2f}x), {:.0f} frames/s, busy {:.4f} ({:.3f} ms of kernels, both "
              "ranks); the collectives {} calls, {} of each rank's wall; {}".format(
                  name, one["wall_s"], one["frames_per_s"], one["busy_share"], wall,
                  one["wall_s"] / wall, two["frames_per_s"], two["busy_share"],
                  two["kernel_ms"], two["collective_calls"],
                  ["{:.4f}".format(x) for x in two["collective_share"]], smi))
    phase_s = time.perf_counter() - t_phase
    phase("dp", "phase 4h: {:.3f} s".format(phase_s))
    return {"dp_times": times, "dp_launches": dp_launches, "dp_world1_s": {
        "dp": dp_rec["wall_s"], "single": single_rec["wall_s"]},
        "dp_first_step_grad_rel_norm": step_errs, "dp_planted_fault_rel_norm": fault_errs,
        "dp_single_spread": spread, "dp_epoch_loss_max_rel_gap":
        loss_gaps, "dp_phase_s": phase_s}


# ----- phase 4i: a DP wider than 128 classes -----

# the wide kernels' cases, (C, Km) with Km = K - 1 duration rows, at B_WIDE
# videos of T_WIDE[C] frames, ragged down to 1: the plain log scan is a
# Python loop over C, so the log scans' cases stay at T <= 256 (they are
# checked at the S6 shape at T_S6_LOG), each past SCAN_FOLD = 64 frames so
# that the log scans fold. 664 and 665 are the widest DP the wide scans'
# cluster route takes (at Km = 1) and the next, on the grid route. Km = 64
# takes K4 wide's slab past its 27 durations (Km = 25, a case of the narrow
# template's carry, is not one for the wide kernels' rings, and left out to
# hold the smoke's wall with the longer cases)
WIDE_CLASSES = (129, 342, 664, 665, 1024)
WIDE_KMS = (1, 19, 64)
B_WIDE = 4
T_WIDE = {129: 256, 342: 128, 664: 80, 665: 80, 1024: 80}
# the long wide case against float64 (tests/test_torch_wide_long_video.py's
# draws at T = 4,096): d300_case's seed-10 draws at B=1, C=136 (a cluster
# of one block), K=20; the centred kernel path within the narrow route's
# T=4,096 bounds
WIDE_LONG = dict(b=1, t=4096, c=136)
WIDE_LONG_BOUNDS = dict(gap=0.02, emit=0.02)
# the wide kernels' times before the wide fold (PERF.md §6), printed beside
# this run's: W1 log and fwd at the S6 shape (the cluster route as of commit
# b8d2282, the same source through e050508) and at B=18, T=1024, C=1,577
# (phase 4j(c); the grid route as of 39d6789, the same through e050508), K4
# wide on one chunk a video (phase 4i(d); as of bcac8be, on the inputs
# e050508 gave it above 128 classes); NVIDIA H100 80GB HBM3, 700 W
WIDE_EARLIER_MS = {"hsmm_log_scan_wide": 6.934, "hsmm_forward_scan_wide": 6.891,
                   "hsmm_band_grad_wide": 0.4153}
PAST_EARLIER_MS = {"hsmm_log_scan_wide": 86.97, "hsmm_forward_scan_wide": 40.22,
                   "hsmm_band_grad_wide": 1.7754}
# segment_with_marginals' max |sum_c marginal - 1| in phases 4i(b) and 4j(b)
# before the wide fold (commits c6fe124 and e050508; PERF.md §6)
WIDE_GAPS_BEFORE = {"wide": 0.00249, "past1024": 0.00600}
# the S6 model's classes: 18 tasks x (2 x 9 steps + 1)
C_S6 = 342
T_S6_LOG = 256
# phase 4i(c): the backward at a wide DP on the synthetic corpus
WIDE_FIT = dict(num_videos=36, n_classes=160, max_len=200, span_k=K, feature_dim=16, shift=1.0)
# W2 as of commit b8d2282 (every code staged and rewritten by 16 warps) at
# the S6 shape, from a replayed graph of 50 (PERF.md §6, NVIDIA H100 80GB
# HBM3, 700 W), printed beside the current kernel's time
W2_EARLIER_MS = 0.18801
WIDE_KERNEL_NAMES = ("hsmm_viterbi_scan_wide", "hsmm_viterbi_traceback_wide",
                     "hsmm_log_scan_wide", "hsmm_forward_scan_wide", "hsmm_band_grad_wide")
# the narrow kernels a wide leg must not launch
NARROW_NAMES = ("hsmm_viterbi_scan", "hsmm_viterbi_traceback", "hsmm_gamma_scan",
                "hsmm_band_max", "hsmm_log_scan", "hsmm_forward_scan", "hsmm_band_grad",
                "hsmm_pair_grad_narrow")
# the training backward's pair sum, either route (``launches`` counts
# both); at a wide DP every launch takes the tensor route (the narrow
# route's wrapper, hsmm_pair_grad_narrow, is among NARROW_NAMES)
PAIR_NAME = "hsmm_pair_grad"
PAIR_NARROW_NAME = "hsmm_pair_grad_narrow"
# the tensor route's kernel
PAIR_TENSOR_KERNEL = "pair_grad_kernel"


def wide_counters():
    """{name: wrapper} of the wide kernels, the narrow kernels and the
    pair sum's."""
    from action_segmentation_torch.ops import hsmm_cuda as hc

    return {n: getattr(hc, n) for n in WIDE_KERNEL_NAMES + NARROW_NAMES + (PAIR_NAME,)}


def counted(fn):
    """(fn()'s result, {kernel name: launches}) with every wide and
    narrow counter set to 0 just before fn and read just after."""
    import torch

    wrappers = wide_counters()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: w.launches for n, w in wrappers.items()}


def grid_launches(trans, N, C, Km, device):
    """The grid route's launches for N chains reading `trans` (any of the
    wide scans' forms) on the card: the rule's (``wide_grid_instance``),
    then that tiling with its table slab and its ring in global memory,
    and with its chains split over two launches (N > 1)."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc

    _, group = hc._wide_tables("grid_launches", trans, N, C)
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else hc.H100_SMS
    rule = hc.wide_grid_instance(C, Km, N, group, sms)
    moved = rule._replace(table="global", ring="global", smem_bytes=hc.wide_grid_smem(
        C, Km, rule.slab, rule.chains, "global", "global"))
    out = [rule, moved]
    if N > 1:
        half = -(-N // 2)
        out.append(moved._replace(launch_chains=half, blocks=-(-half // moved.chains) * -(
            -C // moved.slab)))
    return out


def class_folds(emit):
    """How often a log scan's classes fold their own prefix sums on
    `emit` (N, T, C): the (chain, step, class) triples where |cum| passes
    SCAN_FOLD_LIMIT after the step's alpha (``hsmm_cuda._scan_plain``; the
    prefix sums alone decide it, the chain's fold resetting them)."""
    import torch

    from action_segmentation_torch.ops.hsmm_cuda import SCAN_FOLD, SCAN_FOLD_LIMIT

    Tn = emit.shape[1]
    cum = torch.zeros_like(emit[:, 0])
    fired = torch.zeros((), dtype=torch.long, device=emit.device)
    for t in range(Tn):
        cum = cum + emit[:, t]
        big = cum.abs() > SCAN_FOLD_LIMIT
        fired += big.sum()
        cum = torch.where(big, torch.zeros_like(cum), cum)
        if t % SCAN_FOLD == SCAN_FOLD - 1:
            cum = torch.zeros_like(cum)
    return int(fired)


def wide_kernel_case(name, pots, lengths, log_cut=None):
    """The wide kernels (W1's three instances, W2, K4's) at C > 128
    against their plain versions on the same inputs, each equal: the
    backpointer scan (alphas and codes) and the traceback on the forward
    model; the log scan (gamma, alphas, offsets: the fold included) on the
    stacked forward and reversed chains (an expanded table's two) and the
    forward scan (alphas, offsets) on the forward half (the plain forward
    scan is that half of the plain log scan's), each through its wrapper on
    the route it picks and,
    on the card, on the grid route's launches (``grid_launches``: the
    rule's where the cluster route runs, the table slab and ring in global
    memory, the chains split); K4 (its wide kernel) on the kernel log
    scan's band inputs (qg, sa, st equal, lg at the score tolerance) and
    the pair sum on the backward's X, Y and Z (``check_pair_grad``). With `log_cut`, the log
    scans are compared on the first `log_cut` frames (the plain log scan's
    Python loop over C) and K4 runs on the full-length kernel planes.
    Returns the errors and the inputs of each kernel."""
    import torch

    from action_segmentation_torch.ops.hsmm import _durations, _finals
    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_grad_plain,
        _forward_chains,
        _launch_wide_scan,
        _log_scan_plain,
        _stack_fwd_rev,
        _traceback_plain,
        _viterbi_scan_plain,
        code_radix,
        hsmm_band_grad,
        hsmm_forward_scan_wide,
        hsmm_log_scan_wide,
        hsmm_viterbi_scan_wide,
        hsmm_viterbi_traceback_wide,
        wide_scan_instance,
    )

    Bn, Tn, Cn = pots.emit.shape
    L = lengths.long().clamp(min=1)
    vit_in = (pots.trans.contiguous(), pots.init.contiguous(),
              _durations(pots.lens).contiguous(), pots.emit.contiguous())
    Km = vit_in[2].shape[1]
    alphas_k, bp_k = hsmm_viterbi_scan_wide(*vit_in)
    alphas_p, bp_p = _viterbi_scan_plain(*vit_in)
    torch.cuda.synchronize()
    check_equal(name + " wide viterbi scan alphas", alphas_k, alphas_p)
    check_equal(name + " wide viterbi scan codes", bp_k, bp_p)
    tb_in = (bp_k, L, _finals(alphas_k, L, pots.end_mask).argmax(dim=-1))
    spans_k = hsmm_viterbi_traceback_wide(*tb_in)
    spans_p = _traceback_plain(*tb_in)
    torch.cuda.synchronize()
    check_equal(name + " wide traceback spans", spans_k, spans_p)

    scan_in = _stack_fwd_rev(pots, L)
    log_k = hsmm_log_scan_wide(*scan_in)
    cut = scan_in if log_cut is None else (*scan_in[:3], scan_in[3][:, :log_cut].contiguous())
    cut_k = hsmm_log_scan_wide(*cut) if log_cut is not None else log_k
    log_p = _log_scan_plain(*cut)
    fwd_in = _forward_chains(cut, Bn)
    fwd_k = hsmm_forward_scan_wide(*fwd_in)
    fwd_p = (log_p[1][:Bn], log_p[2][:Bn])
    torch.cuda.synchronize()
    for what, k, p in zip(("gamma", "alphas", "offsets"), cut_k, log_p):
        check_equal("{} wide log scan {}".format(name, what), k, p)
    for what, k, p in zip(("alphas", "offsets"), fwd_k, fwd_p):
        check_equal("{} wide forward scan {}".format(name, what), k, p)
    fired = class_folds(cut[3])
    chain_folds = int((log_p[2][:, 1:] != 0).sum())
    inst = wide_scan_instance(Cn, Km)
    grids = 0
    if pots.emit.is_cuda:  # the same cases on the grid route's launches
        dev = pots.emit.device
        for symbol, inputs, want, ints in (
                ("hsmm_wide_viterbi_scan", vit_in, (alphas_p, bp_p), [code_radix(Cn)]),
                ("hsmm_wide_log_scan", cut, log_p, []),
                ("hsmm_wide_forward_scan", fwd_in, fwd_p, [])):
            N = inputs[3].shape[0]
            for grid in grid_launches(inputs[0], N, Cn, Km, dev):
                outs = [torch.empty_like(w) for w in want]
                _launch_wide_scan(symbol, symbol, *inputs, outs, ints, inst=grid)
                torch.cuda.synchronize()
                for k, (got, w) in enumerate(zip(outs, want)):
                    check_equal("{} {} output {} on the grid route ({} chains x {} classes a "
                                "block, table {}, ring {}, {} chains a launch)".format(
                                    name, symbol, k, grid.chains, grid.slab, grid.table,
                                    grid.ring, grid.launch_chains), got, w)
                grids += 1

    grad_in = grad_inputs(pots, L, *log_k)
    bg_k = hsmm_band_grad(*grad_in)
    bg_p = _band_grad_plain(*grad_in)
    torch.cuda.synchronize()
    check_band_grad("{} band grad ({} chunks)".format(name, grad_in[0].shape[0] // Bn), bg_k,
                    bg_p)
    errs = {"viterbi_scan": max_err(alphas_k, alphas_p), "traceback": 0.0,
            "log_scan": max(max_err(k, p) for k, p in zip(cut_k, log_p)),
            "forward_scan": max(max_err(k, p) for k, p in zip(fwd_k, fwd_p)),
            "band_grad": max(max_err(k, p) for k, p in zip(bg_k, bg_p)),
            "pair_grad": check_pair_grad(name, pair_inputs(pots, L, log_k))}
    phase("wide", "(a) {}: B={} T={} C={} Km={} lengths {}-{}: {} route (cluster {}, slab {}), "
          "and {} grid-route launches: viterbi scan alphas and codes, traceback spans ({} "
          "segments), log scan gamma, alphas and offsets{} and forward alphas and offsets "
          "equal to the plain versions (the chains' folds {}, the classes' own {} of {} "
          "(chain, step, class)); band grad on {} chunks a video qg/sa/st equal, lg "
          "max_abs_err {:g}; pair grad max_abs_err {:g}, two launches equal".format(
              name, Bn, Tn, Cn, Km, int(L.min()), int(L.max()), inst.route,
              inst.cluster, inst.slab, grids,
              int((spans_k >= 0).sum()), "" if log_cut is None else " (first {} frames)".format(
                  log_cut), chain_folds, fired, cut[3].numel(), grad_in[0].shape[0] // Bn,
              errs["band_grad"], errs["pair_grad"]))
    return errs, vit_in, tb_in, scan_in, fwd_in, grad_in


def wide_pair_case(name, rng, Cn, device):
    """The pair sum at B=2, T=1,024 over Cn classes (one video whole, one
    of two thirds of it) on the kernel log scan's planes, with the expanded table and
    with a table a video: each against its plain version
    (``check_pair_grad``), the same bits in two launches. Returns the
    larger error."""
    from action_segmentation_torch.ops.hsmm_cuda import _stack_fwd_rev, hsmm_log_scan

    pots, L = serving_pots(rng, 2, T, Cn, K, device, lengths=np.array([T, 2 * T // 3], np.int32))
    L = L.long()
    scan = hsmm_log_scan(*_stack_fwd_rev(pots, L))
    errs = {what: check_pair_grad("{} B=2 T={} C={} ({} trans)".format(name, T, Cn, what),
                                  pair_inputs(p, L, scan))
            for what, p in (("expanded", pots),
                            ("per-video", pots._replace(trans=pots.trans.contiguous())))}
    phase(name, "(a) pair grad at B=2 T={} C={} K={} (lengths {}): kernel vs plain max_abs_err "
          "{}, two launches equal".format(T, Cn, K, L.tolist(), errs))
    return max(errs.values())


def pair_tensor_entry(pair_in, launches, sms, clock_mhz, smi, where, plain_videos=None):
    """The kernels line's entry of the pair sum's tensor route at `pair_in`
    (a wide shape), with `launches` from the phase's path: its ms from a
    replayed CUDA graph, the scalar route's kernel on the same inputs (the
    design before it, launched directly: no counter moves), the plain
    version's ms (on the first `plain_videos` videos where given, the
    whole batch's being too long to run), the bound
    (``pair_grad_tensor_bound``) and the scalar design's
    (``pair_grad_bound``) with its issue floor from the SASS, and the
    split of the tile-frames."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.tools.scan_floor import (
        built_sass,
        pair_grad_floor,
        pair_grad_issue_ms,
    )

    X, Y, trans, Z, L = pair_in
    B, T, C = X.shape
    tile = hc.pair_grad_tile(B, T, C, sms, "tensor")
    check(hc.pair_grad_tile(B, T, C, sms).route == "tensor", "{}: the pair sum at C={} is not on the tensor route".format(
        where, C))
    n = 10 if B * C * C > 2 ** 24 else N_TIMED
    ms = graph_ms(lambda: hc.hsmm_pair_grad(*pair_in), n)
    scalar_tile = hc.pair_grad_tile(B, T, C, sms, "scalar")
    L32 = L.to(torch.int32).contiguous()
    scalar_ms = graph_ms(lambda: hc._launch_pair_grad(X, Y, trans, Z, L32, scalar_tile), n)
    cut = pair_in if plain_videos is None else tuple(
        x[:plain_videos] for x in (X, Y, trans, Z, L))
    plain_ms = cuda_ms(lambda: hc._pair_grad_plain(*cut), 1, warmup=0)
    b_ms, b_by, b_kind, b_times = pair_grad_tensor_bound(pair_in, sms, clock_mhz)
    s_ms, _, s_kind, _ = pair_grad_bound(pair_in, sms, clock_mhz)
    s_sass = [v for v in pair_grad_floor(built_sass("pair_grad")).values()
              if v["design"] == "scalar"]
    check(len(s_sass) == 1, "{}: the pair library's SASS holds {} scalar kernels, not 1".format(
        where, len(s_sass)))
    s_sass = s_sass[0]
    s_floor = pair_grad_issue_ms(s_sass["instructions_per_term"], pair_terms(pair_in), clock_mhz,
                                 sms)
    split = hc.pair_grad_split(*pair_in)
    entry = {
        "name": PAIR_NAME, "route": "cuda", "source": "action_segmentation_torch/csrc/pair_grad.cu",
        "kernel": PAIR_TENSOR_KERNEL, "replaces": "action_segmentation_tpu/ops/hsmm_grad.py:246",
        "replaces_what": "XLA's fusion of _fb_bwd_packed's pair broadcast-sum (no Pallas "
                         "kernel), at C > 32",
        "launches": launches, "max_abs_err": PAIR_ERRS["tensor"], "ms": ms, "kernel_ms": ms,
        "graph_ms": ms, "scalar_route_ms": scalar_ms, "plain_ms": plain_ms,
        "plain_videos": cut[0].shape[0], "bound_ms": b_ms, "bound_by": b_by,
        "bound_limit": b_kind, "bytes_ms": b_times["bytes"],
        "fp64_tensor_ms": b_times["fp64 tensor"], "sfu_ms": b_times["sfu"],
        "scalar_bound_ms": s_ms, "scalar_bound_limit": s_kind, "scalar_route_floor_ms": s_floor,
        "library_ms": None,
        "shape": [B, T, C], "runs": tile.runs, "frames": tile.frames,
        "blocks": B * tile.tiles * tile.runs, "waves": tile.waves,
        "tile_frames": split.frames, "exact_tile_frames": split.exact,
        "exact_share": split.exact_share, "dead_tile_frames": split.dead,
    }
    phase(where, "pair grad, tensor route, at {}: {:.5f} ms (a CUDA graph of {}), bound {:.5f} ms "
          "by {} (bytes {:.5f}, fp64 tensor {:.5f}, sfu {:.5f}; {:.2f}x it); the scalar route's "
          "kernel {:.5f} ms ({:.2f}x this; its bound {:.5f} by {}, its issue floor {:.5f}); plain "
          "{:.4f} ms on {} "
          "video(s); {} runs of {} frames, {} blocks, {} waves; {} of {} tile-frames on the exact "
          "path; launches on the phase's path {}; {}".format(
              (B, T, C), ms, n, b_ms, b_kind, b_times["bytes"], b_times["fp64 tensor"],
              b_times["sfu"], ms / b_ms, scalar_ms, scalar_ms / ms, s_ms, s_kind, s_floor, plain_ms,
              cut[0].shape[0], tile.runs, tile.frames, entry["blocks"], tile.waves, split.exact,
              split.frames, launches, smi))
    return entry


def wide_long_case(device):
    """The long wide case (WIDE_LONG: B=1, T=4,096, C=136, K=20 at the
    D=300 scale) through the kernels, the wide log scan on a cluster of one
    block and K4's wide kernel on 256 chunks of 16 rows: the model's path
    (centred) and the kernels as is (uncentred) against the Function's
    PLAIN path in float64 on the CPU. The centred errors must meet
    WIDE_LONG_BOUNDS. Returns {"centred", "as is": errors, "s"}."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.ops.hsmm_grad import PLAIN

    t0 = time.perf_counter()
    p, L = d300_case(device, **WIDE_LONG)
    Cn = p.emit.shape[-1]
    inst = hc.wide_scan_instance(Cn, K - 1, 2, 2)
    check(inst.route == "cluster" and inst.cluster == 1,
          "the long wide case takes {} (cluster {}), not a cluster of one".format(
              inst.route, inst.cluster))
    got, n = counted(lambda: centred_grads(p, L))
    as_is = partition_grads(p, L)
    card = device.type == "cuda"
    check(not card or n["hsmm_log_scan_wide"] == n["hsmm_band_grad_wide"] == 1
          and all(n[k] == 0 for k in NARROW_NAMES),
          "the long wide case's launches {}".format(n))
    cpu = torch.device("cpu")
    want = partition_grads(type(p)(*(x.double().to(cpu) for x in p)), L.to(cpu), PLAIN)
    out = {"centred": float64_errors("long wide case centred", [g.to(cpu) for g in got], want,
                                     L.to(cpu)),
           "as is": float64_errors("long wide case as is", [g.to(cpu) for g in as_is], want,
                                   L.to(cpu), finite=False)}
    out["s"] = time.perf_counter() - t0
    phase("wide", "(a) long case B={} T={} C={} K={} D={} (the {} route, a cluster of {}; K4 wide "
          "on {} chunks of {} rows), the kernel path against the PLAIN path in float64: "
          "centred {}; as is {}; bounds {}; launches {}; {:.1f} s".format(
              *p.emit.shape, K, D, inst.route, inst.cluster, -(-p.emit.shape[1] // hc.BAND_CHUNK),
              hc.BAND_CHUNK, *("{" + ", ".join("{} {:g}".format(k, v) for k, v in out[w].items())
                               + "}" for w in ("centred", "as is")),
              WIDE_LONG_BOUNDS, {k: v for k, v in n.items() if v}, out["s"]))
    for name, bound in WIDE_LONG_BOUNDS.items():
        check(out["centred"][name] <= bound, "the long wide case's centred {} error {:g} is above "
              "{:g}".format(name, out["centred"][name], bound))
    return out


def labels_or_ties(name, pots, lengths, got, want, gaps=None):
    """Card labels `got` against CPU labels `want` (B, T) on the card's
    potentials: equal but at frames where float64 shows a genuine tie
    (check_labels; the spans chain's scores through the kernels against
    its plain version). Returns the tie frames; their (float64 gap,
    tolerance) pairs go to `gaps`."""
    from action_segmentation_torch.ops.hsmm_cuda import (
        hsmm_viterbi_spans,
        hsmm_viterbi_spans_plain,
    )

    _, got_scores = hsmm_viterbi_spans(pots, lengths)
    _, want_scores = hsmm_viterbi_spans_plain(pots, lengths)
    return check_labels(name, pots, lengths, got, want, got_scores, want_scores,
                        few_ties=False, gaps=gaps)


def video_pots(seg, features, device):
    """(potentials, lengths) of one (T, D) video as Segmenter's calls
    build them: padded to its length bucket, every valid class, no
    constraint, the segmenter's end row."""
    import torch

    from action_segmentation_torch.data.batching import pad_length_to_bucket
    from action_segmentation_torch.models.semimarkov import upload

    Tn = features.shape[0]
    x = np.zeros((1, pad_length_to_bucket(Tn), features.shape[1]), np.float32)
    x[0, :Tn] = features
    lengths = upload(np.array([Tn], np.int32), device)
    Cn = len(seg.valid_classes)
    with torch.no_grad():
        pots, _, _ = seg.model.module.compute_potentials(
            upload(x, device), lengths, upload(seg.valid_classes, device),
            torch.zeros((1, x.shape[1], Cn), device=device),
            upload(seg._end_rows([Tn]), device))
    return pots, lengths


def marginals_against_float64(seg, features, marg, device, uncentred=True):
    """segment_with_marginals' marginals `marg` of one video (T, C) beside
    the PLAIN path's in float64 on the Segmenter's potentials as they are
    and, with `uncentred`, the PLAIN path's in float32 on them uncentred
    (each slow at 1,577 classes: the plain log scan's combine is a Python
    loop over C): {"frames", "gap": the repaired max |sum_c marginal - 1|,
    "err_vs_fp64", "fp64_gap", "uncentred_fp32_gap", "s" (seconds)}."""
    import torch

    from action_segmentation_torch.ops.hsmm_grad import PLAIN, hsmm_frame_marginals_fast

    t0 = time.perf_counter()
    pots, lb = video_pots(seg, features, device)
    Tn = features.shape[0]
    exact = hsmm_frame_marginals_fast(type(pots)(*(x.double() for x in pots)), lb, PLAIN)
    exact = exact[0, :Tn]
    got = torch.from_numpy(marg).to(device)
    out = {"frames": Tn, "gap": float(np.abs(marg.sum(axis=1) - 1).max()),
           "err_vs_fp64": max_err(got, exact),
           "fp64_gap": float((exact.sum(-1) - 1).abs().max())}
    if uncentred:
        plain = hsmm_frame_marginals_fast(pots, lb, PLAIN)[0, :Tn]
        out["uncentred_fp32_gap"] = float((plain.sum(-1) - 1).abs().max())
    check(out["fp64_gap"] < 1e-6, "float64 marginals do not sum to 1: {}".format(out))
    out["s"] = time.perf_counter() - t0
    return out


def run_wide_slice(device, root, smi):
    """Phase 4i: a DP wider than 128 classes. (a) The wide kernels (K4's
    among them) at C = 129, 342, 664, 665 and 1,024 and Km = 1, 19 and 64 (ragged lengths
    down to 1) and at the S6 shape, each equal to its plain version. (b)
    The S6 model over all 342 classes: the S6 flags with --mix_tasks on
    phase 4c's release, a closed-form fit, pickled, served by
    Segmenter.load(pickle) with no valid_classes and no task:
    segment_many over every val video against the same Segmenter on the
    CPU (labels equal but at float64-verified ties), the wide kernels only;
    segment_with_marginals on 3 videos (labels equal to segment_many's,
    marginals against hsmm_frame_marginals_fast through PLAIN on the card,
    the marginal sums' gap from 1 reported). (c) The backward at a 160-wide
    DP: an unsupervised 2-epoch fit on the synthetic corpus, its first
    step's loss and gradients against the CPU path (autograd of the plain
    partition), falling losses, then a no-grad partition through the wide
    forward scan. (d) Each wide kernel's time at the S6 shape beside its
    plain version's and its bound; K4's wide kernel's with its lg scratch
    and its floor with the cross-tile sum, beside the narrow kernel in
    its own tile on the same inputs. Returns the e2e record and the
    kernels line's entries."""
    import torch

    from action_segmentation_torch import checkpoint
    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data.batching import iter_batches
    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel, upload
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.ops.hsmm_grad import (
        PLAIN,
        centre_emissions,
        hsmm_frame_marginals_fast,
        hsmm_partition_centred,
        hsmm_partition_fast,
    )
    from action_segmentation_torch.parallel.mesh import single_mesh
    from action_segmentation_torch.tools.scan_floor import (
        built_sass,
        max_sm_clock_mhz,
        traceback_wide_floor,
        traceback_wide_floor_ms,
        wide_first_tile_bytes,
        wide_floors,
    )

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    # (a) the kernels against their plain versions
    rng = np.random.RandomState(15)
    errs = {}
    for Cn in WIDE_CLASSES:
        for Km in WIDE_KMS:
            Tn = T_WIDE[Cn]
            rl = rng.randint(1, Tn + 1, size=B_WIDE).astype(np.int32)
            rl[0], rl[1] = Tn, 1
            case, *_ = wide_kernel_case("C={} Km={}".format(Cn, Km), *serving_pots(
                rng, B_WIDE, Tn, Cn, Km + 1, device, lengths=rl))
            for k, v in case.items():
                errs[k] = max(errs.get(k, 0.0), v)
    widest = hc.WIDE_CLUSTER_MAX_CLASSES
    check(WIDE_CLASSES[2:4] == (widest, widest + 1)
          and hc.wide_scan_instance(widest, 1).route == "cluster"
          and hc.wide_scan_instance(widest + 1, 1).route == "grid"
          and hc.wide_scan_instance(1024, 19, B_WIDE, B_WIDE).route == "grid"
          and hc.wide_scan_instance(C_S6, K - 1)[:2] == ("cluster", 3),
          "the cases do not take both routes and the S6 shape's cluster")
    routes = {}
    for Cn in WIDE_CLASSES:
        for Km in WIDE_KMS:
            inst = hc.wide_scan_instance(Cn, Km, B_WIDE, B_WIDE)
            routes["C={} Km={}".format(Cn, Km)] = "{} {}".format(
                inst.route, inst.cluster if inst.route == "cluster" else "{} blocks of {} x {}, "
                "table {}, ring {}".format(inst.blocks, inst.chains, inst.slab, inst.table,
                                           inst.ring))
    s6 = hc.wide_scan_instance(C_S6, K - 1)
    active = {scan: hc.wide_max_active_clusters(scan, C_S6, K - 1, device.index or 0)
              if device.type == "cuda" else None for scan in hc.WIDE_SCAN_INDEX}
    phase("wide", "(a) routes (route, blocks a chain or the grid: blocks of chains x classes, "
          "the table's and the ring's memory): {}; the S6 shape (C={}, Km={}): {} "
          "route, clusters of {} blocks of {} classes ({} threads, {} bytes of shared memory a "
          "block); cudaOccupancyMaxActiveClusters {} (the log scan's {} chains need {}, the max "
          "and forward scans' {})".format(routes, C_S6, K - 1, s6.route, s6.cluster, s6.slab,
                                          s6.threads, s6.smem_bytes, active, 2 * B, 2 * B, B))
    rl = rng.randint(1, T + 1, size=B).astype(np.int32)
    rl[0], rl[1] = T, 1
    s6_pots = serving_pots(rng, B, T, C_S6, K, device, lengths=rl)
    case, vit_in, tb_in, scan_in, fwd_in, grad_in = wide_kernel_case(
        "S6 shape", *s6_pots, log_cut=T_S6_LOG)
    for k, v in case.items():
        errs[k] = max(errs.get(k, 0.0), v)
    errs["pair_grad"] = max(errs["pair_grad"], wide_pair_case("wide", rng, C_S6, device))
    masked = pair_masked_cases(device)
    errs["pair_grad"] = max([errs["pair_grad"]] + [e for e, _ in masked.values()])
    long_case = wide_long_case(device)
    a_s = time.perf_counter() - t_phase

    # (b) the S6 model over all 342 classes, served by Segmenter.load
    args = crosstask_args(root, "--mix_tasks")
    with contextlib.redirect_stdout(io.StringIO()):
        splits = port_main.make_data_splits(args)
    check(list(splits) == ["all"], "--mix_tasks splits {}".format(list(splits)))
    train, _, val = splits["all"]
    model = SemiMarkovModel.from_args(args, train, device=device)
    check(model.n_classes == C_S6, "{} classes, not {}".format(model.n_classes, C_S6))
    model.fit(train, use_labels=True)
    seen = np.zeros(C_S6, bool)
    for key in train._tasks_and_video_names:
        seen[train[key]["gt_single"]] = True
    check(seen.all(), "{} of {} classes have no training frames".format(
        int((~seen).sum()), C_S6))
    pkl = os.path.join(root, "wide", "s6_mix_tasks.pkl")
    checkpoint.save_pickle(model, pkl)
    seg = Segmenter.load(pkl)
    seg_cpu = Segmenter.load(pkl, device="cpu")
    check(len(seg.valid_classes) == C_S6 and seg.model.device.type == device.type,
          "Segmenter.load: {} classes on {}".format(len(seg.valid_classes), seg.model.device))
    keys = list(val._tasks_and_video_names)
    feats = [val[key]["features"] for key in keys]
    frames = sum(f.shape[0] for f in feats)
    pots0, _ = video_pots(seg, feats[0], device)
    check(all(bool(torch.isfinite(p).all()) for p in pots0) and pots0.emit.shape[-1] == C_S6,
          "the S6 model's potentials over all 342 classes are not finite")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, n_seg = counted(lambda: seg.segment_many(feats, batch_size=args.batch_size))
    seg_s = time.perf_counter() - t0
    n_batches = -(-len(feats) // args.batch_size)
    card = device.type == "cuda"  # (a rehearsal on the CPU counts no launch)
    check(not card or n_seg["hsmm_viterbi_scan_wide"] == n_seg["hsmm_viterbi_traceback_wide"] == n_batches
          and all(n_seg[k] == 0 for k in NARROW_NAMES + (PAIR_NAME,))
          and n_seg["hsmm_band_grad_wide"] == 0,
          "segment_many launches {}: not the wide kernels once a batch".format(n_seg))
    t0 = time.perf_counter()
    want = seg_cpu.segment_many(feats, batch_size=args.batch_size)
    cpu_s = time.perf_counter() - t0
    ties, tie_gaps = 0, []
    for key, f, g, w in zip(keys, feats, got, want):
        check(g.shape == (f.shape[0],) and set(g.tolist()) <= set(range(C_S6)),
              "segment_many labels of {}".format(key))
        if not np.array_equal(g, w):  # the card's potentials, float64 on the ties
            pots, lb = video_pots(seg, f, device)
            pad = np.full((1, pots.emit.shape[1]), -1, np.int64)
            gg, ww = pad.copy(), pad.copy()
            gg[0, :f.shape[0]], ww[0, :f.shape[0]] = g, w
            ties += labels_or_ties("segment_many {}".format(key[1]), pots, lb,
                                   upload(gg, device), upload(ww, device), tie_gaps)
    phase("wide", "(b) S6 --mix_tasks closed form: {} classes, all with training frames, "
          "potentials finite; Segmenter.load(pickle) over all {}: segment_many of {} val "
          "videos ({} frames, {} batches) in {:.4f} s = {:.0f} frames/s on the card, {:.3f} s "
          "on the CPU; labels equal to the CPU's but at {} float64-verified tie frames; "
          "launches {}".format(C_S6, C_S6, len(feats), frames, n_batches, seg_s, frames / seg_s,
                               cpu_s, ties, {k: v for k, v in n_seg.items() if v}))
    phase("wide", "(b) segment_many's {} tie frames: float64 score gap (best class's max-marginal "
          "less the card label's) of each, {}; the largest {:.6g}, at most {:.4g} of its "
          "tolerance (rtol {} / atol {})".format(
              len(tie_gaps), ["{:.3g}".format(g) for g, _ in tie_gaps],
              max((g for g, _ in tie_gaps), default=0.0),
              max((g / t for g, t in tie_gaps), default=0.0), RTOL, ATOL))

    order = np.argsort([f.shape[0] for f in feats])[:3]
    gaps, marg_errs, marg_frames = [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marg_out, n_marg = counted(lambda: [seg.segment_with_marginals(feats[i]) for i in order])
    marg_s = time.perf_counter() - t0
    for i, (labels, marg) in zip(order, marg_out):
        f = feats[i]
        marg_frames += f.shape[0]
        check(np.array_equal(labels, got[i]), "segment_with_marginals labels != "
              "segment_many's for {}".format(keys[i]))
        check(marg.shape == (f.shape[0], C_S6) and np.isfinite(marg).all(),
              "segment_with_marginals marginals of {}".format(keys[i]))
        pots, lb = video_pots(seg, f, device)
        plain = hsmm_frame_marginals_fast(centre_emissions(pots, lb)[0], lb, PLAIN)
        assert_close("segment_with_marginals {} vs PLAIN".format(keys[i][1]),
                     torch.from_numpy(marg).to(device), plain[0, :f.shape[0]], GRAD_RTOL,
                     GRAD_ATOL)
        marg_errs.append(max_err(torch.from_numpy(marg).to(device), plain[0, :f.shape[0]]))
        gaps.append(float(np.abs(marg.sum(axis=1) - 1).max()))
    check(not card or n_marg["hsmm_log_scan_wide"] == n_marg["hsmm_band_grad_wide"] == 3
          and n_marg["hsmm_viterbi_scan_wide"] == n_marg["hsmm_viterbi_traceback_wide"] == 3
          and all(n_marg[k] == 0 for k in NARROW_NAMES + (PAIR_NAME,)),
          "segment_with_marginals launches {} (no pair sum: d logZ / d emit alone)".format(
              n_marg))
    phase("wide", "(b) segment_with_marginals on the 3 shortest val videos ({} frames) in "
          "{:.4f} s = {:.0f} frames/s: labels == segment_many's, marginals vs PLAIN (both "
          "centred) on the card max_abs_err {} (rtol {} / atol {}), max |sum_c marginal - 1| "
          "{} (before the wide fold {}); launches {}".format(
              marg_frames, marg_s, marg_frames / marg_s, marg_errs, GRAD_RTOL, GRAD_ATOL, gaps,
              WIDE_GAPS_BEFORE["wide"], {k: v for k, v in n_marg.items() if v}))
    marg_fp64 = marginals_against_float64(seg, feats[order[0]], marg_out[0][1], device)
    phase("wide", "(b) segment_with_marginals over {} classes on the shortest val video against "
          "the PLAIN path in float64: {}".format(C_S6, marg_fp64))

    # (c) the backward at a 160-wide DP
    fit_train = SyntheticDatasplit(seed=0, **WIDE_FIT)
    fargs = sm_args(epochs=2)
    card_step = first_step(SemiMarkovModel.from_args(fargs, fit_train, device=device),
                           fit_train, single_mesh(device))
    cpu_step = first_step(SemiMarkovModel.from_args(fargs, fit_train, device=cpu),
                          fit_train, single_mesh(cpu))
    check(abs(card_step[0] - cpu_step[0]) <= RTOL * abs(cpu_step[0]),
          "wide first step loss {} vs the CPU's {}".format(card_step[0], cpu_step[0]))
    check(card_step[1].keys() == cpu_step[1].keys(), "first step gradients' names")
    for n in cpu_step[1]:
        assert_close("wide first step grad " + n, card_step[1][n], cpu_step[1][n], GRAD_RTOL,
                     GRAD_ATOL)
    step_err = max(max_err(card_step[1][n], cpu_step[1][n]) for n in cpu_step[1])
    fit_model = SemiMarkovModel.from_args(fargs, fit_train, device=device)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, n_fit = counted(lambda: fit_model.fit(
        fit_train, use_labels=False, callback_fn=lambda e, s: losses.append(s["train_loss"])))
    fit_s = time.perf_counter() - t0
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses) and losses[1] < losses[0],
          "the wide fit's epoch losses did not fall: {}".format(losses))
    fit_batches = 2 * -(-WIDE_FIT["num_videos"] // fargs.batch_size)
    check(not card or n_fit["hsmm_log_scan_wide"] == n_fit["hsmm_band_grad_wide"]
          == n_fit[PAIR_NAME] == fit_batches and all(n_fit[k] == 0 for k in NARROW_NAMES),
          "the wide fit's launches {}: not the wide log scan, K4 and the pair sum once a "
          "batch".format(n_fit))
    # the partition without gradients: the wide forward scan
    batch = next(iter_batches(fit_train, batch_size=fargs.batch_size, batch_by_task=True,
                              shuffle=False))
    dev = fit_model._training_batch(batch)
    with torch.no_grad():
        pots, _, _ = fit_model.module.compute_potentials(dev[0], dev[1], dev[2], dev[5], dev[6])
        logZ, n_fwd = counted(lambda: hsmm_partition_centred(pots, dev[1]))
        assert_close("wide no-grad partition", logZ, hsmm_partition_centred(
            pots, dev[1], lambda p, L: hsmm_partition_fast(p, L, PLAIN)))
    check(not card or n_fwd["hsmm_forward_scan_wide"] == 1 and all(n_fwd[k] == 0 for k in NARROW_NAMES),
          "the no-grad partition's launches {}".format(n_fwd))
    fit_frames = 2 * sum(int(fit_train._samples[n]["features"].shape[0])
                         for n in fit_train._samples)
    phase("wide", "(c) unsupervised fit at a {}-wide DP (synthetic, {} videos of <= {} frames, "
          "D={}): first step loss {:.6f} vs the CPU's {:.6f} (autograd of the plain partition; "
          "rtol {}), gradients max_abs_err {:g} (rtol {} / atol {}); 2 epochs, losses {}, in "
          "{:.3f} s = {:.0f} frames/s; launches {}; no-grad partition through the wide forward "
          "scan".format(WIDE_FIT["n_classes"], WIDE_FIT["num_videos"], WIDE_FIT["max_len"],
                        WIDE_FIT["feature_dim"], card_step[0], cpu_step[0], RTOL, step_err,
                        GRAD_RTOL, GRAD_ATOL, losses, fit_s, fit_frames / fit_s,
                        {k: v for k, v in n_fit.items() if v}))
    launches = {k: n_seg[k] + n_marg[k] + n_fit[k] + n_fwd[k]
                for k in WIDE_KERNEL_NAMES + (PAIR_NAME,)}

    # (d) times at the S6 shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    Km = K - 1
    n2 = 2 * B
    vit_bytes = 4 * (B * C_S6 * C_S6 + B * C_S6 + B * Km * C_S6 + 3 * B * T * C_S6)
    vit_ops = B * T * (2 * Km * C_S6 + 2 * C_S6 * C_S6 + 3 * C_S6)

    def scan_bound(n, n_out):
        # per chain-step and class: the duration reduce (Km adds, maxes,
        # subtracts, exps and sum adds, one log, one add), the transition
        # combine (the same over C), the cum add and the W push
        ops = n * T * C_S6 * (5 * Km + 5 * C_S6 + 6)
        nbytes = 4 * (n * C_S6 * C_S6 + n * C_S6 + n * Km * C_S6 + (1 + n_out) * n * T * C_S6)
        return bound(nbytes, ops)

    per_video = (hc.hsmm_viterbi_traceback_wide(*tb_in) >= 0).sum(dim=1)
    n_segments, longest = int(per_video.sum()), int(per_video.max())
    times = {
        "hsmm_viterbi_scan_wide": (
            cuda_ms(lambda: hc.hsmm_viterbi_scan_wide(*vit_in), 10),
            cuda_ms(lambda: hc._viterbi_scan_plain(*vit_in), 1, warmup=1),
            bound(vit_bytes, vit_ops), vit_in[3].shape),
        "hsmm_viterbi_traceback_wide": (
            graph_ms(lambda: hc.hsmm_viterbi_traceback_wide(*tb_in), N_TIMED),
            cuda_ms(lambda: hc._traceback_plain(*tb_in), 1, warmup=1),
            bound(8 * B * T + 8 * n_segments + 16 * B, 4 * n_segments), tb_in[0].shape),
        "hsmm_log_scan_wide": (
            cuda_ms(lambda: hc.hsmm_log_scan_wide(*scan_in), 10),
            cuda_ms(lambda: hc._log_scan_plain(*scan_in), 1, warmup=0),
            scan_bound(n2, 2), scan_in[3].shape),
        "hsmm_forward_scan_wide": (
            cuda_ms(lambda: hc.hsmm_forward_scan_wide(*hc._forward_chains(scan_in, B)), 10),
            cuda_ms(lambda: hc._forward_scan_plain(*hc._forward_chains(scan_in, B)), 1,
                    warmup=0),
            scan_bound(B, 1), scan_in[3][:B].shape),
    }
    # the scans on the grid route at the same inputs (a finding: the rule
    # gives the cluster route here), and the floors from the SASS
    # (tools/scan_floor.py) of the route each takes
    def on_grid(symbol, inputs, outs, ints=()):
        grid = grid_launches(inputs[0], inputs[3].shape[0], C_S6, Km, device)[0]
        return lambda: hc._launch_wide_scan("grid", symbol, *inputs, outs, ints, inst=grid)

    fwd6 = hc._forward_chains(scan_in, B)
    grid_ms = {} if not card else {
        "hsmm_viterbi_scan_wide": cuda_ms(on_grid(
            "hsmm_wide_viterbi_scan", vit_in, [torch.empty_like(vit_in[3]), torch.empty(
                vit_in[3].shape, dtype=torch.int32, device=device)],
            [hc.code_radix(C_S6)]), 10, warmup=1),
        "hsmm_log_scan_wide": cuda_ms(on_grid(
            "hsmm_wide_log_scan", scan_in, [torch.empty_like(scan_in[3]),
                                            torch.empty_like(scan_in[3]),
                                            scan_in[3].new_empty((n2, hc.fold_blocks(T)))]),
            10, warmup=1),
        "hsmm_forward_scan_wide": cuda_ms(on_grid(
            "hsmm_wide_forward_scan", fwd6, [torch.empty_like(fwd6[3]),
                                             fwd6[3].new_empty((B, hc.fold_blocks(T)))]),
            10, warmup=1),
    }
    floors = wide_floors(built_sass("hsmm_scan_wide"), C_S6, Km, T, B, clock_mhz, sms) \
        if card else {}
    # W2's floor: the longest video's walk at its chain from the SASS, plus
    # its first tile's arrival
    ring = hc.wide_traceback_tile(T, C_S6)
    tb_chain = traceback_wide_floor(built_sass("hsmm_viterbi"))[0] if card else None
    tb_floor = traceback_wide_floor_ms(tb_chain, longest, wide_first_tile_bytes(T, C_S6),
                                       clock_mhz) if card else None
    floor_of = {"hsmm_viterbi_scan_wide": "viterbi", "hsmm_log_scan_wide": "log",
                "hsmm_forward_scan_wide": "forward"}
    k4 = k4_wide_times(grad_in, sms, clock_mhz, card, N_TIMED)
    times["hsmm_band_grad_wide"] = (k4["ms"], k4["plain_ms"], (k4["bound_ms"], k4["bound_by"]),
                                    grad_in[0].shape)
    wide_source = "action_segmentation_torch/csrc/hsmm_scan_wide.cu"
    sources = {"hsmm_viterbi_scan_wide": (wide_source, TPU_FILE + ":110"),
               "hsmm_viterbi_traceback_wide": ("action_segmentation_torch/csrc/hsmm_viterbi.cu",
                                               TPU_FILE + ":440"),
               "hsmm_log_scan_wide": (wide_source, TPU_FILE + ":229"),
               "hsmm_forward_scan_wide": (wide_source, TPU_FILE + ":156"),
               "hsmm_band_grad_wide": ("action_segmentation_torch/csrc/band_grad.cu",
                                       TPU_FILE + ":771")}
    err_of = {"hsmm_viterbi_scan_wide": errs["viterbi_scan"],
              "hsmm_viterbi_traceback_wide": errs["traceback"],
              "hsmm_log_scan_wide": errs["log_scan"],
              "hsmm_forward_scan_wide": errs["forward_scan"],
              "hsmm_band_grad_wide": errs["band_grad"]}
    entries = []
    for name, (ms, plain_ms, (b_ms, b_by), shape) in times.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": err_of[name], "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": list(shape), "bound_ratio": ms / b_ms,
        }
        extra = ""
        if name == "hsmm_viterbi_traceback_wide" and card:
            entry.update(floor_ms=tb_floor, floor_ratio=ms / tb_floor,
                         floor_cycles_per_segment=tb_chain, segments=n_segments,
                         segments_longest_video=longest, ring_rows=ring.rows,
                         ring_stages=ring.stages)
            extra = (", {} segments, the longest video {} ({:.5f} us a segment); floor {:.5f} "
                     "ms ({:.2f}x; {:.0f} cycles a segment); a ring of {} slots of {} rows; the "
                     "earlier kernel (b8d2282) {} ms (PERF.md, {:.2f}x this)".format(
                         n_segments, longest, 1e3 * ms / longest, tb_floor, ms / tb_floor,
                         tb_chain, ring.stages, ring.rows, W2_EARLIER_MS, W2_EARLIER_MS / ms))
        if name == "hsmm_band_grad_wide":
            entry.update({k: v for k, v in k4.items() if k not in entry})
            extra = k4_wide_line(k4) + " (on {} chunks of {} rows a video)".format(
                grad_in[0].shape[0] // B, grad_in[0].shape[1])
        if name in floor_of and card:
            fl = floors["{} {}".format(floor_of[name], s6.route)]
            entry.update(scan_route=s6.route, cluster=s6.cluster, floor_ms=fl["floor_ms"],
                         floor_ratio=ms / fl["floor_ms"], grid_route_ms=grid_ms[name])
            extra = (", {} route of {} blocks a chain, {:.4f} us a step; floor {:.5f} ms "
                     "({:.2f}x; {} instructions a step, chain {:.0f} cycles, {} warp(s) a "
                     "scheduler); the grid route {:.4f} ms ({:.2f}x the cluster route's)".format(
                         s6.route, s6.cluster, 1e3 * ms / T, fl["floor_ms"], ms / fl["floor_ms"],
                         round(fl["instructions_per_step"]), fl["chain_cycles_per_step"],
                         fl["warps_per_scheduler"], grid_ms[name], grid_ms[name] / ms))
        if name in WIDE_EARLIER_MS:
            extra += "; before the wide fold {} ms ({:.3f}x this)".format(
                WIDE_EARLIER_MS[name], WIDE_EARLIER_MS[name] / ms)
        entries.append(entry)
        phase("wide", "(d) {} at {}: {:.5f} ms{}{} (plain {:.4f} ms), bound {:.6f} ms by {} "
              "({:.0f}x), launches on the slice {}; {}".format(
                  name, tuple(shape), ms, " (a CUDA graph of {})".format(N_TIMED)
                  if "traceback" in name or "band_grad" in name else "", extra, plain_ms,
                  b_ms, b_by, ms / b_ms, launches[name], smi))
    entries.append(pair_tensor_entry(
        pair_inputs(s6_pots[0], s6_pots[1].long().clamp(min=1), hc.hsmm_log_scan_wide(*scan_in)),
        launches[PAIR_NAME], sms, clock_mhz, smi, "wide"))
    entries[-1]["masked_cases"] = {k: {"max_abs_err": e, "exact_share": x}
                                   for k, (e, x) in masked.items()}
    phase_s = time.perf_counter() - t_phase
    phase("wide", "phase 4i: {:.3f} s ((a) {:.3f} s)".format(phase_s, a_s))
    e2e = {"wide_segment_many_frames_per_s": frames / seg_s,
           "wide_marginals_vs_fp64": marg_fp64,
           "wide_segment_many_cpu_s": cpu_s, "wide_segment_many_ties": ties,
           "wide_tie_gap_max": max((g for g, _ in tie_gaps), default=0.0),
           "wide_routes": routes, "wide_max_active_clusters": active,
           "wide_marginals_frames_per_s": marg_frames / marg_s,
           "wide_marginal_sum_gap": max(gaps), "wide_fit_losses": losses,
           "wide_long_case": long_case,
           "wide_fit_frames_per_s": fit_frames / fit_s, "wide_phase_s": phase_s,
           "wide_launches": launches}
    return e2e, entries


# ----- phase 4j: a DP wider than 1,024 classes -----

# the wide kernels' cases past 1,024 classes, (C, Km) at B_WIDE videos of
# T_PAST[C] frames, ragged down to 1 (the plain log scan is a Python loop
# over C): one class past 1,024, the 1,577 of every CrossTask task, 2,048
# and 3,000 (codes at radix 4,096); the grid route's table slab and ring in
# shared memory by the rule at these 4 videos, in global memory on the
# launches beside it (``grid_launches``)
PAST_CLASSES = (1025, 1577, 2048, 3000)
PAST_KMS = (1, 64)
T_PAST = {1025: 64, 1577: 64, 2048: 48, 3000: 32}
# the primary + related model: 83 tasks x (2 x 9 steps + 1)
C_ALL = 1577
# the related tasks' training videos (they have no val videos)
CT_RELATED_TRAIN = 2
# the frames at which the plain log and forward scans are timed (a Python
# loop over C a step) beside the kernels at T
T_PLAIN_LOG = 128
ALL_TASKS_FLAGS = ("--mix_tasks", "--crosstask_training_data", "primary", "related")
# phase 4j(b): one unsupervised gradient step of a 1,577-class model at the
# serving batch (its (B, T, C, C) pair exponent would be 171 GiB), and
# segment_with_marginals over 1,577 classes on one video of 8,192 frames
# (81.5 GB of pair exponent), the val features tiled end to end
PAST_STEP = dict(b=B, t=T)
T_LONG_MARGINALS = 8192


def past_1024_step(device, smi):
    """Phase 4j(b)'s step: an unsupervised model of the synthetic corpus at
    C_ALL classes (K=20, D=300) taking forward, backward, clip and Adam on
    one batch of PAST_STEP videos already on the card; the step's ms (CUDA
    events, 2 steps after a warm one), the card's peak allocation over them,
    and the launches."""
    import torch

    from action_segmentation_torch.data.synthetic import SyntheticDatasplit
    from action_segmentation_torch.models.base import clip_grads, make_optimizer
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel

    Bn, Tn = PAST_STEP["b"], PAST_STEP["t"]
    train = SyntheticDatasplit(seed=0, num_videos=36, n_classes=C_ALL, max_len=Tn, span_k=K,
                               feature_dim=D, shift=1.0)
    model = SemiMarkovModel.from_args(sm_args(epochs=1), train, device=device)
    rng = np.random.RandomState(3)
    batch = (torch.from_numpy(rng.randn(Bn, Tn, D).astype(np.float32)).to(device),
             torch.full((Bn,), Tn, dtype=torch.int32, device=device),
             torch.arange(C_ALL, device=device), torch.arange(C_ALL, device=device),
             torch.zeros((Bn, Tn), dtype=torch.long, device=device),
             torch.zeros((Bn, Tn, C_ALL), device=device), torch.zeros((Bn, C_ALL), device=device),
             torch.ones((Bn,), device=device))
    params = list(model.module.parameters())
    optimizer, _ = make_optimizer(model.args, params)
    losses = []

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss, _ = model._loss(*batch, use_labels=False)
        loss.backward()
        clip_grads(params, model.args.max_grad_norm)
        optimizer.step()
        losses.append(loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ms, n = counted(lambda: cuda_ms(step, 2, warmup=1))
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses)
          and all(bool(torch.isfinite(p.grad).all()) for p in params if p.grad is not None),
          "the {}-class step's losses {} or its last gradients are not finite".format(
              C_ALL, losses))
    check(device.type != "cuda" or n[PAIR_NAME] == n["hsmm_log_scan_wide"]
          == n["hsmm_band_grad_wide"] == 3, "the {}-class step's launches {}: not the wide "
          "log scan, K4 and the pair sum once a step".format(C_ALL, n))
    phase("past1024", "(b) one unsupervised step of a {}-class model at B={} T={} K={} D={} "
          "(its pair exponent {:.1f} GiB): {:.3f} ms, peak allocation {:.1f} MiB, losses {}, "
          "launches {}; {}".format(C_ALL, Bn, Tn, K, D, 4 * Bn * Tn * C_ALL ** 2 / 2 ** 30, ms,
                                   peak, losses, {k: v for k, v in n.items() if v}, smi))
    return {"ms": ms, "peak_mib": peak, "B": Bn, "T": Tn, "losses": losses,
            "launches": n}


def alternating_ms(runs, n):
    """{name: [ms, ms]}: each of two callables timed by CUDA events over n
    calls in the order a, b, b, a (after one warm call each)."""
    (a, fa), (b, fb) = runs.items()
    fa(), fb()
    out = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        out[name].append(cuda_ms(fn, n, warmup=0))
    return out


def run_past_1024_slice(device, root, smi):
    """Phase 4j: a DP wider than 1,024 classes. (a) The wide kernels (W1's
    three instances on the grid route; W2 at radix 2,048 and 4,096; K4's
    wide kernel) at
    C = 1,025, 1,577, 2,048 and 3,000 and Km = 1 and 64, ragged
    lengths down to 1, each equal to its plain version. (b) The S6 flags
    with --mix_tasks --crosstask_training_data primary related on a
    release of the 18 primary and 65 related tasks written under `root`:
    main.main fits the 1,577-class model in closed form, decodes val
    (each video within its task's classes) and pickles it; Segmenter.load(pickle) with no valid_classes:
    segment_many over every val video against the same Segmenter's plain
    chain on the card and, on the 3 shortest, against the CPU Segmenter
    (labels equal but at float64-verified ties), through the wide kernels
    only; segment_with_marginals on the 3 shortest (labels, shape and the
    marginal sums' gap), the shortest against the PLAIN Function on the
    card. (c) At B=18, T=1024, C=1,577, K=20 each wide
    kernel's time (K4's wide kernel's among them, with its lg scratch and
    its floor with the cross-tile sum, beside the narrow kernel in its own
    tile) beside its plain version's, its bound and its floor from the
    SASS; the max and forward scans with the chains'
    shared (expanded) table and with a table copied a chain, bit-equal,
    in turn. Returns the e2e record and, by kernel name, the entries the
    kernels line adds to each wide kernel's."""
    import torch
    from unittest import mock

    from action_segmentation_torch import main as port_main
    from action_segmentation_torch.api import Segmenter
    from action_segmentation_torch.data import minigen
    from action_segmentation_torch.data.crosstask import CrosstaskCorpus
    from action_segmentation_torch.models import semimarkov
    from action_segmentation_torch.models.semimarkov import SemiMarkovModel, upload
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.ops.hsmm import _durations, _finals
    from action_segmentation_torch.ops.hsmm_grad import (
        PLAIN,
        centre_emissions,
        hsmm_frame_marginals_fast,
    )
    from action_segmentation_torch.tools.scan_floor import (
        built_sass,
        max_sm_clock_mhz,
        traceback_wide_floor,
        traceback_wide_floor_ms,
        wide_first_tile_bytes,
        wide_floors,
    )

    t_phase = time.perf_counter()
    card = device.type == "cuda"
    path_names = WIDE_KERNEL_NAMES

    # (a) the kernels against their plain versions past 1,024 classes
    rng = np.random.RandomState(18)
    errs, layouts = {}, {}
    for Cn in PAST_CLASSES:
        for Km in PAST_KMS:
            Tn = T_PAST[Cn]
            rl = rng.randint(1, Tn + 1, size=B_WIDE).astype(np.int32)
            rl[0], rl[1] = Tn, 1
            inputs = serving_pots(rng, B_WIDE, Tn, Cn, Km + 1, device, lengths=rl)
            (case, *_), n = counted(lambda: wide_kernel_case(
                "C={} Km={}".format(Cn, Km), *inputs))
            check(not card or all(n[k] > 0 for k in path_names),
                  "C={} Km={}: launches {}".format(Cn, Km, n))
            for k, v in case.items():
                errs[k] = max(errs.get(k, 0.0), v)
            inst = hc.wide_scan_instance(Cn, Km, 2 * B_WIDE, B_WIDE)  # the log scan's
            k4_tile = hc.band_grad_wide_tile(B_WIDE, Tn, Cn, Km)
            layouts["C={} Km={}".format(Cn, Km)] = (
                "the log scan's {} blocks of {} chains x {} classes ({} threads), table {}, "
                "ring {}; radix {}, K4 {} runs of {} rows a video".format(
                    inst.blocks, inst.chains, inst.slab, inst.threads, inst.table, inst.ring,
                    hc.code_radix(Cn), k4_tile.tiles, k4_tile.rows))
    check(not card or all(hc.wide_scan_instance(Cn, Km).route == "grid" for Cn in PAST_CLASSES
              for Km in PAST_KMS) and hc.code_radix(3000) == 4096,
          "the cases do not take the grid route and radix 4,096")
    errs["pair_grad"] = max(errs["pair_grad"], wide_pair_case("past1024", rng, C_ALL, device))
    phase("past1024", "(a) layouts: {}".format(layouts))
    a_s = time.perf_counter() - t_phase

    # (b) the primary + related model over all 1,577 classes
    root2 = os.path.join(root, "all_tasks")
    steps = ["step{}".format(i) for i in range(CT_STEPS)]
    t0 = time.perf_counter()
    minigen.write_mini_crosstask(
        root2, np.random.RandomState(18),
        tasks={t: steps for t in CrosstaskCorpus.TASK_IDS_BY_SET["primary"]},
        related_tasks={t: steps for t in CrosstaskCorpus.TASK_IDS_BY_SET["related"]},
        n_train=CT_TRAIN, n_val=CT_VAL, dim_per_group=CT_DIM_PER_GROUP,
        related_counts=(CT_RELATED_TRAIN, 0), **CT_RANGES)
    write_s = time.perf_counter() - t0
    args = crosstask_args(root2, *ALL_TASKS_FLAGS)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        splits = port_main.make_data_splits(args)
    load_s = time.perf_counter() - t0
    check(list(splits) == ["all"], "--mix_tasks splits {}".format(list(splits)))
    train, _, val = splits["all"]
    n_tasks = len({task for task, _ in train._tasks_and_video_names})
    check(n_tasks == 83, "the training split holds {} tasks, not 83".format(n_tasks))
    seen = np.zeros(C_ALL, bool)
    for key in train._tasks_and_video_names:
        seen[train[key]["gt_single"]] = True
    check(seen.all(), "{} of {} classes have no training frames".format(
        int((~seen).sum()), C_ALL))
    keys = list(val._tasks_and_video_names)
    check(len(keys) == 18 * CT_VAL, "{} val videos".format(len(keys)))
    feats = [val[key]["features"] for key in keys]
    frames = sum(f.shape[0] for f in feats)

    # main.main: the closed-form fit, val decoded (each video within its
    # task's classes, so through the narrow spans kernels), the model pickled
    models_dir = os.path.join(root2, "models")
    argv = ["--classifier", "semimarkov", "--training", "supervised", *S6_FLAGS,
            "--data_root", root2, "--pca_components_per_group", str(CT_DIM_PER_GROUP),
            *ALL_TASKS_FLAGS, "--model_output_path", models_dir]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cli_recorder(port_main, SemiMarkovModel), \
            contextlib.redirect_stdout(io.StringIO()):
        stats, n_cli = counted(lambda: port_main.main(argv))
    cli_s = time.perf_counter() - t0
    n_batches = -(-len(feats) // args.batch_size)
    per_task = {}
    for task, _ in keys:
        per_task[task] = per_task.get(task, 0) + 1
    task_batches = sum(-(-n // args.batch_size) for n in per_task.values())
    check(not card or n_cli["hsmm_viterbi_scan"] == n_cli["hsmm_viterbi_traceback"]
          == task_batches and all(n_cli[k] == 0 for k in path_names),
          "main.main's launches {}: not the narrow spans kernels once a task's val batch "
          "({})".format(n_cli, task_batches))
    check(list(stats) == ["all"], "main.main's splits {}".format(list(stats)))
    mof = (sum(float(s["mof"][0]) for s in stats["all"].values())
           / sum(float(s["mof"][1]) for s in stats["all"].values()))
    check(0 <= mof <= 1, "main.main's val MoF {}".format(mof))
    pkl = os.path.join(models_dir, "all.pkl")
    seg = Segmenter.load(pkl)
    seg_cpu = Segmenter.load(pkl, device="cpu")
    check(len(seg.valid_classes) == C_ALL and seg.model.n_classes == C_ALL
          and seg.model.device.type == device.type,
          "Segmenter.load: {} classes on {}".format(len(seg.valid_classes), seg.model.device))
    pots0, _ = video_pots(seg, feats[0], device)
    check(all(bool(torch.isfinite(p).all()) for p in pots0) and pots0.emit.shape[-1] == C_ALL,
          "the model's potentials over all {} classes are not finite".format(C_ALL))
    phase("past1024", "(b) release of 18 primary and 65 related tasks ({} training, {} val "
          "videos) written in {:.3f} s, loaded in {:.3f} s; main.main {} closed form: {} "
          "classes, all with training "
          "frames, MoF {:.4f} on {} val videos (each within its task's classes) in {:.3f} s, "
          "launches {}; pickle loaded on the card and the CPU".format(
              len(train._tasks_and_video_names), len(keys), write_s, load_s,
              " ".join(ALL_TASKS_FLAGS),
              C_ALL, mof, len(keys), cli_s, {k: v for k, v in n_cli.items() if v}))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, n_seg = counted(lambda: seg.segment_many(feats, batch_size=args.batch_size))
    seg_s = time.perf_counter() - t0
    check(not card or n_seg["hsmm_viterbi_scan_wide"] == n_seg["hsmm_viterbi_traceback_wide"]
          == n_batches and all(n_seg[k] == 0 for k in NARROW_NAMES + (PAIR_NAME,))
          and n_seg["hsmm_band_grad_wide"] == 0,
          "segment_many launches {}: not the wide kernels once a batch".format(n_seg))
    # the same Segmenter's plain chain on the card
    with mock.patch.object(semimarkov, "hsmm_viterbi_spans", hc.hsmm_viterbi_spans_plain):
        t0 = time.perf_counter()
        want, n_plain = counted(lambda: seg.segment_many(feats, batch_size=args.batch_size))
        plain_s = time.perf_counter() - t0
    check(all(v == 0 for v in n_plain.values()), "the plain chain launched {}".format(n_plain))
    ties, tie_gaps = 0, []

    def compare(what, g, w, f, key):
        check(g.shape == (f.shape[0],) and set(g.tolist()) <= set(range(C_ALL)),
              "{} labels of {}".format(what, key))
        if np.array_equal(g, w):
            return 0
        pots, lb = video_pots(seg, f, device)  # the card's potentials, float64 on the ties
        pad = np.full((1, pots.emit.shape[1]), -1, np.int64)
        gg, ww = pad.copy(), pad.copy()
        gg[0, :f.shape[0]], ww[0, :f.shape[0]] = g, w
        return labels_or_ties("{} {}".format(what, key[1]), pots, lb, upload(gg, device),
                              upload(ww, device), tie_gaps)

    for key, f, g, w in zip(keys, feats, got, want):
        ties += compare("segment_many vs the plain chain", g, w, f, key)
    order = np.argsort([f.shape[0] for f in feats])[:3]
    t0 = time.perf_counter()
    on_cpu = seg_cpu.segment_many([feats[i] for i in order], batch_size=args.batch_size)
    cpu_s = time.perf_counter() - t0
    cpu_ties = 0
    for i, w in zip(order, on_cpu):
        cpu_ties += compare("segment_many vs the CPU", got[i], w, feats[i], keys[i])
    phase("past1024", "(b) Segmenter.load(pickle) over all {}: segment_many of {} val videos "
          "({} frames, {} batches) in {:.4f} s = {:.0f} frames/s on the card; labels equal to "
          "the same Segmenter's plain chain on the card ({:.3f} s) but at {} and to the CPU "
          "Segmenter's on the 3 shortest ({:.3f} s) but at {} float64-verified tie frames "
          "(gaps {}); launches {}".format(
              C_ALL, len(feats), frames, n_batches, seg_s, frames / seg_s, plain_s, ties,
              cpu_s, cpu_ties, ["{:.3g}".format(g) for g, _ in tie_gaps],
              {k: v for k, v in n_seg.items() if v}))

    marg_errs, gaps, marg_frames = [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marg_out, n_marg = counted(lambda: [seg.segment_with_marginals(feats[i]) for i in order])
    marg_s = time.perf_counter() - t0
    for i, (labels, marg) in zip(order, marg_out):
        f = feats[i]
        marg_frames += f.shape[0]
        check(np.array_equal(labels, got[i]), "segment_with_marginals labels != "
              "segment_many's for {}".format(keys[i]))
        check(marg.shape == (f.shape[0], C_ALL) and np.isfinite(marg).all(),
              "segment_with_marginals marginals of {}".format(keys[i]))
        gaps.append(float(np.abs(marg.sum(axis=1) - 1).max()))
        if i != order[0]:
            continue
        # on the Segmenter's own potentials, centred as it centres them; the
        # shortest video alone (the plain log scan's Python loop over 1,577
        # classes takes about 20 s a video)
        pots, lb = video_pots(seg, f, device)
        plain = hsmm_frame_marginals_fast(centre_emissions(pots, lb)[0], lb, PLAIN)
        assert_close("segment_with_marginals {} vs PLAIN".format(keys[i][1]),
                     torch.from_numpy(marg).to(device), plain[0, :f.shape[0]], GRAD_RTOL,
                     GRAD_ATOL)
        marg_errs.append(max_err(torch.from_numpy(marg).to(device), plain[0, :f.shape[0]]))
    check(not card or n_marg["hsmm_log_scan_wide"] == n_marg["hsmm_band_grad_wide"] == 3
          and n_marg["hsmm_viterbi_scan_wide"] == n_marg["hsmm_viterbi_traceback_wide"] == 3
          and all(n_marg[k] == 0 for k in NARROW_NAMES + (PAIR_NAME,)),
          "segment_with_marginals launches {} (no pair sum: d logZ / d emit alone)".format(
              n_marg))
    phase("past1024", "(b) segment_with_marginals on the 3 shortest val videos ({} frames) in "
          "{:.4f} s = {:.0f} frames/s: labels == segment_many's, marginals vs PLAIN (both "
          "centred) on the card, the shortest video, max_abs_err {} (rtol {} / atol {}), max "
          "|sum_c marginal - 1| "
          "{} (before the wide fold {}); launches {}".format(
              marg_frames, marg_s, marg_frames / marg_s, marg_errs, GRAD_RTOL, GRAD_ATOL, gaps,
              WIDE_GAPS_BEFORE["past1024"], {k: v for k, v in n_marg.items() if v}))
    marg_fp64 = marginals_against_float64(seg, feats[order[0]], marg_out[0][1], device,
                                          uncentred=False)
    phase("past1024", "(b) segment_with_marginals over {} classes on the shortest val video "
          "against the PLAIN path in float64: {}".format(C_ALL, marg_fp64))
    # one video of 8,192 frames, the val features tiled end to end
    long_feats = np.concatenate(feats * -(-T_LONG_MARGINALS // frames))[:T_LONG_MARGINALS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    (long_labels, long_marg), n_long = counted(lambda: seg.segment_with_marginals(long_feats))
    long_s = time.perf_counter() - t0
    long_peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    long_want = seg.segment_many([long_feats])[0]
    long_gap = float(np.abs(long_marg.sum(axis=1) - 1).max())
    check(np.array_equal(long_labels, long_want), "segment_with_marginals labels of the {}-frame "
          "video != segment_many's".format(T_LONG_MARGINALS))
    check(long_marg.shape == (T_LONG_MARGINALS, C_ALL) and np.isfinite(long_marg).all()
          and long_gap <= CENTRED_BOUNDS["T=12000"]["gap"],
          "segment_with_marginals of the {}-frame video: shape {}, max |sum_c marginal - 1| "
          "{} (bound {})".format(T_LONG_MARGINALS, long_marg.shape, long_gap,
                                 CENTRED_BOUNDS["T=12000"]["gap"]))
    check(not card or n_long["hsmm_log_scan_wide"] == n_long["hsmm_band_grad_wide"] == 1
          and n_long[PAIR_NAME] == 0, "the {}-frame marginals' launches {}".format(
              T_LONG_MARGINALS, n_long))
    phase("past1024", "(b) segment_with_marginals over {} classes on one video of {} frames (the "
          "val features tiled; its pair exponent would take {:.1f} GB): {:.3f} s, labels == "
          "segment_many's, max |sum_c marginal - 1| {:g} (bound {}), peak allocation {:.1f} "
          "MiB, launches {}".format(C_ALL, T_LONG_MARGINALS, 4 * T_LONG_MARGINALS * C_ALL ** 2
                                    / 1e9, long_s, long_gap, CENTRED_BOUNDS["T=12000"]["gap"],
                                    long_peak, {k: v for k, v in n_long.items() if v}))
    step = past_1024_step(device, smi)
    launches = {k: n_seg[k] + n_marg[k] + n_long[k] + step["launches"][k]
                for k in path_names + (PAIR_NAME,)}
    for k in ("hsmm_viterbi_scan_wide", "hsmm_viterbi_traceback_wide", "hsmm_log_scan_wide",
              "hsmm_band_grad_wide", PAIR_NAME):
        check(not card or launches[k] > 0, "{} was not launched on phase 4j's path".format(k))
    b_s = time.perf_counter() - t_phase - a_s

    # (c) times at B=18, T=1024, C=1,577, K=20
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    Km = K - 1
    rl = rng.randint(1, T + 1, size=B).astype(np.int32)
    rl[0], rl[1] = T, 1
    pots, L = serving_pots(rng, B, T, C_ALL, K, device, lengths=rl)
    L = L.long()
    dur = _durations(pots.lens).contiguous()
    shared_in = (pots.trans, pots.init.contiguous(), dur, pots.emit)  # one expanded table
    copied_in = (pots.trans.contiguous(), *shared_in[1:])  # a table a chain
    vit_s, vit_c = hc.hsmm_viterbi_scan_wide(*shared_in), hc.hsmm_viterbi_scan_wide(*copied_in)
    fwd_s, fwd_c = (hc.hsmm_forward_scan_wide(*shared_in),
                    hc.hsmm_forward_scan_wide(*copied_in))
    vit_p = hc._viterbi_scan_plain(*copied_in)
    torch.cuda.synchronize()
    for what, a, b in (("alphas", vit_s[0], vit_c[0]), ("codes", vit_s[1], vit_c[1]),
                       ("forward alphas", fwd_s[0], fwd_c[0]),
                       ("forward offsets", fwd_s[1], fwd_c[1])):
        check_equal("shared table vs a table a chain: " + what, a, b)
    check_equal("C={} viterbi scan alphas".format(C_ALL), vit_s[0], vit_p[0])
    check_equal("C={} viterbi scan codes".format(C_ALL), vit_s[1], vit_p[1])
    vit_ab = alternating_ms({"shared": lambda: hc.hsmm_viterbi_scan_wide(*shared_in),
                             "copied": lambda: hc.hsmm_viterbi_scan_wide(*copied_in)}, 2)
    fwd_ab = alternating_ms({"shared": lambda: hc.hsmm_forward_scan_wide(*shared_in),
                             "copied": lambda: hc.hsmm_forward_scan_wide(*copied_in)}, 2)
    tb_in = (vit_s[1], L, _finals(vit_s[0], L, pots.end_mask).argmax(dim=-1))
    spans = hc.hsmm_viterbi_traceback_wide(*tb_in)
    check_equal("C={} traceback spans".format(C_ALL), spans, hc._traceback_plain(*tb_in))
    per_video = (spans >= 0).sum(dim=1)
    n_segments, longest = int(per_video.sum()), int(per_video.max())
    scan_in = hc._stack_fwd_rev(pots, L)  # the two tables, each read by B chains
    scan_copied = (hc._dense_trans(scan_in[0]).contiguous(), *scan_in[1:])  # a table a chain
    log_k = hc.hsmm_log_scan_wide(*scan_in)
    log_c = hc.hsmm_log_scan_wide(*scan_copied)
    cut = (*scan_in[:3], scan_in[3][:, :T_PLAIN_LOG].contiguous())
    cut_k = hc.hsmm_log_scan_wide(*cut)
    held = []  # the plain log scan's one run, timed: (c)'s plain time below
    plain_log_ms = cuda_ms(lambda: held.append(hc._log_scan_plain(*cut)), 1, warmup=0)
    cut_p = held[0]
    fwd_cut = hc._forward_chains(cut, B)
    fwd_cut_k = hc.hsmm_forward_scan_wide(*fwd_cut)
    torch.cuda.synchronize()
    for what, a, b in zip(("gamma", "alphas", "offsets"), log_k, log_c):
        check_equal("two shared tables vs a table a chain: log " + what, a, b)
    del log_c
    log_ab = alternating_ms({"shared": lambda: hc.hsmm_log_scan_wide(*scan_in),
                             "copied": lambda: hc.hsmm_log_scan_wide(*scan_copied)}, 1)
    for what, k, p in zip(("gamma", "alphas", "offsets"), cut_k, cut_p):
        check_equal("C={} log scan {} (first {} frames, two shared tables)".format(
            C_ALL, what, T_PLAIN_LOG), k, p)
    for what, k, p in zip(("alphas", "offsets"), fwd_cut_k, (cut_p[1][:B], cut_p[2][:B])):
        check_equal("C={} forward scan {} (first {} frames, one shared table)".format(
            C_ALL, what, T_PLAIN_LOG), k, p)
    cut_fired = class_folds(cut[3])
    phase("past1024", "(c) the log scan ({} chains, two shared tables) and the forward scan "
          "({} chains, one) at C={} on the grid route equal to their plain versions on the first "
          "{} frames, offsets included (the chains' folds {}, the classes' own {} of {} "
          "(chain, step, class))".format(2 * B, B, C_ALL, T_PLAIN_LOG,
                                         int((cut_p[2][:, 1:] != 0).sum()), cut_fired,
                                         cut[3].numel()))
    grad_in = grad_inputs(pots, L, *log_k)
    bg_k, bg_p = hc.hsmm_band_grad(*grad_in), hc._band_grad_plain(*grad_in)
    torch.cuda.synchronize()
    check_band_grad("C={} band grad".format(C_ALL), bg_k, bg_p)

    def scan_bound(n, n_out):
        # per chain-step and class: the duration reduce (Km adds, maxes,
        # subtracts, exps and sum adds, one log, one add), the transition
        # combine (the same over C), the cum add and the W push; the table
        # read once a chain
        ops = n * T * C_ALL * (5 * Km + 5 * C_ALL + 6)
        nbytes = 4 * (n * C_ALL * C_ALL + n * C_ALL + n * Km * C_ALL + (1 + n_out) * n * T * C_ALL)
        return bound(nbytes, ops)

    vit_bytes = 4 * (B * C_ALL * C_ALL + B * C_ALL + B * Km * C_ALL + 3 * B * T * C_ALL)
    vit_ops = B * T * (2 * Km * C_ALL + 2 * C_ALL * C_ALL + 3 * C_ALL)
    # the grid each scan takes, and its barrier alone (the empty-step probe)
    grids = {"viterbi": hc.wide_scan_instance(C_ALL, Km, B, B, sms),
             "log": hc.wide_scan_instance(C_ALL, Km, 2 * B, B, sms),
             "forward": hc.wide_scan_instance(C_ALL, Km, B, B, sms)}
    barrier_us = {scan: grid_barrier_us(device, g.blocks, g.threads) if card else 0.0
                  for scan, g in grids.items()}
    phase("past1024", "(c) the grids: {}; the grid barrier alone {} us a step".format(
        {scan: "{} blocks of {} chains x {} classes ({} threads, {} bytes of shared memory), "
         "table slab in {} memory, ring in {} memory".format(
             g.blocks, g.chains, g.slab, g.threads, g.smem_bytes, g.table, g.ring)
         for scan, g in grids.items()}, {k: round(v, 4) for k, v in barrier_us.items()}))
    floors = {}
    if card:
        sass = built_sass("hsmm_scan_wide")
        for scan in grids:
            floors.update({k: v for k, v in wide_floors(
                sass, C_ALL, Km, T, B, clock_mhz, sms, barrier_us=barrier_us[scan]).items()
                if k.startswith(scan)})
    tb_chain = traceback_wide_floor(built_sass("hsmm_viterbi"))[0] if card else None
    tb_floor = traceback_wide_floor_ms(tb_chain, longest, wide_first_tile_bytes(T, C_ALL),
                                       clock_mhz) if card else None
    k4 = k4_wide_times(grad_in, sms, clock_mhz, card, 10)
    times = {
        "hsmm_viterbi_scan_wide": (
            min(vit_ab["shared"]), cuda_ms(lambda: hc._viterbi_scan_plain(*copied_in), 1,
                                           warmup=0), T,
            bound(vit_bytes, vit_ops), floors.get("viterbi grid", {}).get("floor_ms"),
            tuple(copied_in[3].shape)),
        "hsmm_viterbi_traceback_wide": (
            graph_ms(lambda: hc.hsmm_viterbi_traceback_wide(*tb_in), 20),
            cuda_ms(lambda: hc._traceback_plain(*tb_in), 1, warmup=1), T,
            bound(8 * B * T + 8 * n_segments + 16 * B, 4 * n_segments), tb_floor,
            tuple(tb_in[0].shape)),
        "hsmm_log_scan_wide": (
            min(log_ab["shared"]), plain_log_ms, T_PLAIN_LOG, scan_bound(2 * B, 2),
            floors.get("log grid", {}).get("floor_ms"),
            tuple(scan_in[3].shape)),
        "hsmm_forward_scan_wide": (
            min(fwd_ab["shared"]), cuda_ms(lambda: hc._forward_scan_plain(*fwd_cut), 1,
                                           warmup=0), T_PLAIN_LOG,
            scan_bound(B, 1), floors.get("forward grid", {}).get("floor_ms"),
            tuple(copied_in[3].shape)),
        "hsmm_band_grad_wide": (
            k4["ms"], k4["plain_ms"], T, (k4["bound_ms"], k4["bound_by"]), k4["floor_ms"],
            tuple(grad_in[0].shape)),
    }
    err_of = {"hsmm_viterbi_scan_wide": errs["viterbi_scan"], "hsmm_viterbi_traceback_wide": 0.0,
              "hsmm_log_scan_wide": errs["log_scan"],
              "hsmm_forward_scan_wide": errs["forward_scan"],
              "hsmm_band_grad_wide": errs["band_grad"]}
    entries = {}
    for name, (ms, plain_ms, plain_t, (b_ms, b_by), floor_ms, shape) in times.items():
        entries[name] = {
            "past_1024_launches": launches[name], "past_1024_max_abs_err": err_of[name],
            "past_1024_ms": ms, "past_1024_plain_ms": plain_ms, "past_1024_plain_T": plain_t,
            "past_1024_bound_ms": b_ms, "past_1024_bound_by": b_by,
            "past_1024_floor_ms": floor_ms, "past_1024_shape": list(shape)}
        extra = ""
        scan = {"hsmm_viterbi_scan_wide": "viterbi", "hsmm_log_scan_wide": "log",
                "hsmm_forward_scan_wide": "forward"}.get(name)
        if scan is not None:
            ab = {"viterbi": vit_ab, "log": log_ab, "forward": fwd_ab}[scan]
            g = grids[scan]
            entries[name].update(
                past_1024_shared_table_ms=ab["shared"], past_1024_table_a_chain_ms=ab["copied"],
                past_1024_route=g.route, past_1024_blocks=g.blocks,
                past_1024_chains_per_block=g.chains, past_1024_slab=g.slab,
                past_1024_threads=g.threads, past_1024_table=g.table,
                past_1024_barrier_us=barrier_us[scan])
            extra = ("; {} route, {} blocks of {} chains x {} classes, table slab in {} memory; "
                     "{} shared table(s) {} ms, a table a chain {} ms (turns a, b, b, a); the "
                     "barrier alone {:.4f} us a step".format(
                         g.route, g.blocks, g.chains, g.slab, g.table,
                         "two" if scan == "log" else "one",
                         ["{:.4f}".format(x) for x in ab["shared"]],
                         ["{:.4f}".format(x) for x in ab["copied"]], barrier_us[scan]))
        if name == "hsmm_viterbi_traceback_wide":
            extra = "; {} segments, the longest video {}".format(n_segments, longest)
        if name == "hsmm_band_grad_wide":
            entries[name].update({"past_1024_" + k: v for k, v in k4.items()
                                  if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "floor_ms")})
            extra = k4_wide_line(k4) + " (on {} chunks of {} rows a video)".format(
                grad_in[0].shape[0] // B, grad_in[0].shape[1])
        if name in PAST_EARLIER_MS:
            extra += "; before the wide fold {} ms ({:.3f}x this)".format(
                PAST_EARLIER_MS[name], PAST_EARLIER_MS[name] / ms)
        phase("past1024", "(c) {} at {}: {:.5f} ms, {:.4f} us a step, plain {:.4f} ms (at {} "
              "frames), bound {:.6f} ms by {} ({:.0f}x), floor {}, launches on the phase's "
              "path {}{}; {}".format(
                  name, shape, ms, 1e3 * ms / T, plain_ms, plain_t, b_ms, b_by, ms / b_ms,
                  "{:.5f} ms".format(floor_ms) if floor_ms is not None else "not measured",
                  launches[name], extra, smi))
    pair = pair_tensor_entry(pair_inputs(pots, L, log_k), launches[PAIR_NAME], sms, clock_mhz,
                             smi, "past1024", plain_videos=2)
    entries[PAIR_NAME] = {"past_1024_" + k: v for k, v in pair.items()
                          if k not in ("name", "route", "source", "kernel", "replaces")}
    phase_s = time.perf_counter() - t_phase
    phase("past1024", "phase 4j: {:.3f} s ((a) {:.3f} s, (b) {:.3f} s)".format(phase_s, a_s, b_s))
    e2e = {"past_1024_segment_many_frames_per_s": frames / seg_s,
           "past_1024_marginals_vs_fp64": marg_fp64,
           "past_1024_segment_many_s": seg_s, "past_1024_plain_chain_s": plain_s,
           "past_1024_ties": ties, "past_1024_cpu_ties": cpu_ties,
           "past_1024_tie_gap_max": max((g for g, _ in tie_gaps), default=0.0),
           "past_1024_cli_s": cli_s, "past_1024_mof": mof, "past_1024_write_s": write_s,
           "past_1024_marginals_frames_per_s": marg_frames / marg_s,
           "past_1024_marginal_sum_gap": max(gaps), "past_1024_marginal_err": max(marg_errs),
           "past_1024_layouts": layouts, "past_1024_phase_s": phase_s,
           "past_1024_launches": launches,
           "past_1024_long_marginals": {"T": T_LONG_MARGINALS, "s": long_s, "gap": long_gap,
                                        "peak_mib": long_peak},
           "past_1024_step": {k: v for k, v in step.items() if k != "launches"}}
    return e2e, entries


def grid_barrier_us(device, blocks, threads, T=1024):
    """us a step of T grid barriers alone (csrc/hsmm_scan_wide.cu's
    empty-step probe) in a cooperative grid of `blocks` blocks of `threads`
    threads, the least of 3 launches."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc

    counter = torch.zeros(1, dtype=torch.int32, device=device)

    def probe():
        err = hc._call("hsmm_scan_wide", "hsmm_wide_grid_barrier", [counter], [blocks, threads, T],
                       counter)
        check(err == 0, "the grid barrier probe failed with CUDA error {}".format(err))

    return min(cuda_ms(probe, 1, warmup=int(k == 0)) for k in range(3)) * 1e3 / T


def cuda_ms(fn, n, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n):
    """Device ms of one call of fn: a CUDA graph of n calls, replayed, so
    that no host time falls between the launches (a kernel shorter than
    the host's time to launch it reads that time under cuda_ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# the scan template's semirings (csrc/hsmm_scan_core.cuh), in its enum's order
SCAN_SEMIRINGS = ("max", "log", "argmax")


def scan_kernel_name(semiring, warps, row, tail):
    return "scan_kernel<{}, {} warps, row {}, tail {}>".format(semiring, warps, row, tail)


# the band max's instances (csrc/band_max.cu): one pass, or several slabs
BAND_MAX_KERNELS = ("band_max_kernel<one slab>", "band_max_kernel<slabs>")
# the wide scan's instances (csrc/hsmm_scan_wide.cu, in its enum's order),
# the grid barrier's probe and the traceback's wide instance
# (csrc/hsmm_viterbi.cu)
WIDE_SCANS = ("viterbi", "log", "forward")
WIDE_KERNELS = tuple("wide_cluster_scan_kernel<{}, {}>".format(s, b) for s in WIDE_SCANS
                     for b in ("one block", "cluster")) + tuple(
    "wide_grid_scan_kernel<{}, table {}>".format(s, m) for s in WIDE_SCANS
    for m in ("global", "shared")) + ("grid_barrier_probe", "traceback_wide_kernel")


def kernel_name(mangled):
    """A readable name for an entry function's mangled name: the scan
    template's instances as scan_kernel<semiring, warps, row, tail>, the
    band max's as band_max_kernel<one slab> or <slabs>, the wide scans' as
    wide_cluster_scan_kernel<viterbi, one block> (the cluster route: the
    scan, log or forward; one block a chain, or a cluster of more) and
    wide_grid_scan_kernel<viterbi, table shared> (the grid route: the
    table slab in shared or global memory)."""
    m = re.search(r"scan_kernelILNS_8SemiringE(\d)ELi(\d)ELi(\d+)ELb([01])E", mangled)
    if m:
        return scan_kernel_name(SCAN_SEMIRINGS[int(m.group(1))], *m.group(2, 3, 4))
    m = re.search(r"band_max_kernelILb([01])E", mangled)
    if m:
        return BAND_MAX_KERNELS[int(m.group(1))]
    m = re.search(r"wide_cluster_scan_kernelILNS_\d+ScanE(\d)ELb([01])E", mangled)
    if m:
        return "wide_cluster_scan_kernel<{}, {}>".format(
            WIDE_SCANS[int(m.group(1))], ("one block", "cluster")[int(m.group(2))])
    m = re.search(r"wide_grid_scan_kernelILNS_\d+ScanE(\d)ELb([01])E", mangled)
    if m:
        return "wide_grid_scan_kernel<{}, table {}>".format(
            WIDE_SCANS[int(m.group(1))], ("global", "shared")[int(m.group(2))])
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        ident = m.group(2)[:int(m.group(1))]
        if ident.endswith("_kernel") or ident.endswith("_probe"):
            return ident
    return mangled


def ptxas_entries(log):
    """(kernel, registers, spill line) for each entry function in an
    `nvcc -Xptxas -v` log."""
    entries, fn, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif "spill stores" in line:
            spills = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                entries.append((fn, int(m.group(1)), spills))
                fn = None
    return entries


def numbers(x):
    """Every number in a kernels entry, through its lists and dicts."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, list):
        for v in x:
            yield from numbers(v)
    elif not isinstance(x, str) and x is not None:
        yield x


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def band_grad_bound(grad_in, sms, clock_mhz):
    """The band gradient's bound in ms, "bytes" or "operations", and which
    limit sets it ("bytes", "fp32" or "sfu") with the three times. In:
    G1m, G2p, dur; out: qg, sa, st, lg. A (t, c, r) term takes 12 fp32
    operations (x add, logaddexp 6, M add and exp, the sa, st and lg
    adds) and 3 transcendentals on the special-function units (the exp
    and log1p of the logaddexp, the exp of M)."""
    G1m, G2p, dur = grad_in
    terms = G1m.numel() * dur.shape[1]
    times = {
        "bytes": 4 * (G1m.numel() + G2p.numel() + 2 * dur.numel() + 3 * G1m.numel()) / PEAK_BYTES,
        "fp32": 12 * terms / PEAK_FP32,
        "sfu": 3 * terms / (sms * SFU_PER_SM_CLOCK * clock_mhz * 1e6),
    }
    kind = max(times, key=times.get)
    return (times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind,
            {k: v * 1e3 for k, v in times.items()})


def pair_terms(pair_in):
    """The pair sum's terms: an interior boundary's (i, j) pair, sum_b (L_b
    - 1) C^2 of this run's lengths."""
    X, lengths = pair_in[0], pair_in[4]
    B, T, C = X.shape
    return int((lengths.long().clamp(1, T) - 1).sum()) * C * C


def pair_bytes_ms(pair_in):
    """The pair sum's bytes over the card's memory rate, in ms. In: X, Y,
    trans (one table where it is an expanded view), Z, lengths; out: (B, C,
    C)."""
    X, Y, trans = pair_in[:3]
    B, T, C = X.shape
    tables = B if trans.stride(0) else 1
    return (4 * (X.numel() + Y.numel() + tables * C * C + B * C * C) + 8 * B) / PEAK_BYTES * 1e3


def pair_grad_tensor_bound(pair_in, sms, clock_mhz):
    """The tensor route's bound in ms, "bytes" or "operations", which limit
    sets it ("bytes", "fp64 tensor" or "sfu") and the three times: the
    bytes (``pair_bytes_ms``); the product's 2 flops a term at the FP64
    tensor cores' peak (PEAK_FP64_TENSOR); the operands' exponentials, one
    MUFU for each live class of a tile-frame's two sides (2 C a frame for
    each of the ceil(C / PAIR_TILE) tiles a side), over the
    special-function units: every interior frame of every tile, whatever
    the split."""
    from action_segmentation_torch.ops.hsmm_cuda import PAIR_TILE

    X, lengths = pair_in[0], pair_in[4]
    B, T, C = X.shape
    frames = int((lengths.long().clamp(1, T) - 1).sum())
    times = {
        "bytes": pair_bytes_ms(pair_in) * 1e-3,
        "fp64 tensor": 2 * pair_terms(pair_in) / PEAK_FP64_TENSOR,
        "sfu": frames * 2 * C * -(-C // PAIR_TILE) / (sms * SFU_PER_SM_CLOCK * clock_mhz * 1e6),
    }
    kind = max(times, key=times.get)
    return (times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind,
            {k: v * 1e3 for k, v in times.items()})


def tensor_pair_launch(pair_in, sms):
    """A call that launches the pair sum's tensor route on `pair_in` in its
    own launch (``hsmm_cuda._launch_pair_grad``), whatever C, with no
    counter."""
    import torch

    from action_segmentation_torch.ops import hsmm_cuda as hc

    X, Y, trans, Z, lengths = pair_in
    tile = hc.pair_grad_tile(*X.shape, sms, "tensor")
    L32 = lengths.to(torch.int32).contiguous()
    return lambda: hc._launch_pair_grad(X, Y, trans, Z, L32, tile)


def pair_grad_bound(pair_in, sms, clock_mhz):
    """The scalar route's bound in ms, "bytes" or "operations", which limit
    sets it ("bytes", "fp32" or "sfu") and the three times. In: X, Y, trans
    (one table where it is an expanded view), Z, lengths; out: (B, C, C). A
    term (``pair_terms``) takes 4 fp32 operations (three adds and the
    sum's) and one transcendental (the expf) on the special-function
    units."""
    X, Y, trans, Z, lengths = pair_in
    B, T, C = X.shape
    terms = pair_terms(pair_in)
    times = {
        "bytes": pair_bytes_ms(pair_in) * 1e-3,
        "fp32": 4 * terms / PEAK_FP32,
        "sfu": terms / (sms * SFU_PER_SM_CLOCK * clock_mhz * 1e6),
    }
    kind = max(times, key=times.get)
    return (times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind,
            {k: v * 1e3 for k, v in times.items()})


def k4_wide_times(grad_in, sms, clock_mhz, card, n):
    """K4's wide kernel at a wide shape: its ms from a replayed CUDA graph
    of `n`, the narrow kernel's in its own tile on the same inputs (the
    route every width took before the wide kernel; from a graph of `n`,
    launched directly, so no counter moves), the plain version's ms, the
    bound, both tiles' lg scratch beside the (B, T, C) plane, and on the
    card the wide kernel's issue floor from its SASS plus its cross-tile
    sum's floor (tools/scan_floor.py), and the narrow tile's sum floor."""
    from action_segmentation_torch.ops import hsmm_cuda as hc
    from action_segmentation_torch.tools.scan_floor import (
        band_grad_tail,
        band_grad_wide_floor,
        band_grad_wide_issue_ms,
        built_sass,
    )

    B, T, C = grad_in[0].shape
    Km = grad_in[2].shape[1]
    wide = hc.band_grad_wide_tile(B, T, C, Km, sms)
    narrow = hc.band_grad_tile(B, T, C, Km, sms)
    b_ms, b_by, b_kind, _ = band_grad_bound(grad_in, sms, clock_mhz)
    r = {"ms": graph_ms(lambda: hc.hsmm_band_grad_wide(*grad_in), n),
         "narrow_route_ms": graph_ms(lambda: hc._launch_band_grad(*grad_in, narrow), n),
         "plain_ms": cuda_ms(lambda: hc._band_grad_plain(*grad_in), 3),
         "bound_ms": b_ms, "bound_by": b_by, "bound_limit": b_kind,
         "scratch_bytes": wide.scratch_bytes,
         "narrow_route_scratch_bytes": 4 * B * narrow.tiles * Km * C,
         "plane_bytes": 4 * B * T * C, "runs": wide.tiles, "rows": wide.rows,
         "blocks": B * wide.groups * wide.tiles, "floor_ms": None}
    if card:
        insts = band_grad_wide_floor(built_sass("band_grad"))[0]
        tail = band_grad_tail(B, T, C, Km, clock_mhz, sms, wide=True)
        r.update(issue_floor_ms=band_grad_wide_issue_ms(insts, B, T, C, Km, clock_mhz, sms),
                 tail_floor_ms=tail["floor_ms"], floor_instructions_per_duration=insts,
                 narrow_route_tail_floor_ms=band_grad_tail(B, T, C, Km, clock_mhz, sms)[
                     "floor_ms"])
        r["floor_ms"] = r["issue_floor_ms"] + r["tail_floor_ms"]
    return r


def k4_wide_line(k4):
    """K4's wide kernel's scratch and floors, for a phase's line."""
    return ("; {} runs a video of {} rows, {} blocks; lg scratch {} bytes (the narrow kernel's "
            "tile {}; the plane {}); floor {} ms (issue {} + cross-tile sum {}; the narrow "
            "tile's sum alone {}); the narrow kernel in its tile {:.5f} ms ({:.2f}x this)".format(
                k4["runs"], k4["rows"], k4["blocks"], k4["scratch_bytes"],
                k4["narrow_route_scratch_bytes"], k4["plane_bytes"],
                "not measured" if k4["floor_ms"] is None else "{:.5f}".format(k4["floor_ms"]),
                k4.get("issue_floor_ms"), k4.get("tail_floor_ms"),
                k4.get("narrow_route_tail_floor_ms"), k4["narrow_route_ms"],
                k4["narrow_route_ms"] / k4["ms"]))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from action_segmentation_torch.ops import _build
    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_grad_plain,
        _band_max_plain,
        _forward_scan_plain,
        _gamma_scan_plain,
        _log_scan_plain,
        _pair_grad_plain,
        _traceback_plain,
        _viterbi_scan_plain,
        hsmm_band_grad,
        hsmm_band_max,
        hsmm_forward_scan,
        hsmm_gamma_scan,
        hsmm_log_scan,
        hsmm_pair_grad_narrow,
        hsmm_viterbi_scan,
        hsmm_viterbi_traceback,
        scan_instance,
    )
    from action_segmentation_torch.ops import hsmm_cuda
    from action_segmentation_torch.tools.pair_times import torch_form as pair_torch_form
    from action_segmentation_torch.tools.scan_floor import (
        band_grad_floor,
        band_grad_issue_ms,
        band_max_floor,
        band_max_issue_ms,
        built_sass,
        max_sm_clock_mhz,
        pair_grad_floor,
        pair_grad_issue_ms,
        parse_function,
        traceback_floor,
        wide_duration_loop,
    )
    from action_segmentation_torch.utils.misc import host_ms

    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", "{} count={} torch={} cuda={}".format(
        kind, count, torch.__version__, torch.version.cuda))
    print(smi, flush=True)

    # 2. build: every nvcc process at once
    t0 = time.perf_counter()
    logs = _build.build(["hsmm_scan", "band_max", "band_grad", "hsmm_viterbi", "hsmm_scan_wide",
                         "pair_grad"])
    phase("build", "nvcc sm_90a, {:.1f} s".format(time.perf_counter() - t0))
    ptxas = {}
    no_spills = "0 bytes spill stores, 0 bytes spill loads"
    for name, log in logs.items():
        for fn, regs, spills in ptxas_entries(log):
            ptxas[fn] = (regs, spills)
            phase("build", "{}: {}: {} registers, {}".format(name, fn, regs, spills))
    inst = scan_instance(C, K - 1)
    for semiring in SCAN_SEMIRINGS:  # the serving instance
        serving = scan_kernel_name(semiring, inst.warps, inst.row, inst.tail)
        check(no_spills in ptxas.get(serving, (0, ""))[1],
              "{} spills or was not built: {!r}".format(serving, ptxas.get(serving)))
    for fn in WIDE_KERNELS:  # the wide DP's scans and traceback
        check(no_spills in ptxas.get(fn, (0, ""))[1],
              "{} spills or was not built: {!r}".format(fn, ptxas.get(fn)))
    for fn, cap in ((BAND_MAX_KERNELS[0], hsmm_cuda.BAND_MAX_REGS),
                    (BAND_MAX_KERNELS[1], hsmm_cuda.BAND_MAX_REGS),
                    ("band_grad_kernel", hsmm_cuda.BAND_GRAD_REGS),
                    (PAIR_TENSOR_KERNEL, hsmm_cuda.PAIR_REGS),
                    ("pair_grad_scalar_kernel", hsmm_cuda.PAIR_SCALAR_REGS)):
        regs, spills = ptxas.get(fn, (None, ""))
        check(no_spills in spills and regs is not None and regs <= cap,
              "{} spills, was not built or takes more than the {} registers its tile rule "
              "assumes: {!r}".format(fn, cap, ptxas.get(fn)))
    bm_regs = [ptxas[fn][0] for fn in BAND_MAX_KERNELS]
    bg_regs = ptxas["band_grad_kernel"][0]
    pg_regs = ptxas["pair_grad_scalar_kernel"][0]
    # K4's wide kernel: within the registers its tile rule assumes, and no
    # local memory in its duration loop (ptxas spills a few bytes around
    # it, in the loops over a run's rows and over the slabs)
    regs, spills = ptxas.get("band_grad_wide_kernel", (None, ""))
    wide_loop = wide_duration_loop(parse_function(built_sass("band_grad"),
                                                  "band_grad_wide_kernel"))
    check(regs is not None and regs <= hsmm_cuda.BAND_GRAD_WIDE_REGS
          and not any(ins[2].startswith(("LDL", "STL")) for ins in wide_loop),
          "band_grad_wide_kernel was not built, takes more than the {} registers its tile rule "
          "assumes or spills in its duration loop: {!r}".format(
              hsmm_cuda.BAND_GRAD_WIDE_REGS, ptxas.get("band_grad_wide_kernel")))

    # 3. kernels against their plain versions
    rng = np.random.RandomState(0)
    pots, lengths = serving_pots(rng, B, T, C, K, device)
    errs, scan_in, band_in = kernel_case("serving", pots, lengths)

    rl = rng.randint(1, T + 1, size=B).astype(np.int32)
    rl[[0, 5]] = 1
    rl[1] = T
    kernel_case("ragged", *serving_pots(
        rng, B, T + 32, C, K, device, lengths=rl))  # 1024 -> bucket 1056
    end = np.zeros((B, C), np.float32)
    end[:, rng.rand(C) < 0.5] = -1e9
    end[:, 0] = 0.0
    kernel_case("end_mask", *serving_pots(rng, B, T, C, K, device, end_mask=end))
    kernel_case("C=128", *serving_pots(rng, 4, T, 128, K, device))
    kernel_case("K=1", *serving_pots(rng, B, T, C, 1, device))
    kernel_case("T=12000", *serving_pots(
        rng, 2, 12000, C, K, device, lengths=np.array([12000, 7001], np.int32)))
    kernel_case("short batch", *serving_pots(  # T + 1 < K - 1
        rng, 3, 7, C, K, device, lengths=np.array([7, 5, 1], np.int32)))
    # an independent reference: the traceback Viterbi of ops/hsmm.py
    from action_segmentation_torch.ops.hsmm import hsmm_viterbi
    from action_segmentation_torch.ops.hsmm_cuda import hsmm_viterbi_labels
    from action_segmentation_torch.ops.span_codec import spans_to_labels

    pots, lengths = serving_pots(rng, 4, 300, C, K, device,
                                 lengths=np.array([300, 1, 150, 299], np.int32))
    spans, tb_scores = hsmm_viterbi(pots, lengths)
    t_idx = torch.arange(300, device=device)[None, :]
    tb_labels = torch.where(t_idx < lengths[:, None], spans_to_labels(spans), -1)
    labels_k, scores_k = hsmm_viterbi_labels(pots, lengths)
    ties = check_labels("traceback", pots, lengths, labels_k, tb_labels, scores_k, tb_scores)
    phase("kernels", "traceback: B=4 T=300 kernel labels vs hsmm_viterbi, ties={}".format(ties))

    # 3b. the training kernels and the partition's gradient
    (train_errs, log_in, fwd_in, grad_in, pair_in), gaps = run_train_kernels(device)

    # 3c. the exact-spans kernels
    vit_errs, vit_in, tb_in = run_viterbi_kernels(device)

    # 4. the slices end to end (each resets and reads the launch counters)
    e2e, launches, bm_batches = run_slice(device, num_videos=36, max_len=T, shift=1.0)
    train_e2e, train_launches = run_train_slice(device, num_videos=36, max_len=T, shift=1.0)
    root = tempfile.mkdtemp(prefix="chip_smoke_crosstask_")
    try:
        (ct_e2e, ct_launches, ct_tb_in, ct_bg_in, ct_pair_in, ct_stats,
         ct_models) = run_crosstask_slice(device, root)
        e2e.update(run_cli_slice(root, ct_stats, smi))
        e2e.update(run_u7_slice(device, root, smi))
        e2e.update(run_baselines_slice(root, smi))
        resident_e2e, resident_cases, mixed = run_resident_slice(device, root, ct_models, smi)
        e2e.update(resident_e2e)
        e2e.update(run_dp_slice(device, root, ct_models, resident_cases, mixed, smi))
        wide_e2e, wide_kernels = run_wide_slice(device, root, smi)
        e2e.update(wide_e2e)
        past_e2e, past_entries = run_past_1024_slice(device, root, smi)
        e2e.update(past_e2e)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    e2e.update(train_e2e)
    e2e.update(ct_e2e, marginal_sum_gap=gaps)

    # 5. times at the serving shape
    N2 = 2 * B
    Km = K - 1
    gamma_ms = cuda_ms(lambda: hsmm_gamma_scan(*scan_in), N_TIMED)
    gamma_plain_ms = cuda_ms(lambda: _gamma_scan_plain(*scan_in), N_TIMED)
    # the band max is shorter than its wrapper's host time: timed from a
    # replayed CUDA graph, and launched one by one beside it
    band_ms = graph_ms(lambda: hsmm_band_max(*band_in), N_TIMED)
    band_stream_ms = cuda_ms(lambda: hsmm_band_max(*band_in), N_TIMED)
    band_host_ms = host_ms(lambda: hsmm_band_max(*band_in), N_TIMED)
    band_plain_ms = cuda_ms(lambda: _band_max_plain(*band_in), N_TIMED)
    # bytes: every input read once, every output written once
    gamma_bytes = 4 * (N2 * C * C + N2 * C + N2 * Km * C + 2 * N2 * T * C)
    # per chain-step: Km adds + Km maxes per class, C adds + C maxes per
    # class for the combine, cum and alpha adds, the W push subtract
    gamma_ops = N2 * T * (2 * Km * C + 2 * C * C + 3 * C)
    G1, G2p, band = band_in
    band_bytes = 4 * (G1.numel() + G2p.numel() + band.numel() + G1.numel())
    band_ops = G1.numel() * 4 * Km  # per r: H add + max, A add, fold max
    g_bound, g_by = bound(gamma_bytes, gamma_ops)
    b_bound, b_by = bound(band_bytes, band_ops)

    log_ms = cuda_ms(lambda: hsmm_log_scan(*log_in), N_TIMED)
    log_plain_ms = cuda_ms(lambda: _log_scan_plain(*log_in), 2, warmup=1)
    fwd_ms = cuda_ms(lambda: hsmm_forward_scan(*fwd_in), N_TIMED)
    fwd_plain_ms = cuda_ms(lambda: _forward_scan_plain(*fwd_in), 2, warmup=1)
    # the band gradient is shorter than its wrapper's host time: timed from
    # a replayed CUDA graph, and launched one by one beside it
    grad_ms = graph_ms(lambda: hsmm_band_grad(*grad_in), N_TIMED)
    grad_stream_ms = cuda_ms(lambda: hsmm_band_grad(*grad_in), N_TIMED)
    grad_host_ms = host_ms(lambda: hsmm_band_grad(*grad_in), N_TIMED)
    grad_plain_ms = cuda_ms(lambda: _band_grad_plain(*grad_in), 10)

    def scan_bound(n, n_out):
        # per chain-step and class: the duration reduce (Km adds, maxes,
        # subtracts, exps and sum adds, one log, one add), the transition
        # combine (the same over C), the cum add and the W push
        ops = n * T * C * (5 * Km + 5 * C + 6)
        nbytes = 4 * (n * C * C + n * C + n * Km * C + (1 + n_out) * n * T * C)
        return bound(nbytes, ops)

    l_bound, l_by = scan_bound(N2, 2)
    f_bound, f_by = scan_bound(B, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    gr_bound, gr_by, gr_kind, gr_times = band_grad_bound(grad_in, sms, clock_mhz)
    # the issue floor: the duration loop's instructions from the SASS
    bg_insts, bg_mufu = band_grad_floor(built_sass("band_grad"))

    def bg_floor(grad_in):
        Bn, Tn, Cn = grad_in[0].shape
        return band_grad_issue_ms(bg_insts, Bn, Tn, Cn, grad_in[2].shape[1], clock_mhz, sms)

    bg_tile = hsmm_cuda.band_grad_tile(B, T, C, Km, sms)
    # K4 at B=2, T=12,000 (phase 3b's long videos): the launch over each
    # video's chunks that the backward makes, beside the same rows as one
    # chunk (the launch before the chunks; timing only, unanchored)
    long_pots, long_L = serving_pots(np.random.RandomState(0), 2, 12000, C, K, device,
                                     lengths=np.array([12000, 7001], np.int32))
    long_L = long_L.long()
    long_scan = hsmm_log_scan(*hsmm_cuda._stack_fwd_rev(long_pots, long_L))
    long_in = grad_inputs(long_pots, long_L, *long_scan)
    one_in = hsmm_cuda._band_inputs(long_pots, long_L, long_scan[0])
    long_k4 = {"chunks": long_in[0].shape[0] // 2, "rows": long_in[0].shape[1],
               "ms": graph_ms(lambda: hsmm_band_grad(*long_in), N_TIMED),
               "one_chunk_ms": graph_ms(lambda: hsmm_band_grad(*one_in), N_TIMED),
               "floor_ms": bg_floor(long_in), "one_chunk_floor_ms": bg_floor(one_in),
               "bound_ms": band_grad_bound(long_in, sms, clock_mhz)[0]}
    phase("times", "K4 at B=2 T=12000: {chunks} chunks a video of {rows} rows, {ms:.5f} ms "
          "from a graph (floor {floor_ms:.5f}, bound {bound_ms:.5f}); the same rows as one "
          "chunk {one_chunk_ms:.5f} ms (floor {one_chunk_floor_ms:.5f})".format(**long_k4))
    # the band max's issue floor from its duration loops in the SASS (which
    # raises if one of them holds a barrier)
    bm_loops = band_max_floor(built_sass("band_max"))

    def bm_floor(band_in):
        Bn, Tn, Cn = band_in[0].shape
        return band_max_issue_ms(bm_loops, Bn, Tn, Cn, band_in[2].shape[1], clock_mhz, sms)

    bm_tile = hsmm_cuda.band_max_tile(B, T, C, Km, sms)
    # the band max at the synthetic slice's decode batches: the launches the
    # labels chain's main path makes
    slice_bm = []
    for path, batches in bm_batches.items():
        for bm_in in batches:
            check_equal("{} batch band max".format(path), hsmm_band_max(*bm_in),
                        _band_max_plain(*bm_in))
            Bn, Tn, Cn = bm_in[0].shape
            tile = hsmm_cuda.band_max_tile(Bn, Tn, Cn, bm_in[2].shape[1], sms)
            slice_bm.append((graph_ms(lambda: hsmm_band_max(*bm_in), N_TIMED),
                             cuda_ms(lambda: hsmm_band_max(*bm_in), N_TIMED), bm_floor(bm_in),
                             path, (Bn, Tn, Cn), (tile.rows, Bn * tile.tiles, tile.waves)))
    check(all(bm_batches.values()), "a decode path of the slice launched no band max")

    # the band gradient at the constrained CrossTask fit's batches: the
    # launches the training path makes there
    ct_bg = []
    for bg_in in ct_bg_in:
        got, want = hsmm_band_grad(*bg_in), _band_grad_plain(*bg_in)
        torch.cuda.synchronize()
        check_band_grad("crosstask fit batch band grad", got, want)
        Bn, Tn, Cn = bg_in[0].shape
        tile = hsmm_cuda.band_grad_tile(Bn, Tn, Cn, bg_in[2].shape[1], sms)
        ct_bg.append((graph_ms(lambda: hsmm_band_grad(*bg_in), N_TIMED),
                      cuda_ms(lambda: hsmm_band_grad(*bg_in), N_TIMED), bg_floor(bg_in),
                      band_grad_bound(bg_in, sms, clock_mhz)[0], (Bn, Tn, Cn),
                      (tile.rows, Bn * tile.tiles, tile.waves)))
    check(len(ct_bg) > 0, "the constrained CrossTask fit launched no band gradient")
    ct_mean = {k: float(np.mean([x[i] for x in ct_bg]))
               for i, k in enumerate(("ms", "stream_ms", "floor_ms", "bound_ms"))}

    # the pair sum's scalar route (C <= 32) at the serving shape (phase 3b's
    # serving inputs) and at the constrained CrossTask fit's batches (the
    # launches the training path makes there): the kernel from a replayed
    # CUDA graph, beside the tensor route's kernel on the same inputs
    # (launched directly, so no counter moves: why the scalar route stays
    # at these widths), the torch form the backward once ran (its whole
    # (B, T, C, C) exponent) and the plain version; no
    # library call computes the sum
    pg_tile = hsmm_cuda.pair_grad_tile(B, T, C, sms)
    check(pg_tile.route == "scalar", "the serving shape's pair sum is not on the scalar route")
    pg_ms = graph_ms(lambda: hsmm_pair_grad_narrow(*pair_in), N_TIMED)
    pg_stream_ms = cuda_ms(lambda: hsmm_pair_grad_narrow(*pair_in), N_TIMED)
    pg_tensor_ms = graph_ms(tensor_pair_launch(pair_in, sms), N_TIMED)
    pg_form_ms = cuda_ms(lambda: pair_torch_form(*pair_in, T > hsmm_cuda.SCAN_FOLD), 10)
    pg_plain_ms = cuda_ms(lambda: _pair_grad_plain(*pair_in), 10)
    pg_bound, pg_by, pg_kind, pg_times = pair_grad_bound(pair_in, sms, clock_mhz)
    # its issue floor: the term loop's instructions from the SASS
    # (tools/scan_floor.py) over the 4 schedulers of every SM
    pg_sass = next(v for k, v in pair_grad_floor(built_sass("pair_grad")).items()
                   if v["design"] == "scalar")
    pg_floor_ms = pair_grad_issue_ms(pg_sass["instructions_per_term"], pair_terms(pair_in),
                                     clock_mhz, sms)
    ct_pg = []
    for pg_in in ct_pair_in:
        check_pair_grad("crosstask fit batch", pg_in)
        fold = pg_in[0].shape[1] > hsmm_cuda.SCAN_FOLD
        ct_pg.append((graph_ms(lambda: hsmm_pair_grad_narrow(*pg_in), N_TIMED),
                      cuda_ms(lambda: pair_torch_form(*pg_in, fold), 10),
                      pair_grad_bound(pg_in, sms, clock_mhz)[0], tuple(pg_in[0].shape),
                      graph_ms(tensor_pair_launch(pg_in, sms), N_TIMED)))
    check(len(ct_pg) > 0, "the constrained CrossTask fit launched no pair sum")
    ct_pg_mean = {k: float(np.mean([x[i] for x in ct_pg]))
                  for i, k in enumerate(("ms", "torch_form_ms", "bound_ms"))}
    ct_pg_mean["tensor_route_ms"] = float(np.mean([x[4] for x in ct_pg]))

    vit_ms = cuda_ms(lambda: hsmm_viterbi_scan(*vit_in), N_TIMED)
    vit_plain_ms = cuda_ms(lambda: _viterbi_scan_plain(*vit_in), 2, warmup=1)
    tb_ms = graph_ms(lambda: hsmm_viterbi_traceback(*tb_in), N_TIMED)
    tb_stream_ms = cuda_ms(lambda: hsmm_viterbi_traceback(*tb_in), N_TIMED)
    tb_plain_ms = cuda_ms(lambda: _traceback_plain(*tb_in), 2, warmup=1)
    # in: trans, init, dur, emit; out: alphas (float32) and codes (int32).
    # Per step and class: the duration reduce (Km adds and compare-selects),
    # the transition combine (C of each), the cum and alpha adds, the push
    vit_bytes = 4 * (B * C * C + B * C + B * Km * C + 3 * B * T * C)
    v_bound, v_by = bound(vit_bytes, B * T * (2 * Km * C + 2 * C * C + 3 * C))
    # the walk reads two codes per segment of this run's best paths and
    # writes the spans; lengths and final classes in
    per_video = (hsmm_viterbi_traceback(*tb_in) >= 0).sum(dim=1)
    n_segments, longest = int(per_video.sum()), int(per_video.max())
    tb_bound, tb_by = bound(8 * B * T + 8 * n_segments + 16 * B, 4 * n_segments)
    # the walk's serial floor: the longest video's segments, one chain each
    chain, _ = traceback_floor(built_sass("hsmm_viterbi"))
    tb_floor_ms = longest * chain / clock_mhz * 1e-3
    # the traceback at the CrossTask predict batches: the launches the
    # spans chain's main path makes
    ct_tb = []
    for ct_in in ct_tb_in:
        spans = hsmm_viterbi_traceback(*ct_in)
        check(torch.equal(spans, _traceback_plain(*ct_in)), "crosstask batch traceback spans "
              "differ from the plain version's")
        videos = (spans >= 0).sum(dim=1)
        ct_tb.append((graph_ms(lambda: hsmm_viterbi_traceback(*ct_in), N_TIMED),
                      int(videos.sum()), int(videos.max()), ct_in[0].shape,
                      cuda_ms(lambda: hsmm_viterbi_traceback(*ct_in), N_TIMED)))
    ct_tb_ms = float(np.mean([x[0] for x in ct_tb]))
    ct_longest = max(x[2] for x in ct_tb)
    # the max gamma scan and the backpointer scan at one common chain count
    # (decode stacks 2B chains for the gamma scan; the spans chain runs B)
    gamma_b_in = tuple(x[:B] for x in scan_in)  # the forward chains
    gamma_b_ms = cuda_ms(lambda: hsmm_gamma_scan(*gamma_b_in), N_TIMED)
    vit_2b_in = tuple(torch.cat([x, x]) for x in vit_in)
    vit_2b_ms = cuda_ms(lambda: hsmm_viterbi_scan(*vit_2b_in), N_TIMED)
    kernels = [
        {
            "name": "hsmm_gamma_scan", "route": "cuda",
            "source": "action_segmentation_torch/csrc/hsmm_scan.cu",
            "replaces": TPU_FILE + ":229", "launches": launches[0],
            "max_abs_err": errs["gamma"], "ms": gamma_ms, "kernel_ms": gamma_ms,
            "ms_per_step": gamma_ms / T, "plain_ms": gamma_plain_ms,
            "bound_ms": g_bound, "bound_by": g_by, "library_ms": None,
        },
        {
            "name": "hsmm_band_max", "route": "cuda",
            "source": "action_segmentation_torch/csrc/band_max.cu",
            "replaces": TPU_FILE + ":726", "also_replaces": TPU_FILE + ":605",
            "launches": launches[1], "max_abs_err": errs["band"],
            "ms": band_ms, "kernel_ms": band_ms, "graph_ms": band_ms,
            "stream_ms": band_stream_ms, "host_ms": band_host_ms, "plain_ms": band_plain_ms,
            "bound_ms": b_bound, "bound_by": b_by, "floor_ms": bm_floor(band_in),
            "floor_instructions_per_duration": bm_loops, "registers": bm_regs,
            "rows": bm_tile.rows, "slab": bm_tile.slab, "blocks": B * bm_tile.tiles,
            "blocks_per_sm": bm_tile.blocks_per_sm, "waves": bm_tile.waves,
            "filling": bm_tile.filling, "balance": bm_tile.balance, "library_ms": None,
            "slice_batches": len(slice_bm),
            "slice_batches_graph_ms": float(np.mean([x[0] for x in slice_bm])),
            "slice_batches_graph_ms_range": [min(x[0] for x in slice_bm),
                                             max(x[0] for x in slice_bm)],
            "slice_batches_stream_ms": float(np.mean([x[1] for x in slice_bm])),
            "slice_batches_floor_ms": float(np.mean([x[2] for x in slice_bm])),
        },
        {
            "name": "hsmm_log_scan", "route": "cuda",
            "source": "action_segmentation_torch/csrc/hsmm_scan.cu",
            "replaces": TPU_FILE + ":229", "semiring": "log, with alphas",
            "launches": train_launches[0], "max_abs_err": train_errs["log_scan"],
            "ms": log_ms, "kernel_ms": log_ms, "ms_per_step": log_ms / T,
            "plain_ms": log_plain_ms, "bound_ms": l_bound, "bound_by": l_by,
            "library_ms": None,
        },
        {
            "name": "hsmm_forward_scan", "route": "cuda",
            "source": "action_segmentation_torch/csrc/hsmm_scan.cu",
            "replaces": TPU_FILE + ":156", "semiring": "log, alphas only",
            "launches": train_launches[1], "max_abs_err": train_errs["forward_scan"],
            "ms": fwd_ms, "kernel_ms": fwd_ms, "ms_per_step": fwd_ms / T,
            "plain_ms": fwd_plain_ms, "bound_ms": f_bound, "bound_by": f_by,
            "library_ms": None,
        },
        {
            "name": "hsmm_band_grad", "route": "cuda",
            "source": "action_segmentation_torch/csrc/band_grad.cu",
            "replaces": TPU_FILE + ":771", "launches": train_launches[2],
            "max_abs_err": train_errs["band_grad"], "ms": grad_ms, "kernel_ms": grad_ms,
            "graph_ms": grad_ms, "stream_ms": grad_stream_ms, "host_ms": grad_host_ms,
            "plain_ms": grad_plain_ms, "bound_ms": gr_bound, "bound_by": gr_by,
            "bound_limit": gr_kind, "bytes_ms": gr_times["bytes"], "fp32_ms": gr_times["fp32"],
            "sfu_ms": gr_times["sfu"], "floor_ms": bg_floor(grad_in),
            "floor_instructions_per_duration": bg_insts, "floor_mufu_per_duration": bg_mufu,
            "registers": bg_regs, "rows": bg_tile.rows, "slab": bg_tile.slab,
            "blocks": B * bg_tile.tiles, "blocks_per_sm": bg_tile.blocks_per_sm,
            "waves": bg_tile.waves, "filling": bg_tile.filling, "balance": bg_tile.balance,
            "library_ms": None,
            "crosstask_fit_batches": len(ct_bg),
            "crosstask_fit_batch_ms": ct_mean["ms"],
            "crosstask_fit_batch_ms_range": [min(x[0] for x in ct_bg), max(x[0] for x in ct_bg)],
            "crosstask_fit_batch_stream_ms": ct_mean["stream_ms"],
            "crosstask_fit_batch_floor_ms": ct_mean["floor_ms"],
            "crosstask_fit_batch_bound_ms": ct_mean["bound_ms"],
            "t12000_chunks": long_k4["chunks"], "t12000_ms": long_k4["ms"],
            "t12000_floor_ms": long_k4["floor_ms"], "t12000_bound_ms": long_k4["bound_ms"],
            "t12000_one_chunk_ms": long_k4["one_chunk_ms"],
        },
        {
            "name": PAIR_NARROW_NAME, "route": "cuda",
            "source": "action_segmentation_torch/csrc/pair_grad.cu",
            "kernel": "pair_grad_scalar_kernel",
            "replaces": "action_segmentation_tpu/ops/hsmm_grad.py:246",
            "replaces_what": "XLA's fusion of _fb_bwd_packed's pair broadcast-sum (no Pallas "
                             "kernel), at C <= 32",
            "launches": train_launches[4], "max_abs_err": PAIR_ERRS["scalar"],
            "ms": pg_ms, "kernel_ms": pg_ms, "graph_ms": pg_ms, "stream_ms": pg_stream_ms,
            "tensor_route_ms": pg_tensor_ms,
            "plain_ms": pg_plain_ms, "torch_form_ms": pg_form_ms, "bound_ms": pg_bound,
            "bound_by": pg_by, "bound_limit": pg_kind, "bytes_ms": pg_times["bytes"],
            "fp32_ms": pg_times["fp32"], "sfu_ms": pg_times["sfu"], "registers": pg_regs,
            "runs": pg_tile.runs, "frames": pg_tile.frames,
            "blocks": B * pg_tile.tiles * pg_tile.runs, "waves": pg_tile.waves,
            "library_ms": None, "floor_ms": pg_floor_ms,
            "floor_instructions_per_term": pg_sass["instructions_per_term"],
            "floor_mufu_per_loop": pg_sass["mufu"],
            "crosstask_fit_batches": len(ct_pg),
            "crosstask_fit_batch_ms": ct_pg_mean["ms"],
            "crosstask_fit_batch_ms_range": [min(x[0] for x in ct_pg), max(x[0] for x in ct_pg)],
            "crosstask_fit_batch_tensor_route_ms": ct_pg_mean["tensor_route_ms"],
            "crosstask_fit_batch_torch_form_ms": ct_pg_mean["torch_form_ms"],
            "crosstask_fit_batch_bound_ms": ct_pg_mean["bound_ms"],
        },
        {
            "name": "hsmm_viterbi_scan", "route": "cuda",
            "source": "action_segmentation_torch/csrc/hsmm_viterbi.cu",
            "replaces": TPU_FILE + ":110", "launches": ct_launches[0],
            "max_abs_err": vit_errs["scan"], "ms": vit_ms, "kernel_ms": vit_ms,
            "ms_per_step": vit_ms / T, "plain_ms": vit_plain_ms, "bound_ms": v_bound,
            "bound_by": v_by, "library_ms": None,
        },
        {
            "name": "hsmm_viterbi_traceback", "route": "cuda",
            "source": "action_segmentation_torch/csrc/hsmm_viterbi.cu",
            "replaces": TPU_FILE + ":440", "launches": ct_launches[1],
            "max_abs_err": vit_errs["traceback"], "ms": tb_ms, "kernel_ms": tb_ms,
            "stream_ms": tb_stream_ms,
            "segments": n_segments, "segments_longest_video": longest,
            "us_per_segment": 1e3 * tb_ms / longest, "plain_ms": tb_plain_ms,
            "bound_ms": tb_bound, "bound_by": tb_by, "floor_ms": tb_floor_ms,
            "floor_cycles_per_segment": chain, "library_ms": None,
            "crosstask_batch_ms": ct_tb_ms,
            "crosstask_batch_ms_range": [min(x[0] for x in ct_tb), max(x[0] for x in ct_tb)],
            "crosstask_batch_stream_ms": float(np.mean([x[4] for x in ct_tb])),
            "crosstask_batch_segments": float(np.mean([x[1] for x in ct_tb])),
            "crosstask_batch_longest_video": ct_longest,
            "crosstask_batch_floor_ms": ct_longest * chain / clock_mhz * 1e-3,
        },
    ]
    for k in kernels:
        # the launches on phase 4d's command-line legs, summed (4d resets the
        # counters before each leg and reads them after)
        k["cli_launches"] = e2e["cli_launches"][k["name"]]
        k["u7_launches"] = e2e["u7_launches"][k["name"]]
        # phase 4g's resident runs (the cases and the resumed command line)
        k["resident_launches"] = e2e["resident_launches"][k["name"]]
        # phase 4f's: no baseline reaches the HSMM chain
        k["baseline_launches"] = e2e["baseline_launches"][k["name"]]
        check(k["baseline_launches"] == 0, "{} launched by a baseline".format(k["name"]))
        # phase 4h's data-parallel runs, every rank's summed
        k["dp_launches"] = e2e["dp_launches"][k["name"]]
        check(k["dp_launches"] > 0, "{} was not launched on phase 4h's ranks".format(k["name"]))
        check(all(math.isfinite(v) for v in numbers(k)), "non-finite number in {}".format(k))
        check(k["launches"] > 0, "{} was not launched on its path".format(k["name"]))
    pair = next(k for k in kernels if k["name"] == PAIR_NARROW_NAME)
    # phase 4i: the wide kernels (K4's wide kernel among them), whose path is 4i's
    for k in wide_kernels:
        check(all(math.isfinite(v) for v in numbers(k)), "non-finite number in {}".format(k))
        check(k["launches"] > 0, "{} was not launched on phase 4i's path".format(k["name"]))
    kernels.extend(wide_kernels)
    # phase 4j: the same kernels past 1,024 classes, whose path is 4j's
    for k in kernels:
        if k["name"] in past_entries:
            k.update(past_entries[k["name"]])
            check(all(math.isfinite(v) for v in numbers(k)), "non-finite number in {}".format(k))
    # the tensor route's error over every case of the run (4i's and 4j's)
    next(k for k in kernels if k["name"] == PAIR_NAME)["max_abs_err"] = PAIR_ERRS["tensor"]
    phase("times", "serving shape B={} T={} C={} K={}; {} launches of each kernel; "
          "plain versions of the scans and the traceback 2 launches; library call: none "
          "computes any of these functions".format(B, T, C, K, N_TIMED))
    phase("times", "us per scan step: gamma max {:.4f}, log {:.4f}, forward {:.4f}, viterbi "
          "{:.4f}".format(*(1e3 * k["ms_per_step"] for k in kernels if "ms_per_step" in k)))
    phase("times", "at one chain count, us per step: {} chains gamma max {:.4f}, viterbi {:.4f};"
          " {} chains gamma max {:.4f}, viterbi {:.4f}".format(
              B, 1e3 * gamma_b_ms / T, 1e3 * vit_ms / T, 2 * B, 1e3 * gamma_ms / T,
              1e3 * vit_2b_ms / T))
    e2e["common_chain_us_per_step"] = {
        "gamma_max": {str(B): 1e3 * gamma_b_ms / T, str(2 * B): 1e3 * gamma_ms / T},
        "viterbi": {str(B): 1e3 * vit_ms / T, str(2 * B): 1e3 * vit_2b_ms / T},
    }
    phase("times", "viterbi scan {:.4f} ms ({:.3f} us per step, bound {:.5f} ms), traceback "
          "{:.5f} ms (a CUDA graph of {} launches; {:.5f} launched one by one) over {} "
          "segments, the longest video {} ({:.5f} us a segment; bound {:.5f} ms, serial floor "
          "{:.5f} ms: {:.0f} cycles a segment at {:.0f} MHz); crosstask predict {:.0f} "
          "frames/s".format(
              vit_ms, 1e3 * vit_ms / T, v_bound, tb_ms, N_TIMED, tb_stream_ms, n_segments,
              longest, 1e3 * tb_ms / longest, tb_bound, tb_floor_ms, chain, clock_mhz,
              e2e["crosstask_predict_frames_per_s"]))
    phase("times", "traceback at the {} crosstask predict batches: {:.5f} ms a launch ({:.5f}-"
          "{:.5f}; {:.5f} launched from the host one by one), {:.1f} segments a batch, the "
          "longest video {} (floor {:.5f} ms); shapes {}".format(
              len(ct_tb), ct_tb_ms, min(x[0] for x in ct_tb), max(x[0] for x in ct_tb),
              float(np.mean([x[4] for x in ct_tb])), float(np.mean([x[1] for x in ct_tb])),
              ct_longest, ct_longest * chain / clock_mhz * 1e-3,
              sorted({tuple(x[3]) for x in ct_tb})))
    phase("times", "band grad {:.5f} ms (a CUDA graph of {} launches; {:.5f} launched one by "
          "one; the wrapper's host time {:.5f} a call), bound {:.5f} ms by {} (bytes {:.5f}, fp32 {:.5f}, sfu {:.5f} at {:.0f} MHz), "
          "issue floor {:.5f} ms ({} instructions, {} MUFU a duration, {} registers); tile {} "
          "rows, slab {}, {} blocks, {} an SM, {} waves, filling {:.3f}, balance {:.3f}".format(
              grad_ms, N_TIMED, grad_stream_ms, grad_host_ms, gr_bound, gr_kind, gr_times["bytes"],
              gr_times["fp32"], gr_times["sfu"], clock_mhz, bg_floor(grad_in), bg_insts, bg_mufu,
              bg_regs, bg_tile.rows, bg_tile.slab, B * bg_tile.tiles, bg_tile.blocks_per_sm,
              bg_tile.waves, bg_tile.filling, bg_tile.balance))
    phase("times", "pair grad, scalar route, {:.5f} ms (a CUDA graph of {} launches; {:.5f} "
          "launched one by one; the tensor route's kernel on the same inputs {:.5f} ms, {:.2f}x "
          "it), bound {:.5f} ms by {} (bytes {:.5f}, fp32 {:.5f}, sfu {:.5f} at {:.0f} MHz), "
          "{:.2f}x it; issue floor {:.5f} ms ({:.2f} instructions a term); the torch form {:.5f} "
          "ms ({:.1f}x the kernel), plain {:.4f} ms; {} registers; {} runs of {} frames, {} "
          "blocks, {} waves; launches: train path {}, cli {}, u7 {}, resident {}, dp {}, "
          "baselines {}".format(
              pg_ms, N_TIMED, pg_stream_ms, pg_tensor_ms, pg_tensor_ms / pg_ms, pg_bound,
              pg_kind, pg_times["bytes"], pg_times["fp32"], pg_times["sfu"], clock_mhz,
              pg_ms / pg_bound, pair["floor_ms"], pair["floor_instructions_per_term"],
              pg_form_ms, pg_form_ms / pg_ms, pg_plain_ms, pg_regs, pg_tile.runs,
              pg_tile.frames, pair["blocks"], pg_tile.waves, pair["launches"],
              pair["cli_launches"], pair["u7_launches"], pair["resident_launches"],
              pair["dp_launches"], pair["baseline_launches"]))
    phase("times", "pair grad, scalar route, at the {} constrained crosstask fit batches: "
          "{:.5f} ms a launch ({:.5f}-{:.5f}; the tensor route's kernel {:.5f}), bound {:.5f} "
          "ms, the torch form {:.5f} ms; shapes {}; against the plain version at rtol 1e-5 / "
          "atol 1e-4, two launches equal".format(
              len(ct_pg), ct_pg_mean["ms"], min(x[0] for x in ct_pg), max(x[0] for x in ct_pg),
              ct_pg_mean["tensor_route_ms"], ct_pg_mean["bound_ms"],
              ct_pg_mean["torch_form_ms"], sorted({x[3] for x in ct_pg})))
    phase("times", "band max {:.5f} ms (a CUDA graph of {} launches; {:.5f} launched one by "
          "one; the wrapper's host time {:.5f} a call), bound {:.5f} ms by {}, issue floor "
          "{:.5f} ms (instructions a duration {}, {} registers); tile {} rows, slab {}, {} "
          "blocks, {} an SM, {} waves, filling {:.3f}, balance {:.3f}".format(
              band_ms, N_TIMED, band_stream_ms, band_host_ms, b_bound, b_by, bm_floor(band_in),
              bm_loops, bm_regs, bm_tile.rows, bm_tile.slab, B * bm_tile.tiles,
              bm_tile.blocks_per_sm, bm_tile.waves, bm_tile.filling, bm_tile.balance))
    phase("times", "band max at the {} synthetic decode batches (predict, segment_many): "
          "{:.5f} ms a launch ({:.5f}-{:.5f}; {:.5f} launched one by one), issue floor {:.5f} "
          "ms; shapes {}, (rows, blocks, waves) {}; fm equal to the plain version's".format(
              len(slice_bm), float(np.mean([x[0] for x in slice_bm])),
              min(x[0] for x in slice_bm), max(x[0] for x in slice_bm),
              float(np.mean([x[1] for x in slice_bm])), float(np.mean([x[2] for x in slice_bm])),
              sorted({x[4] for x in slice_bm}), sorted({x[5] for x in slice_bm})))
    phase("times", "band grad at the {} constrained crosstask fit batches: {:.5f} ms a launch "
          "({:.5f}-{:.5f}; {:.5f} launched one by one), bound {:.5f} ms, issue floor {:.5f} ms; "
          "shapes {}, (rows, blocks, waves) {}".format(
              len(ct_bg), ct_mean["ms"], min(x[0] for x in ct_bg), max(x[0] for x in ct_bg),
              ct_mean["stream_ms"], ct_mean["bound_ms"], ct_mean["floor_ms"],
              sorted({x[4] for x in ct_bg}), sorted({x[5] for x in ct_bg})))
    print(json.dumps({"e2e": e2e, "card": smi}), flush=True)
    phase("done", "wall time {:.1f} s".format(time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
