"""Drive the PyTorch/CUDA port's decode path on one card and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one or more lines each; any failure ends the run with a non-zero
exit and no result line:

  1. device  — card name, count, and nvidia-smi's name and power limit;
  2. build   — both kernels from action_segmentation_torch/csrc with nvcc
               for sm_90a, printing ptxas' register/smem/spill lines;
  3. kernels — each kernel against its plain PyTorch version on the card
               at the serving width (B=18, T=1024, C=19, K=20, D=300) and
               at the edge cases (ragged lengths down to 1 with bucket
               padding, a BIG_NEG end mask, C=128, K=1, T=12,000); and
               the kernels' labels against the traceback Viterbi;
  4. slice   — synthetic corpus, closed-form fit, SemiMarkovModel.predict
               and Segmenter.segment_many at batch 18, Accuracy MoF; the
               launch counters must show both kernels on both paths;
  5. times   — CUDA-event kernel and plain-version times at the serving
               shape beside the roofline bound, and segment_many frames/s.

The line before the last is one JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

# serving shape: one CrossTask task (steps + per-step backgrounds), three
# 100-dim PCA feature groups, the default --sm_max_span_length, a
# CrossTask-length video, 18 videos per batch
B, T, C, K, D = 18, 1024, 19, 20, 300
N_TIMED = 50
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 op/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# tolerances of the JAX package's own tests (tests/test_hsmm_pallas.py)
RTOL, ATOL = 1e-5, 1e-4
TPU_FILE = "action_segmentation_tpu/ops/hsmm_pallas.py"


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


def assert_close(name, got, want):
    import torch

    try:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    except AssertionError as e:
        raise RuntimeError("{}: kernel disagrees with its plain version\n{}".format(name, e))


def check_labels(name, pots, lengths, got, want, got_scores, want_scores):
    """Labels equal except at frames where the two are a genuine tie:
    their float64 max-marginals (the plain chain rerun in float64 on the
    same potentials) differ by less than the score tolerance. Scores
    within RTOL/ATOL. Returns the number of tie frames."""
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
    per_video = mism.sum(dim=1)
    bound = torch.clamp(lengths.long() // 200, min=2)
    check(
        bool((per_video <= bound).all()) and bool((gap <= tol).all()),
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
    assert_close(name + " band max", fm_k, fm_p)

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


def mof(datasplit, predictions):
    from action_segmentation_torch.evaluation.accuracy import Accuracy

    acc = Accuracy(verbose=False, corpus=datasplit.corpus)
    for name in sorted(predictions):
        acc.add_gt_labels(datasplit[(datasplit.task, name)]["gt"])
        acc.add_predicted_labels(predictions[name])
    acc.mof(optimal_assignment=False)
    return acc.mof_val()


def run_slice(device, num_videos, max_len, shift):
    """Closed-form fit, predict and segment_many on synthetic CrossTask-
    width data; returns the e2e record and the main path's launches."""
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
    return e2e, launches


def cuda_ms(fn, n):
    import torch

    for _ in range(3):
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


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from action_segmentation_torch.ops import _build
    from action_segmentation_torch.ops.hsmm_cuda import (
        _band_max_plain,
        _gamma_scan_plain,
        hsmm_band_max,
        hsmm_gamma_scan,
    )

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

    # 2. build: both nvcc processes at once
    t0 = time.perf_counter()
    logs = _build.build(["hsmm_scan", "band_max"])
    phase("build", "nvcc sm_90a, {:.1f} s".format(time.perf_counter() - t0))
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                phase("build", "{}: {}".format(name, line.strip()))

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

    # 4. the slice end to end (resets and reads the launch counters)
    e2e, launches = run_slice(device, num_videos=36, max_len=T, shift=1.0)

    # 5. times at the serving shape
    N2 = 2 * B
    Km = K - 1
    gamma_ms = cuda_ms(lambda: hsmm_gamma_scan(*scan_in), N_TIMED)
    gamma_plain_ms = cuda_ms(lambda: _gamma_scan_plain(*scan_in), N_TIMED)
    band_ms = cuda_ms(lambda: hsmm_band_max(*band_in), N_TIMED)
    band_plain_ms = cuda_ms(lambda: _band_max_plain(*band_in), N_TIMED)
    # bytes: every input read once, every output written once
    gamma_bytes = 4 * (N2 * C * C + N2 * C + N2 * Km * C + 2 * N2 * T * C)
    # per chain-step: Km adds + Km maxes per class, C adds + C maxes per
    # class for the combine, cum and alpha adds, the W push subtract
    gamma_ops = N2 * T * (2 * Km * C + 2 * C * C + 3 * C)
    G1, G2p, band = band_in
    band_bytes = 4 * (G1.numel() + G2p.numel() + band.numel() + G1.numel())
    band_ops = G1.numel() * 4 * Km  # per r: H add + max, fold add + max
    g_bound, g_by = bound(gamma_bytes, gamma_ops)
    b_bound, b_by = bound(band_bytes, band_ops)
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
            "ms": band_ms, "kernel_ms": band_ms, "plain_ms": band_plain_ms,
            "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
        },
    ]
    for k in kernels:
        check(all(isinstance(v, str) or v is None or math.isfinite(v)
                  for v in k.values()), "non-finite number in {}".format(k))
    phase("times", "serving shape B={} T={} C={} K={}; {} launches each; "
          "library call: none computes either function".format(B, T, C, K, N_TIMED))
    print(json.dumps({"e2e": e2e, "card": smi}), flush=True)
    phase("done", "{:.1f} s".format(time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
