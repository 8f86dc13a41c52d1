"""The port's data parallelism (``parallel/mesh.py``) on the CPU, under gloo.

Twins of tests/test_parallel.py's 14 tests at their tolerances, each at
world 2 and at an uneven world 3 (13 videos at batch 6 pad to 6 rows, the
last batch one real video, so a rank decodes and trains padding only):
the dry run, the forward entry against JAX's, the fit against the
single path (generative, discriminative, compound with its latent,
--batch_accumulation), one step's gradients, the kernels' training and
decode paths, the logged gradient norm, checkpoint and resume, and
predict. Beyond them: world 1 (a gloo group of one in this process)
bit-equal to the single path; the ranks' parameters bit-equal to rank
0's after every fit; the port's DP epoch losses and labels against the
JAX package's DP run on its 8-device virtual mesh; a two-rank main.main
where only rank 0 writes; --data_parallel without a group (one device:
the single path; several cards: raises); JAX's batch padding.

Each world's ranks are spawned once (``parallel.mesh.run_ranks``, a
``file://`` store in a fresh temporary directory) and run every job of
``tests/torch_parallel_cases.py``; the single-path and JAX references
run in this process.
"""

import argparse
import logging
import os

import jax
import numpy as np
import pytest
import torch

from action_segmentation_torch import checkpoint
from action_segmentation_torch import graft_entry
from action_segmentation_torch.bridge import gaussian_hsmm_params_from_numpy
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models.semimarkov import GaussianHsmm as TGaussian
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.ops.hsmm import hsmm_partition, hsmm_viterbi
from action_segmentation_torch.ops.span_codec import spans_to_labels
from action_segmentation_torch.parallel import mesh as tmesh
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from action_segmentation_tpu.parallel import mesh as jmesh
from tests import test_torch_constrained as tc
from tests import torch_parallel_cases as cases
from tests.conftest import make_sm_args

GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
WORLDS = (2, 3)

GEN = dict(num_videos=13, n_classes=3, max_len=20, span_k=4, seed=0)
DISC = dict(num_videos=8, n_classes=3, max_len=18, span_k=4, seed=3)
PRED = dict(num_videos=11, n_classes=3, max_len=24, span_k=4, seed=1)
LOGS = dict(num_videos=8, n_classes=3, max_len=16, span_k=4, seed=2)
RESUME = dict(num_videos=9, n_classes=3, max_len=16, span_k=4, seed=5)
JAX_SPLIT = dict(num_videos=14, n_classes=3, max_len=60, min_len=8, span_k=5, seed=9)


def fit_args(dp, **over):
    return make_sm_args(data_parallel=dp, **over)


FITS = {
    "generative": (GEN, True, dict(batch_size=6, sm_max_span_length=8, epochs=2, lr=1e-2,
                                   sm_supervised_method="gradient-based")),
    "discriminative": (DISC, True, dict(batch_size=4, sm_max_span_length=6, epochs=1,
                                        lr=1e-2, sm_supervised_method="gradient-based",
                                        sm_train_discriminatively=True)),
    "accumulation": (GEN, True, dict(batch_size=4, sm_max_span_length=8, epochs=2,
                                     lr=1e-2, batch_accumulation=2,
                                     sm_supervised_method="gradient-based")),
    "compound_z": (GEN, False, dict(batch_size=6, sm_max_span_length=6, epochs=1, lr=1e-2,
                                    sm_component_model=True, sm_component_embedding_dim=12,
                                    sm_component_z_dim=4, sm_component_z_hidden_dim=12)),
    "predict": (PRED, True, dict(batch_size=5, sm_max_span_length=8, epochs=1)),
}


def fit_job(name, dp):
    split, use_labels, over = FITS[name]
    return dict(args=fit_args(dp, **over), split=split, use_labels=use_labels,
                predict=name == "predict")


def step_inputs(C=5, D=12, B=8, T=40, short=(7, 3), seed=0):
    """A port module's state (means at scale 0.1) and a ragged batch."""
    args = make_sm_args()
    module = TGaussian(args, C, D, allow_self_transitions=True, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        module.gaussian_means.copy_(torch.randn(C, D, generator=gen) * 0.1)
    rng = np.random.RandomState(seed)
    features = rng.randn(B, T, D).astype(np.float32)
    lengths = np.concatenate([np.full(B - len(short), T), [T - s for s in short]]).astype(
        np.int64)
    gt = rng.randint(0, C, size=(B, T)).astype(np.int64)
    arrays = (features, lengths, gt, np.zeros((B, T, C), np.float32),
              np.zeros((B, C), np.float32))
    return args, module, arrays


def single_grads(args, module, arrays, use_labels):
    """One batch's loss and gradients in this process, without ranks."""
    C = module.n_classes
    model = TModel(args, C, module.feature_dim, module, torch.device("cpu"))
    features, lengths, gt, cons, end = (torch.as_tensor(a) for a in arrays)
    vc = torch.arange(C)
    weights = torch.ones(len(lengths))
    module.zero_grad(set_to_none=True)
    loss, _ = model._loss(features, lengths, vc, vc, gt, cons, end, weights,
                          use_labels=use_labels, denom=len(lengths))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in module.named_parameters()}


def resume_args(epochs, ckpt_dir, resume):
    return fit_args(True, batch_size=4, sm_max_span_length=6,
                    sm_supervised_method="gradient-based", epochs=epochs, lr=1e-2,
                    checkpoint_dir=ckpt_dir, checkpoint_every=1, resume=resume,
                    no_reduce_plateau=True)


def jax_carry(jm):
    return gaussian_hsmm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.module.params), "cpu")


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's DP runs on its 8-device mesh and their starting
    parameters: an unsupervised fit of 2 epochs, and a closed-form
    model's predictions."""
    args = make_sm_args(sm_max_span_length=10, batch_size=4, epochs=2, lr=5e-2,
                        data_parallel=True)
    jm = JModel.from_args(args, JSplit(**JAX_SPLIT))
    state = jax_carry(jm)
    losses = []
    jm.fit(JSplit(**JAX_SPLIT), use_labels=False,
           callback_fn=lambda e, s: losses.append(float(s["train_loss"])))
    pargs = make_sm_args(sm_max_span_length=10, batch_size=4, data_parallel=True)
    jp = JModel.from_args(pargs, JSplit(**JAX_SPLIT))
    jp.fit(JSplit(**JAX_SPLIT), use_labels=True)
    return {"fit": (args, state, losses),
            "predict": (pargs, jax_carry(jp), jp.predict(JSplit(**JAX_SPLIT)))}


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    tasks = {task_id: ["stepA", "stepB", "stepC"] for task_id in tc.PRIMARY[:3]}
    root = str(tmp_path_factory.mktemp("dp_release"))
    return tc.write_release(root, tasks, n_train=4, n_val=2)


def cli_argv(root, *extra):
    return tc.argv_for(root, "--classifier", "semimarkov", "--training", "unsupervised",
                       *extra)


def jobs(world, tmp, jax_refs=None, root=None):
    out = {name: ("fit", fit_job(name, True)) for name in FITS}
    args, module, arrays = step_inputs()
    out["grad"] = ("grad_step", dict(args=args, state=module.state_dict(),
                                     arrays=tuple(a[:7] for a in arrays), C=5,
                                     use_labels=True))
    if world != 2:
        return out
    args, module, arrays = step_inputs(T=32, short=(5, 9))
    out["train_kernels"] = ("grad_step", dict(args=args, state=module.state_dict(),
                                              arrays=arrays, C=5, use_labels=False))
    out["decode"] = ("decode_step", dict(args=args, state=module.state_dict(), arrays=arrays,
                                         C=5))
    out["logs"] = ("logged_fit", dict(
        args=fit_args(True, batch_size=4, sm_max_span_length=6, epochs=1, lr=1e-2,
                      print_every=1, sm_supervised_method="gradient-based"), split=LOGS))
    out["resume"] = ("resume", dict(
        full=resume_args(4, os.path.join(tmp, "full"), False),
        part=resume_args(2, os.path.join(tmp, "resumed"), False),
        resumed=resume_args(4, os.path.join(tmp, "resumed"), True), split=RESUME))
    fargs, state, _ = jax_refs["fit"]
    out["jax_fit"] = ("fit", dict(args=fargs, split=JAX_SPLIT, use_labels=False, state=state))
    pargs, pstate, _ = jax_refs["predict"]
    out["jax_predict"] = ("predict", dict(args=pargs, split=JAX_SPLIT, state=pstate))
    out["cli"] = ("cli", dict(argv=cli_argv(root, "--data_parallel", "--model_output_path",
                                            os.path.join(tmp, "models"),
                                            "--prediction_output_path",
                                            os.path.join(tmp, "predictions"))))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_refs, release):
    """{world: [rank 0's results, rank 1's, ...]}."""
    out = {}
    for world in WORLDS:
        tmp = str(tmp_path_factory.mktemp("w{}".format(world)))
        out[world] = tmesh.run_ranks(cases.run, world, jobs(world, tmp, jax_refs, release))
        out[world][0]["tmp"] = tmp
    return out


@pytest.fixture(scope="module")
def singles():
    """The single path's fits, in this process."""
    return {name: cases.fit(**fit_job(name, False)) for name in FITS}


def epoch_losses(result):
    return [stats[0] for _, stats in result["stats"] if stats]


def assert_predictions_equal(got, want):
    assert sorted(got) == sorted(want)
    for video in want:
        np.testing.assert_array_equal(got[video], want[video], err_msg=video)


# ---- the dry run and the entry ----------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    result = graft_entry.dryrun_multichip(n, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    stages = [line for line in lines if line.startswith("dryrun stage")]
    assert len(stages) == 5 and all(" OK" in line for line in stages), lines
    assert all(np.isfinite(v) for v in result["losses"].values()), result
    # the CPU runs the kernels' plain versions: no launch
    assert len(result["launches"]) == n and not any(
        sum(r.values()) for r in result["launches"])


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Without a device the dry run asks for the card and raises without
    one, before it spawns a rank, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_entry_matches_jax():
    """The forward step against JAX's entry on its parameters: rtol 1e-5 /
    atol 1e-4 (tests/test_hsmm_pallas.py's score tolerance)."""
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry("cpu")
    module = args[0]
    module.load_state_dict(gaussian_hsmm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jargs[0]), "cpu"))
    for got, ref in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(fn(*args).numpy(), want, rtol=1e-5, atol=1e-4)


# ---- the fits against the single path (test_parallel.py's tolerances) ------

@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_fit_matches_single_device(ranks, singles, world):
    got, want = epoch_losses(ranks[world][0]["generative"]), epoch_losses(
        singles["generative"])
    assert got[-1] < got[0]
    assert abs(got[0] - want[0]) < 1e-2 and abs(got[-1] - want[-1]) < 0.1, (got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_predict_matches_single_device(ranks, singles, world):
    assert_predictions_equal(ranks[world][0]["predict"]["predictions"],
                             singles["predict"]["predictions"])


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_discriminative_matches_single_device(ranks, singles, world):
    got, want = epoch_losses(ranks[world][0]["discriminative"]), epoch_losses(
        singles["discriminative"])
    assert abs(got[0] - want[0]) < 1e-2, (got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_batch_accumulation_matches_single_device(ranks, singles, world):
    got, want = ranks[world][0]["accumulation"], singles["accumulation"]
    gl, wl = epoch_losses(got), epoch_losses(want)
    assert gl[-1] < gl[0]
    assert abs(gl[0] - wl[0]) < 1e-2 and abs(gl[-1] - wl[-1]) < 0.1, (gl, wl)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=2e-2, atol=2e-3,
                                   err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_fit_compound_z_matches_single_device(ranks, singles, world):
    (_, got), (_, want) = ranks[world][0]["compound_z"]["stats"][0], singles["compound_z"][
        "stats"][0]
    for i, key in enumerate(cases.STAT_KEYS[:3]):
        assert abs(got[i] - want[i]) < 1e-2, (key, got[i], want[i])
    assert want[2] > 1e-4, want  # kl > 0: z was drawn


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_end_every_fit_with_rank0s_parameters(ranks, world):
    """After every fit each rank's parameters are rank 0's (a broadcast and
    torch.equal on each rank, and the returned tensors equal here), and
    every rank reports the same epoch stats."""
    for name in FITS:
        for rank, result in enumerate(ranks[world]):
            assert result[name]["differ"] == [], (name, rank)
            assert cases.tensors_equal(result[name]["params"], ranks[world][0][name]["params"])
            assert result[name]["stats"] == ranks[world][0][name]["stats"], (name, rank)


# ---- one step, the kernels' paths, the log line, resume ---------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grad_step_matches_single_device_grads(ranks, world):
    """One step's loss (rtol 1e-5) and summed gradients (rtol 1e-5 / atol
    1e-6) against the single path's on 7 ragged videos, one padded row."""
    args, module, arrays = step_inputs()
    want_loss, want = single_grads(args, module, tuple(a[:7] for a in arrays), True)
    for loss, grads in (r["grad"] for r in ranks[world]):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_sharded_train_kernels_path(ranks):
    """The unsupervised step through the partition's kernel forward/backward
    (their plain versions on the CPU) over the ranks, against autograd of
    the plain partition in one process: loss rtol 1e-5, gradients rtol 2e-3
    / atol 2e-4."""
    args, module, arrays = step_inputs(T=32, short=(5, 9))
    features, lengths = torch.as_tensor(arrays[0]), torch.as_tensor(arrays[1])
    vc = torch.arange(5)
    pots, log_det, _ = module.compute_potentials(
        features, lengths, vc, torch.as_tensor(arrays[3]), torch.as_tensor(arrays[4]))
    want_loss = -hsmm_partition(pots, lengths).mean() - log_det.mean()
    want_loss.backward()
    loss, grads = ranks[2][0]["train_kernels"]
    np.testing.assert_allclose(loss, want_loss.item(), rtol=1e-5)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_sharded_decode_kernels_path(ranks):
    """The labels chain (K2-max and K3's plain versions on the CPU) over the
    ranks against the traceback Viterbi of ops/hsmm.py in one process:
    labels equal within each length, scores rtol 1e-5 / atol 1e-3."""
    args, module, arrays = step_inputs(T=32, short=(5, 9))
    lengths = torch.as_tensor(arrays[1])
    with torch.no_grad():
        pots, _, _ = module.compute_potentials(
            torch.as_tensor(arrays[0]), lengths, torch.arange(5), torch.as_tensor(arrays[3]),
            torch.as_tensor(arrays[4]))
        spans, want_scores = hsmm_viterbi(pots, lengths)
    want = spans_to_labels(spans).numpy()
    for labels, scores in (r["decode"] for r in ranks[2]):
        np.testing.assert_allclose(scores.numpy(), want_scores.numpy(), rtol=1e-5, atol=1e-3)
        for b, L in enumerate(arrays[1]):
            np.testing.assert_array_equal(labels[b, :L].numpy(), want[b, :L])


def test_data_parallel_logs_grad_norm(ranks):
    """Every rank logs the same |GParam| lines (the global norm, taken after
    the gradients' sum), with a positive norm; the throughput aside."""
    lines = []
    for rank in ranks[2]:
        assert rank["logs"], "no |GParam| training log line under --data_parallel"
        assert float(rank["logs"][0].split("|GParam|: ")[1].split(",")[0]) > 0.0
        lines.append([line.split(", Throughput")[0] for line in rank["logs"]])
    assert lines[0] == lines[1]


def test_data_parallel_checkpoint_resume(ranks):
    """Resumed at epoch 2 of a checkpointed DP fit: epochs 2-3 and the final
    parameters bit for bit the uninterrupted run's; rank 0 alone wrote."""
    full, _, resumed = ranks[2][0]["resume"]
    assert [e for e, _ in resumed["stats"]] == [2, 3], resumed["stats"]
    assert resumed["stats"] == full["stats"][2:]
    assert cases.tensors_equal(resumed["params"], full["params"])
    tmp = ranks[2][0]["tmp"]
    for name in ("full", "resumed"):
        assert checkpoint.latest_step(os.path.join(tmp, name)) == 3


# ---- the JAX package's DP run ----------------------------------------------

def test_data_parallel_epoch_losses_match_jax(ranks, jax_refs):
    """From the same parameters, the port's DP fit at world 2 and the JAX
    package's on its 8-device mesh: epoch losses at rtol 1e-3
    (tests/test_torch_training.py's tolerance after Adam)."""
    _, _, want = jax_refs["fit"]
    got = epoch_losses(ranks[2][0]["jax_fit"])
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_data_parallel_predict_matches_jax(ranks, jax_refs):
    """The JAX closed-form model's parameters decoded by both packages' DP
    predict: labels equal."""
    _, _, want = jax_refs["predict"]
    for rank in ranks[2]:
        assert_predictions_equal(rank["jax_predict"], want)


# ---- main.main, world 1, no group ------------------------------------------

def test_two_rank_main_only_rank0_writes(ranks, release):
    """One --mix_tasks epoch on two ranks: both return the same stats, within
    0.05 of the single run's MoF and F1; rank 0 alone wrote the pickle and
    the prediction files."""
    (stats0, writes0), (stats1, writes1) = (r["cli"] for r in ranks[2])
    assert list(stats0) == list(stats1)
    for split in stats0:
        for task, stats in stats0[split].items():
            assert stats.keys() == stats1[split][task].keys()
            for key, value in stats.items():
                np.testing.assert_array_equal(value, stats1[split][task][key])
    assert writes0["pickles"] > 0 and writes0["predictions"] > 0
    assert writes1 == {"pickles": 0, "predictions": 0}
    tmp = ranks[2][0]["tmp"]
    assert os.path.exists(os.path.join(tmp, "models", "all.pkl"))
    assert len(os.listdir(os.path.join(tmp, "predictions"))) == 3 * 2
    single = cases.seeded_main(cli_argv(release))
    for task, want in single["all"].items():
        for key in ("mof", "f1"):
            a, b = stats0["all"][task][key], want[key]
            assert abs(a[0] / a[1] - b[0] / b[1]) < 0.05, (task, key, a, b)


@pytest.mark.parametrize("name", ["generative", "compound_z", "predict"])
def test_world_one_is_bit_equal_to_single(singles, name):
    """A gloo group of one in this process: the DP fit's epoch stats,
    parameters and predictions equal the single path's bit for bit."""
    with cases.process_group("gloo") as mesh:
        assert mesh.world == 1
        job = fit_job(name, True)
        job["predict"] = True
        got = cases.fit(mesh=mesh, **job)
    want = singles[name] if name == "predict" else cases.fit(**{**fit_job(name, False),
                                                                "predict": True})
    assert got["stats"] == want["stats"]
    assert cases.tensors_equal(got["params"], want["params"])
    assert_predictions_equal(got["predictions"], want["predictions"])


def test_no_group_one_device_takes_single_path(monkeypatch, caplog):
    with caplog.at_level(logging.DEBUG, logger="action_segmentation_torch"):
        assert tmesh.data_parallel_mesh(torch.device("cpu")) == tmesh.single_mesh("cpu")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        mesh = tmesh.data_parallel_mesh(torch.device("cuda"))
        assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    assert any("the single path" in r.getMessage() for r in caplog.records)


def test_no_group_several_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        tmesh.data_parallel_mesh(torch.device("cuda"))
    train = TSplit(num_videos=4, n_classes=3, max_len=10, span_k=3)
    model = TModel.from_args(fit_args(True, sm_supervised_method="gradient-based"), train,
                             device="cpu")
    model.device = torch.device("cuda")  # as a model on a card of two
    with pytest.raises(RuntimeError, match="torchrun"):
        model.fit(train, use_labels=True)


def test_make_mesh_raises():
    with pytest.raises(NotImplementedError, match="retired"):
        tmesh.make_mesh(model_parallel=2)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh()
    with cases.process_group("gloo"):
        with pytest.raises(RuntimeError, match="requested 2 ranks"):
            tmesh.make_mesh(2)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """Under torchrun's environment with no device given, make_mesh asks
    for cuda:LOCAL_RANK and raises without a card, as resolve_device does,
    before it joins a group; a CPU rank passes device="cpu"."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                           MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh(1, device="cpu")
        assert (mesh.world, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_pickled_model_loads_on_one_process(tmp_path):
    """A model fitted under a group pickles without it and decodes alone."""
    job = fit_job("predict", True)
    train = TSplit(**job["split"])
    with cases.process_group("gloo"):
        model = TModel.from_args(job["args"], train, device="cpu")
        model.fit(train, use_labels=True)
        want = model.predict(train)
        checkpoint.save_pickle(model, str(tmp_path / "m.pkl"))
    loaded = checkpoint.load_pickle(str(tmp_path / "m.pkl"), device="cpu")
    assert_predictions_equal(loaded.predict(train), want)


@pytest.mark.parametrize("B,pad_to,world", [(6, 6, 4), (1, 6, 4), (5, 5, 3), (7, None, 2)])
def test_pad_batch_for_mesh_matches_jax(B, pad_to, world):
    """JAX's padding exactly, and shard_rows splits it in rank order."""
    rng = np.random.RandomState(B)
    arrays = [rng.randn(B, 3).astype(np.float32), np.arange(1, B + 1)]
    got, got_w = tmesh.pad_batch_for_mesh(tmesh.Mesh(None, 0, world, "cpu"), arrays, B, pad_to)
    want, want_w = jmesh.pad_batch_for_mesh(argparse.Namespace(shape={"data": world}),
                                            arrays, B, pad_to)
    np.testing.assert_array_equal(got_w, want_w)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rows = [tmesh.shard_rows(tmesh.Mesh(None, r, world, "cpu"), got[0]) for r in range(world)]
    np.testing.assert_array_equal(np.concatenate(rows), got[0])
