"""The port's command line against the JAX package's.

``action_segmentation_torch.main`` on the CPU (``device="cpu"``) against
``action_segmentation_tpu.main`` on the same files: the parser (option
strings, defaults, choices, for all eight classifiers), ``main.main`` on
the all-18-task CrossTask fixture of the JAX package's CLI tests (the
default per-task loop and the cross-validation split; stats equal,
numerators and denominators, since every decoded label is equal here),
the model round trip, the prediction files (the same bytes), the
comparison folder in its three layouts, ``pca_and_serialize_features``
(rtol 1e-5), ``path_logger``, a ``--profile_dir`` trace, and each
baseline classifier fitting on the CPU (``test_torch_baselines.py``
holds them against the JAX package).
"""

import functools
import json
import logging
import os

import numpy as np
import pytest
import torch

from action_segmentation_torch import main as tmain
from action_segmentation_torch.data import breakfast as tbf
from action_segmentation_torch.data import crosstask as tct
from action_segmentation_torch.data import minigen as tgen
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.utils import logger as tlogger
from action_segmentation_torch.utils import path_logger
from action_segmentation_tpu import main as jmain
from action_segmentation_tpu.data import breakfast as jbf
from action_segmentation_tpu.data import crosstask as jct
from tests.conftest import make_sm_args
from tests.test_driver_paths import _argv, _write_full_release

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def full_crosstask(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    _write_full_release(root, np.random.RandomState(0))
    return root


@pytest.fixture(autouse=True)
def seeded_f1(monkeypatch):
    """F1 samples frames from numpy's global stream: every test() call of
    either package starts it from the same seed, so runs that consumed
    the stream differently before it (training, a JAX run before a port
    run) draw the same samples."""
    for mod in (tmain, jmain):
        def seeded(*args, _test=mod.test, **kwargs):
            np.random.seed(0)
            return _test(*args, **kwargs)
        monkeypatch.setattr(mod, "test", seeded)


def assert_stats_equal(got, want):
    assert got.keys() == want.keys()
    for split in want:
        assert got[split].keys() == want[split].keys(), split
        for task in want[split]:
            g, w = got[split][task], want[split][task]
            assert g.keys() == w.keys(), (split, task)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]),
                                              err_msg="{} {} {}".format(split, task, key))


def option_table(parser):
    return {
        s: (a.dest, a.default, a.choices, a.nargs, a.type, a.const, type(a).__name__,
            a.required)
        for a in parser._actions for s in a.option_strings
    }


def test_parser_option_strings_match_jax():
    got, want = option_table(tmain.build_parser()), option_table(jmain.build_parser())
    assert sorted(got) == sorted(want)
    for option in want:
        assert got[option] == want[option], option
    assert tmain.CLASSIFIERS.keys() == jmain.CLASSIFIERS.keys()
    assert (tmain.STAT_KEYS, tmain.DISPLAY_STAT_KEYS) == (jmain.STAT_KEYS,
                                                          jmain.DISPLAY_STAT_KEYS)


@pytest.mark.parametrize("classifier", sorted(jmain.CLASSIFIERS))
def test_parser_defaults_match_jax(classifier):
    argv = ["--classifier", classifier]
    assert vars(tmain.build_parser().parse_args(argv)) == vars(
        jmain.build_parser().parse_args(argv))


@pytest.mark.parametrize("classifier", sorted(set(jmain.CLASSIFIERS) - {"semimarkov"}))
def test_baseline_classifier_fits_on_cpu(full_crosstask, classifier):
    """Each baseline builds on the CPU from the command line's args, fits
    one epoch and labels every test video within its task's classes."""
    argv = _argv(full_crosstask, ["--mix_tasks", "--framewise_baseline_type", "majority_class",
                                  "--seq_hidden_size", "8", "--seq_num_layers", "1"])
    argv[argv.index("semimarkov")] = classifier
    args = tmain.build_parser().parse_args(argv)
    train, _, test = next(iter(tmain.make_data_splits(args).values()))
    model = tmain.CLASSIFIERS[classifier].from_args(args, train, device=CPU)
    assert model.device == CPU
    model.fit(train, use_labels=True)
    predictions = model.predict(test)
    assert sorted(predictions) == sorted(n for _, n in test._tasks_and_video_names)
    for task, name in test._tasks_and_video_names:
        sample = test[(task, name)]
        pred = np.asarray(predictions[name])
        assert pred.shape == sample["gt_single"].shape, name
        assert np.isin(pred, sample["task_indices"]).all(), name


def test_model_parallel_raises():
    train = TSplit(num_videos=4, n_classes=3, max_len=10, span_k=3)
    args = make_sm_args(sm_supervised_method="gradient-based", model_parallel=2)
    model = TModel.from_args(args, train, device=CPU)
    with pytest.raises(NotImplementedError, match="data_parallel"):
        model.fit(train, use_labels=True)


def test_default_per_task_loop_matches_jax(full_crosstask):
    """One closed-form model per primary task, the default loop."""
    argv = _argv(full_crosstask, [])
    got = tmain.main(argv, device="cpu")
    want = jmain.main(argv)
    assert set(got) == {"{}_val".format(t) for t in tct.CrosstaskCorpus.TASK_IDS_BY_SET[
        "primary"]}
    assert_stats_equal(got, want)


def test_cross_validation_split_matches_jax(full_crosstask, monkeypatch):
    # the cv split takes 30 train videos per task; shrink for the
    # 4-video fixture, in both packages
    for mod in (tct, jct):
        monkeypatch.setattr(mod, "load_videos_by_task",
                            functools.partial(mod.load_videos_by_task, cv_n_train=2))
    argv = _argv(full_crosstask, ["--crosstask_cross_validation",
                                  "--crosstask_cross_validation_seed", "2", "--mix_tasks"])
    got = tmain.main(argv, device="cpu")
    want = jmain.main(argv)
    assert list(got) == ["all"]
    assert_stats_equal(got, want)


def test_model_round_trip(full_crosstask, tmp_path, capsys):
    """A gradient-trained run (per-epoch dev decode, best-dev-MoF pick,
    the every-5-epochs pickle) writes one model per split; decoding from
    them gives the same stats and prints the args-differ warning."""
    out = str(tmp_path / "models")
    extra = ["--sm_supervised_method", "gradient-based", "--epochs", "2",
             "--task_specific_steps", "--mix_tasks"]
    trained = tmain.main(_argv(full_crosstask, extra + ["--model_output_path", out]),
                         device="cpu")
    assert sorted(os.listdir(out)) == ["all.pkl", "all_epoch-0.pkl"]
    capsys.readouterr()
    decoded = tmain.main(_argv(full_crosstask, extra + ["--model_input_path", out]),
                         device="cpu")
    printed = capsys.readouterr().out
    assert "warning: command line args and serialized model args differ:" in printed
    assert "model_input_path" not in printed.split("differ:")[1].split("setting")[0]
    assert_stats_equal(decoded, trained)


def _val_splits(root):
    argv = _argv(root, ["--mix_tasks"])
    return [
        next(iter(mod.make_data_splits(mod.build_parser().parse_args(argv)).values()))[2]
        for mod in (tmain, jmain)
    ]


def test_write_predictions_matches_jax_bytes(full_crosstask, tmp_path):
    tval, jval = _val_splits(full_crosstask)
    rng = np.random.RandomState(0)
    preds = {}
    for task, name in tval._tasks_and_video_names:
        classes = tval[(task, name)]["task_indices"]
        preds[name] = rng.choice(classes, size=len(tval[(task, name)]["gt_single"]))
    tmain.write_predictions(tval, preds, str(tmp_path / "t"))
    jmain.write_predictions(jval, preds, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(preds) and sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def _write_comparison(folder, datasplit, layout, rng):
    """A prior run's exports: y_true one-hots of each frame's gt column
    among the task's classes, y_pred one-hots mostly equal to it."""
    os.makedirs(folder, exist_ok=True)
    bulk = {"y_true": {}, "y_pred": {}}
    for task, name in datasplit._tasks_and_video_names:
        sample = datasplit[(task, name)]
        classes = list(sample["task_indices"])
        cols = np.array([classes.index(g) for g in sample["gt_single"]])
        noisy = np.where(rng.rand(len(cols)) < 0.7, cols, rng.randint(0, len(classes),
                                                                      len(cols)))
        y_true, y_pred = np.eye(len(classes))[cols], np.eye(len(classes))[noisy]
        if layout == "bulk":
            bulk["y_true"].setdefault(str(task), {})[name] = y_true.tolist()
            bulk["y_pred"].setdefault(str(task), {})[name] = y_pred.tolist()
        elif layout == "npy":
            np.save(os.path.join(folder, "{}_y_true.npy".format(name)), y_true)
            np.save(os.path.join(folder, "{}_y_pred.npy".format(name)), y_pred)
        else:
            with open(os.path.join(folder, "{}.json".format(name)), "w") as f:
                json.dump({"y_true": y_true.tolist(), "y_pred": y_pred.tolist()}, f)
    if layout == "bulk":
        for key, value in bulk.items():
            with open(os.path.join(folder, "{}.json".format(key)), "w") as f:
                json.dump(value, f)


@pytest.mark.parametrize("layout", ["bulk", "npy", "json"])
def test_compare_to_prediction_folder_matches_jax(full_crosstask, tmp_path, layout):
    tval, _ = _val_splits(full_crosstask)
    folder = str(tmp_path / "exports")
    _write_comparison(folder, tval, layout, np.random.RandomState(1))
    argv = _argv(full_crosstask, ["--mix_tasks", "--compare_only",
                                  "--compare_to_prediction_folder", folder])
    got = tmain.main(argv, device="cpu")
    want = jmain.main(argv)
    assert_stats_equal(got, want)
    keys = set(next(iter(got["all"].values())))
    assert {"comparison_mof", "comparison_f1", "comparison_center_step_recall_non_bg"} <= keys
    mofs = [s["comparison_mof"][0] / s["comparison_mof"][1] for s in got["all"].values()]
    assert 0.5 < np.mean(mofs) < 1.0


@pytest.fixture(scope="module")
def raw_release(tmp_path_factory):
    """The minigen CrossTask release (the 18 primary tasks, two steps
    each) with 3200-wide raw features of rank six beside its PCA dirs, and the
    minigen Breakfast release; returns (crosstask dirs, breakfast dirs)."""
    root = str(tmp_path_factory.mktemp("raw"))
    rng = np.random.RandomState(0)
    tasks = {task_id: ["step0", "step1"]
             for task_id in tct.CrosstaskCorpus.TASK_IDS_BY_SET["primary"]}
    tgen.write_mini_crosstask(root, rng, tasks=tasks, related_tasks={}, n_train=2, n_val=1)
    tgen.write_mini_breakfast(root, rng)
    ct = os.path.join(root, "crosstask")
    pca_root = os.path.join(ct, "crosstask_processed",
                            "crosstask_primary_pca-200_with-bkg_by-task")
    raw_root = os.path.join(ct, "crosstask_features")
    os.makedirs(raw_root)
    # six directions of well-apart variances and a little noise: the top
    # components are well conditioned, so two float32 SVDs agree on them
    basis = rng.randn(6, 3200)
    scales = np.array([8.0, 6.0, 4.5, 3.0, 2.0, 1.0])
    for fname in sorted(os.listdir(os.path.join(pca_root, "i3d"))):
        T = np.load(os.path.join(pca_root, "i3d", fname)).shape[0]
        raw = (rng.randn(T, 6) * scales) @ basis + 0.01 * rng.randn(T, 3200)
        np.save(os.path.join(raw_root, fname), raw.astype(np.float32))
    bdir = os.path.join(root, "breakfast")
    return ((os.path.join(ct, "crosstask_release"), raw_root,
             os.path.join(ct, "crosstask_constraints")),
            (os.path.join(bdir, "mapping.txt"), os.path.join(bdir, "reduced_fv_64"),
             os.path.join(bdir, "BreakfastII_15fps_qvga_sync")))


def test_pca_and_serialize_features_match_jax(raw_release, tmp_path):
    """CrossTask (per task, the three feature groups) and Breakfast (the
    minigen release's fisher vectors): the port's .npy files within rtol
    1e-5 of JAX's, relative to each entry and, for entries near zero, to
    the file's largest (two float32 SVDs round a projection by the size
    of its inputs, not of each output)."""
    ct, bf = raw_release
    outs = {}
    for name, ct_mod, bf_mod, kw in (("t", tct, tbf, {"device": "cpu"}), ("j", jct, jbf, {})):
        out = str(tmp_path / name)
        ct_mod.pca_and_serialize_features(
            ct[0], ct[1], os.path.join(out, "ct"), ct[2], False, pca_components_per_group=4,
            task_sets=["primary"], **kw)
        bf_mod.pca_and_serialize_features(*bf, os.path.join(out, "bf"), False,
                                          pca_components_per_group=3,
                                          task_ids=list(tgen.BREAKFAST_TASKS), **kw)
        outs[name] = out
    files = sorted(os.path.relpath(os.path.join(d, f), outs["j"])
                   for d, _, fs in os.walk(outs["j"]) for f in fs)
    assert len(files) > 20 and {f.split(os.sep)[1] for f in files} == {
        "i3d", "resnet", "audio", "reduced_64"}
    for rel in files:
        got, want = (np.load(os.path.join(outs[k], rel)) for k in ("t", "j"))
        assert got.shape == want.shape and got.shape[1] in (3, 4), rel
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                   err_msg=rel)


def test_datasets_by_task_match_jax(raw_release):
    ct, bf = raw_release
    got = tct.datasets_by_task(*ct, False, task_sets=["primary"], split="all")
    want = jct.datasets_by_task(*ct, False, task_sets=["primary"], split="all")
    assert got.keys() == want.keys() == set(tct.CrosstaskCorpus.TASK_IDS_BY_SET["primary"])
    for task in want:
        assert got[task]._tasks_and_video_names == want[task]._tasks_and_video_names
    tasks = list(tgen.BREAKFAST_TASKS)
    got = tbf.datasets_by_task(*bf, False, task_ids=tasks)
    want = jbf.datasets_by_task(*bf, False, task_ids=tasks)
    assert list(got) == list(want) == tasks
    for task in want:
        assert got[task]._tasks_and_video_names == want[task]._tasks_and_video_names


def test_path_logger(tmp_path):
    first, second = str(tmp_path / "a.log"), str(tmp_path / "b.log")
    assert path_logger(first) is tlogger
    tlogger.debug("one")
    path_logger(second)  # replaces the first file handler
    tlogger.debug("two")
    files = [h for h in tlogger.handlers if isinstance(h, logging.FileHandler)]
    assert len(files) == 1
    for h in files:
        tlogger.removeHandler(h)
        h.close()
    assert open(first).read() == "one\n" and open(second).read() == "two\n"


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile_dir traces the first epoch run (after a resume, the
    resumed one) into one Chrome trace."""
    train = TSplit(num_videos=8, n_classes=3, max_len=20, span_k=4)
    trace_dir = str(tmp_path / "trace")
    args = make_sm_args(sm_max_span_length=8, sm_supervised_method="gradient-based",
                        epochs=2, profile_dir=trace_dir)
    TModel.from_args(args, train, device=CPU).fit(train, use_labels=True)
    assert os.listdir(trace_dir) == ["epoch_0.pt.trace.json"]
    with open(os.path.join(trace_dir, "epoch_0.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("backward" in str(e.get("name", "")).lower() for e in events)
