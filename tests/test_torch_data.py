"""The port's data path against the JAX package's.

Both packages read the same miniature on-disk CrossTask and Breakfast
releases (written by each package's ``minigen`` from one seed), so every
datasplit field is compared for equality: features, labels with and
without background, task indices, narration constraints, the canonical
orderings and their allowed starts, transitions and ends. PCA is held to
tests/test_features_pca.py's tolerance (rtol 1e-2 / atol 1e-2 on the
projection, atol 1e-4 on the explained-variance ratio: two float32 SVDs);
the metrics (F1, ``accuracy_corpus``) must be equal.
"""

import argparse
import filecmp
import os

import numpy as np
import pytest

from action_segmentation_torch import main as tmain
from action_segmentation_torch.data import batching as tb
from action_segmentation_torch.data import breakfast as tbf
from action_segmentation_torch.data import crosstask as tct
from action_segmentation_torch.data import features as tfeat
from action_segmentation_torch.data import minigen as tgen
from action_segmentation_torch.evaluation.f1 import F1Score as TF1
from action_segmentation_tpu import main as jmain
from action_segmentation_tpu.data import batching as jb
from action_segmentation_tpu.data import breakfast as jbf
from action_segmentation_tpu.data import crosstask as jct
from action_segmentation_tpu.data import features as jfeat
from action_segmentation_tpu.data import minigen as jgen
from action_segmentation_tpu.evaluation.f1 import F1Score as JF1


# every primary CrossTask task (the per-task splits build all 18), with
# two or three steps each
PRIMARY = {
    task_id: ["step{}".format(i) for i in range(2 + ix % 2)]
    for ix, task_id in enumerate(tct.CrosstaskCorpus.TASK_IDS_BY_SET["primary"])
}


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    """One CrossTask release (the 18 primary tasks and a related one) and
    one Breakfast layout, written by the port's minigen."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.RandomState(0)
    tgen.write_mini_crosstask(root, rng, tasks=PRIMARY, n_train=3, n_val=2)
    tgen.write_mini_breakfast(root, rng)
    return root


def tree_files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def test_minigen_writes_the_same_bytes(tmp_path):
    """With the same RandomState both writers write byte-identical files
    and return the same labels."""
    for kw in (dict(), dict(n_train=2, n_val=1, dim_per_group=7, bkg_range=(3, 9))):
        a, b = str(tmp_path / "jax"), str(tmp_path / "port")
        want = jgen.write_mini_crosstask(a, np.random.RandomState(4), **kw)
        got = tgen.write_mini_crosstask(b, np.random.RandomState(4), **kw)
        assert want.keys() == got.keys()
        for v in want:
            np.testing.assert_array_equal(got[v], want[v])
        assert jgen.write_mini_breakfast(a, np.random.RandomState(5)).endswith("breakfast")
        tgen.write_mini_breakfast(b, np.random.RandomState(5))
        files = tree_files(a)
        assert files == tree_files(b) and len(files) > 40
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
        for d in (a, b):
            for f in tree_files(d):
                os.remove(os.path.join(d, f))


def data_args(parse_into, argv):
    parser = argparse.ArgumentParser()
    parse_into(parser)
    return parser.parse_args(argv)


def jax_args(argv):
    def add(parser):
        jmain.add_data_args(parser)
        jmain.add_misc_args(parser)

    return data_args(add, argv)


def assert_samples_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def assert_datasplits_equal(got, want, constrained=True):
    assert got._tasks_and_video_names == want._tasks_and_video_names
    assert got._K_by_task == want._K_by_task
    corpus, jcorpus = got.corpus, want.corpus
    assert corpus.label2index == jcorpus.label2index
    assert corpus._background_indices == jcorpus._background_indices
    assert corpus._indices_by_task == jcorpus._indices_by_task
    assert corpus.label_indices2component_indices == jcorpus.label_indices2component_indices
    assert got.feature_dim == want.feature_dim
    for key in want._tasks_and_video_names:
        assert_samples_equal(got[key], want[key])
        assert got.approx_length(key) == want.approx_length(key)
    if constrained:
        assert (got.get_ordered_indices_no_background()
                == want.get_ordered_indices_no_background())
        assert (got.get_allowed_starts_and_transitions()
                == want.get_allowed_starts_and_transitions())


CROSSTASK_FLAGS = [
    [],
    ["--annotate_background_with_previous"],
    ["--remove_background"],
    ["--annotate_background_with_previous", "--remove_background", "--mix_tasks"],
    ["--mix_tasks", "--crosstask_training_data", "primary", "related",
     "--crosstask_feature_groups", "i3d", "audio"],
]


@pytest.mark.parametrize("flags", CROSSTASK_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_crosstask_splits_match_jax(mini_root, flags):
    argv = ["--dataset", "crosstask", "--data_root", mini_root, "--features", "pca",
            "--pca_components_per_group", str(tgen.DIM_PER_GROUP),
            "--task_specific_steps", *flags]
    want = jmain.make_data_splits(jax_args(argv))
    got = tmain.make_data_splits(data_args(tmain.add_data_args, argv))
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == 3
        for g, w in zip(got[name], want[name]):
            assert_datasplits_equal(g, w)


@pytest.mark.parametrize("remove_background", [False, True])
def test_breakfast_splits_match_jax(mini_root, remove_background):
    argv = ["--dataset", "breakfast", "--data_root", mini_root, "--features", "raw"]
    if remove_background:
        argv.append("--remove_background")
    want = jmain.make_data_splits(jax_args(argv))
    got = tmain.make_data_splits(data_args(tmain.add_data_args, argv))
    assert list(got) == list(want) == ["s1", "s2", "s3", "s4"]
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert_datasplits_equal(g, w, constrained=False)


def test_batches_with_constraints_and_workers_match_jax(mini_root):
    """Collated batches (narration matrices included, one video's matrix
    missing) and the --workers prefetch give JAX's batches in JAX's order."""
    argv = ["--dataset", "crosstask", "--data_root", mini_root, "--features", "pca",
            "--pca_components_per_group", str(tgen.DIM_PER_GROUP),
            "--task_specific_steps", "--mix_tasks"]
    jtrain = jmain.make_data_splits(jax_args(argv))["all"][0]
    ttrain = tmain.make_data_splits(data_args(tmain.add_data_args, argv))["all"][0]
    for split in (jtrain, ttrain):  # mixed coverage within a batch
        task, video = split._tasks_and_video_names[0]
        split.videos_by_task[task][video]._constraints = None
    kw = dict(batch_size=3, batch_by_task=True, shuffle=True, seed=3)
    want = list(jb.iter_batches(jtrain, **kw))
    for workers in (0, 2):
        ttrain.loader_workers = workers
        got = list(tb.iter_batches(ttrain, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and "constraints" in w
            for k in ("features", "gt_single", "constraints", "lengths"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["video_name"] == w["video_name"] and g["gt"] == w["gt"]


def test_extract_feature_groups_match_jax(mini_root):
    """CrossTask's i3d/resnet/audio column groups from raw features, and
    Breakfast's reduced_64 group."""
    release = os.path.join(mini_root, "crosstask", "crosstask_release")
    pca_root = os.path.join(mini_root, "crosstask", "crosstask_processed",
                            "crosstask_primary_pca-200_with-bkg_by-task")
    raw_root = os.path.join(mini_root, "crosstask", "raw_wide")
    os.makedirs(raw_root, exist_ok=True)
    rng = np.random.RandomState(9)
    for fname in os.listdir(os.path.join(pca_root, "i3d")):
        T = np.load(os.path.join(pca_root, "i3d", fname)).shape[0]
        np.save(os.path.join(raw_root, fname), rng.randn(T, 3200).astype(np.float32))
    splits = [
        pkg.CrosstaskCorpus(release, raw_root).get_datasplit(
            False, task_sets=["primary"], split="val")
        for pkg in (jct, tct)
    ]
    want, got = jct.extract_feature_groups(splits[0]), tct.extract_feature_groups(splits[1])
    assert got.keys() == want.keys() == {"i3d", "resnet", "audio"}
    for group in want:
        assert got[group].keys() == want[group].keys()
        for v in want[group]:
            np.testing.assert_array_equal(got[group][v], want[group][v])
    bdir = os.path.join(mini_root, "breakfast")
    corpora = [
        pkg.BreakfastCorpus(os.path.join(bdir, "mapping.txt"),
                            os.path.join(bdir, "reduced_fv_64"),
                            os.path.join(bdir, "BreakfastII_15fps_qvga_sync"))
        for pkg in (jbf, tbf)
    ]
    want = jbf.extract_feature_groups(corpora[0].get_datasplit(False, splits=["s2"]))
    got = tbf.extract_feature_groups(corpora[1].get_datasplit(False, splits=["s2"]))
    for v in want["reduced_64"]:
        np.testing.assert_array_equal(got["reduced_64"][v], want["reduced_64"][v])


def test_pca_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(500, 20).astype(np.float32) @ rng.randn(20, 20).astype(np.float32)
    want, got = jfeat.fit_pca(X, 5), tfeat.fit_pca(X, 5, device="cpu")
    np.testing.assert_allclose(got.transform(X[:50]), want.transform(X[:50]),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.explained_variance_ratio_,
                               want.explained_variance_ratio_, atol=1e-4)
    np.testing.assert_allclose(got.mean_, want.mean_)
    grouped = {
        "a": {"v1": rng.randn(30, 8).astype(np.float32), "v2": rng.randn(20, 8).astype(np.float32)},
        "b": {"v1": rng.randn(30, 6).astype(np.float32), "v2": rng.randn(20, 6).astype(np.float32)},
    }
    want_t, _ = jfeat.grouped_pca(grouped, 4)
    got_t, models = tfeat.grouped_pca(grouped, 4, device="cpu")
    again, _ = tfeat.grouped_pca(grouped, 4, pca_models_by_group=models)
    for g in grouped:
        for v in grouped[g]:
            np.testing.assert_allclose(got_t[g][v], want_t[g][v], rtol=1e-2, atol=1e-2)
            np.testing.assert_array_equal(again[g][v], got_t[g][v])
    merged, jmerged = tfeat.merge_grouped(got_t), jfeat.merge_grouped(got_t)
    for v in jmerged:
        np.testing.assert_array_equal(merged[v], jmerged[v])


def test_f1_matches_jax():
    """The same sampling stream gives the same F1, precision and recall,
    the final-segment quirk included."""
    rng = np.random.RandomState(2)
    gt = np.repeat(rng.randint(0, 4, 40), rng.randint(1, 9, 40))
    pr = np.where(rng.rand(len(gt)) < 0.8, gt, rng.randint(0, 4, len(gt)))
    stats = []
    for cls in (JF1, TF1):
        np.random.seed(0)
        f1 = cls(K=4, n_videos=3, verbose=False)
        f1.set_gt([[int(x)] for x in gt])
        f1.set_pr(pr)
        f1.set_gt2pr({c: [c] for c in range(4)})
        f1.f1()
        stats.append((f1.stat(), f1.bound_masks))
    assert stats[0] == stats[1]
    # the final segment is dropped from the bounds
    assert stats[1][1][-1][1] < len(gt) - 1


def test_accuracy_corpus_matches_jax(mini_root):
    """Per-task Accuracy + F1 through each package's datasplit, on the same
    noisy predictions: every stat equal, the merged backgrounds
    canonicalized."""
    argv = ["--dataset", "crosstask", "--data_root", mini_root, "--features", "pca",
            "--pca_components_per_group", str(tgen.DIM_PER_GROUP), "--task_specific_steps",
            "--annotate_background_with_previous", "--mix_tasks"]
    jval = jmain.make_data_splits(jax_args(argv))["all"][2]
    tval = tmain.make_data_splits(data_args(tmain.add_data_args, argv))["all"][2]
    rng = np.random.RandomState(1)
    preds = {}
    for task, video in jval._tasks_and_video_names:
        gt = np.asarray(jval[(task, video)]["gt_single"])
        noise = rng.choice(jval.corpus.indices_by_task(task), len(gt))
        preds[video] = np.where(rng.rand(len(gt)) < 0.7, gt, noise)
    out = []
    for split in (jval, tval):
        np.random.seed(0)
        out.append(split.accuracy_corpus(False, lambda v: preds[v.name], verbose=False))
    want, got = out
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k in want[task]:
            np.testing.assert_array_equal(np.asarray(got[task][k]), np.asarray(want[task][k]),
                                          err_msg="{} {}".format(task, k))
    assert tval.return_stat.keys() == jval.return_stat.keys()
