"""The decode slice end to end against the JAX package.

Mirrors tests/test_semimarkov_model.py and tests/test_api.py: synthetic
corpus, closed-form fit, predict, Accuracy, Segmenter.segment_many — the
same seeds through both packages. Tolerances: fitted parameters rtol 1e-5
(both fits are numpy; only the float32 casts could differ); labels and
metric values equal.
"""

import jax
import numpy as np
import pytest
import torch

from action_segmentation_torch.api import Segmenter as TSegmenter
from action_segmentation_torch.bridge import gaussian_hsmm_params_from_numpy
from action_segmentation_torch.data import batching as tb
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.evaluation import editdistance as ted
from action_segmentation_torch.evaluation.accuracy import Accuracy as TAccuracy
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.ops.stats import semimarkov_sufficient_stats as tstats
from action_segmentation_torch.utils.drain import DeferredLabelDrain
from action_segmentation_tpu.api import Segmenter as JSegmenter
from action_segmentation_tpu.data import batching as jb
from action_segmentation_tpu.data.resident import pad_class_width as j_pad_class_width
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.evaluation import editdistance as jed
from action_segmentation_tpu.evaluation.accuracy import Accuracy as JAccuracy
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from action_segmentation_tpu.ops.stats import semimarkov_sufficient_stats as jstats
from tests.conftest import make_sm_args

SPLIT = dict(n_classes=3, max_len=40, span_k=5)


def splits(cls, train_seed=0, test_seed=1, n_train=40, n_test=12, **kw):
    kw = {**SPLIT, **kw}
    return (cls(num_videos=n_train, seed=train_seed, **kw),
            cls(num_videos=n_test, seed=test_seed, **kw))


def fitted(args, **kw):
    """(JAX model, port model, test splits) after a closed-form fit."""
    jtrain, jtest = splits(JSplit, **kw)
    ttrain, ttest = splits(TSplit, **kw)
    jm = JModel.from_args(args, jtrain)
    jm.fit(jtrain, use_labels=True)
    tm = TModel.from_args(args, ttrain, device="cpu")
    tm.fit(ttrain, use_labels=True)
    return jm, tm, jtest, ttest


@pytest.fixture(scope="module")
def closed_form():
    args = make_sm_args(sm_max_span_length=20, sm_supervised_method="closed-form")
    return fitted(args)


def test_synthetic_arrays_identical():
    for kw in (dict(), dict(n_classes=19, max_len=60, span_k=20, feature_dim=30, shift=2.0)):
        (ja, jb_), (ta, tb_) = splits(JSplit, **kw), splits(TSplit, **kw)
        for j, t in ((ja, ta), (jb_, tb_)):
            assert j.videos_by_task == t.videos_by_task
            for name in j._samples:
                js, ts = j._samples[name], t._samples[name]
                np.testing.assert_array_equal(js["features"], ts["features"])
                np.testing.assert_array_equal(js["gt_single"], ts["gt_single"])
                assert js["gt"] == ts["gt"]


def test_closed_form_params_match_jax(closed_form):
    jm, tm, _, _ = closed_form
    want = jax.tree_util.tree_map(np.asarray, jm.module.params)
    got = tm.module.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)


def accuracy_stats(acc_cls, datasplit, predictions):
    acc = acc_cls(verbose=False, corpus=datasplit.corpus)
    for name in sorted(predictions):
        acc.add_gt_labels(datasplit[(datasplit.task, name)]["gt"])
        acc.add_predicted_labels(predictions[name])
    acc.mof(optimal_assignment=False)
    acc.mof_classes()
    acc.iou_classes()
    acc.levenshtein()
    np.random.seed(0)
    acc.single_step_recall()
    return acc.mof_val(), acc.stat()


def test_predict_and_accuracy_match_jax(closed_form):
    jm, tm, jtest, ttest = closed_form
    want = jm.predict(jtest)
    got = tm.predict(ttest)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    mof_j, stat_j = accuracy_stats(JAccuracy, jtest, want)
    mof_t, stat_t = accuracy_stats(TAccuracy, ttest, got)
    assert mof_t == mof_j and mof_t > 0.75, (mof_t, mof_j)
    assert set(stat_t) == set(stat_j)
    for k in stat_j:
        np.testing.assert_array_equal(np.asarray(stat_t[k]), np.asarray(stat_j[k]), err_msg=k)


@pytest.mark.parametrize("valid_classes", [None, [0, 2]])
def test_segment_many_matches_jax(closed_form, valid_classes):
    """Mixed lengths over several pad buckets and a partial final batch;
    all classes, and a subset (labels are global class ids)."""
    jm, tm, _, ttest = closed_form
    rng = np.random.RandomState(3)
    feats = []
    for name in sorted(ttest._samples):
        f = ttest._samples[name]["features"]
        feats.append(f[: rng.randint(min(8, f.shape[0]), f.shape[0] + 1)])
    want = JSegmenter(jm, valid_classes=valid_classes).segment_many(feats, batch_size=5)
    seg = TSegmenter(tm, valid_classes=valid_classes)
    got = seg.segment_many(feats, batch_size=5)
    if valid_classes is not None:
        assert set(np.concatenate(got).tolist()) <= set(valid_classes)
    assert len(got) == len(feats)
    for f, g, w in zip(feats, got, want):
        assert g.shape == (f.shape[0],)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(seg.segment(feats[0]), got[0])


def test_bridge_loads_jax_params_and_decodes_the_same(closed_form):
    """JAX weights carried into a port model that never fitted: the
    decode matches the JAX model's."""
    jm, _, jtest, ttest = closed_form
    params = jax.tree_util.tree_map(np.asarray, jm.module.params)
    args = make_sm_args(sm_max_span_length=20)
    fresh = TModel.from_args(args, splits(TSplit)[0], device="cpu")
    fresh.module.load_state_dict(gaussian_hsmm_params_from_numpy(params, "cpu"))
    want = jm.predict(jtest)
    got = fresh.predict(ttest)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(KeyError):
        gaussian_hsmm_params_from_numpy({**params, "initial_embeddings": 0}, "cpu")
    with pytest.raises(KeyError):
        gaussian_hsmm_params_from_numpy({"init_logits": params["init_logits"]}, "cpu")


@pytest.mark.parametrize(
    "overrides,split",
    [
        (dict(sm_hidden_markov=True), dict()),  # K = 1: the 2-row duration table
        (dict(sm_max_span_length=6, sm_class_shape_bucket=4), dict(n_classes=5)),
        (dict(sm_max_span_length=8, batch_size=4), dict(n_classes=4, span_k=7)),
    ],
)
def test_model_variants_predict_like_jax(overrides, split):
    args = make_sm_args(**{"sm_max_span_length": 20, **overrides})
    jm, tm, jtest, ttest = fitted(args, n_train=30, n_test=9, **split)
    want = jm.predict(jtest)
    got = tm.predict(ttest)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_class_shape_bucket_parity():
    """Padding the valid-class set with -1 sentinels must not change the
    port's predictions."""
    _, test = splits(TSplit, n_test=9, n_classes=3, max_len=22, span_k=4, test_seed=2)
    preds = {}
    for bucket in (1, 4, 7):
        args = make_sm_args(batch_size=4, sm_max_span_length=8, sm_class_shape_bucket=bucket)
        model = TModel.from_args(args, test, device="cpu")
        model.fit(test, use_labels=True)
        preds[bucket] = model.predict(test)
    for bucket in (4, 7):
        for video, want in preds[1].items():
            np.testing.assert_array_equal(preds[bucket][video], want)


def test_unported_paths_raise():
    """Every path is ported: only the retired --model_parallel > 1 raises,
    and --data_parallel with no process group on one device runs the
    single path, equal to the run without the flag. (Data parallelism
    under a group: tests/test_torch_parallel.py; the constraint and merge
    flags: tests/test_torch_constrained.py; checkpoints, resume and
    profiling: tests/test_torch_checkpoint.py and tests/test_torch_cli.py;
    the flow and the compound model: tests/test_torch_flow.py and
    tests/test_torch_compound.py.)"""
    train, _ = splits(TSplit, n_train=4)
    for use_labels in (True, False):
        fits = []
        for dp in (False, True):
            args = make_sm_args(sm_supervised_method="gradient-based", epochs=2,
                                data_parallel=dp)
            model = TModel.from_args(args, train, device="cpu")
            losses = []
            model.fit(train, use_labels=use_labels,
                      callback_fn=lambda e, s: losses.append(s["train_loss"]))
            fits.append((losses, model.module.state_dict()))
        assert fits[0][0] == fits[1][0]
        for k, v in fits[0][1].items():
            assert torch.equal(v, fits[1][1][k]), k
    args = make_sm_args(sm_supervised_method="gradient-based", model_parallel=2)
    with pytest.raises(NotImplementedError, match="model_parallel"):
        TModel.from_args(args, train, device="cpu").fit(train, use_labels=True)


def test_initial_params_and_moment_init_match_jax():
    """Before any fit: the deterministic parameters agree with JAX's
    (init_logits are a uniform draw on each side, from different RNGs,
    and are not compared); the moment init agrees to rtol 1e-5."""
    jtrain, _ = splits(JSplit, n_train=6)
    ttrain, _ = splits(TSplit, n_train=6)
    args = make_sm_args(sm_max_span_length=20)
    jm, tm = JModel.from_args(args, jtrain), TModel.from_args(args, ttrain, device="cpu")
    feats = [ttrain._samples[n]["features"] for n in sorted(ttrain._samples)]
    for moment_init in (False, True):
        if moment_init:
            jm.module.initialize_gaussian(feats)
            tm.module.initialize_gaussian(feats)
        want = jax.tree_util.tree_map(np.asarray, jm.module.params)
        got = tm.module.state_dict()
        for k in ("poisson_log_rates", "gaussian_means", "gaussian_cov", "transition_logits"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)
        init = got["init_logits"].numpy()
        assert init.shape == want["init_logits"].shape and ((0 <= init) & (init < 1)).all()


def test_host_helpers_match_jax():
    for T in (1, 31, 32, 33, 100, 1024, 5000):
        assert tb.pad_length_to_bucket(T) == jb.pad_length_to_bucket(T)
    for n, bucket in ((3, 4), (19, 4), (127, 4), (128, 8), (130, 4), (5, 1)):
        assert tb.pad_class_width(n, bucket, 128) == j_pad_class_width(n, bucket, 128)
    data = TSplit(num_videos=7, seed=4, **SPLIT)
    jdata = JSplit(num_videos=7, seed=4, **SPLIT)
    for kw in (dict(batch_size=3, batch_by_task=True, shuffle=False, sort_by_length=True),
               dict(batch_size=2, batch_by_task=True, shuffle=True, seed=5)):
        for tbatch, jbatch in zip(tb.iter_batches(data, **kw), jb.iter_batches(jdata, **kw)):
            assert tbatch["video_name"] == jbatch["video_name"]
            np.testing.assert_array_equal(tbatch["features"], jbatch["features"])
            np.testing.assert_array_equal(tbatch["gt_single"], jbatch["gt_single"])
    feats = [data._samples[n]["features"] for n in sorted(data._samples)]
    labels = [data._samples[n]["gt_single"] for n in sorted(data._samples)]
    for max_k in (1, 3, 20):
        want = jstats(feats, labels, n_classes=3, max_k=max_k)
        got = tstats(feats, labels, n_classes=3, max_k=max_k)
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)
    rng = np.random.RandomState(0)
    for _ in range(20):
        a, b = rng.randint(0, 4, rng.randint(0, 9)), rng.randint(0, 4, rng.randint(0, 9))
        assert ted.eval(a, b) == jed.eval(a, b)


def test_deferred_drain_one_copy_in_add_order():
    drain = DeferredLabelDrain()
    drain.add("a", torch.tensor([[1, 2, 3], [4, 5, 6]]), n_rows=1)
    drain.add("b", torch.tensor([[7, 8, 9, 10, 11]]))
    out = list(drain.drain())
    assert [m for m, _ in out] == ["a", "b"]
    np.testing.assert_array_equal(out[0][1], [[1, 2, 3, -1, -1]])
    np.testing.assert_array_equal(out[1][1], [[7, 8, 9, 10, 11]])
    assert list(drain.drain()) == []
