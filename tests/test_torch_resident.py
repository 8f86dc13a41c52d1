"""The port's resident corpus against its streaming path and against the
JAX package's resident path.

Mirrors the single-device tests of tests/test_resident_scan.py on the
port: a batch gathered from the resident corpus is the tensor tuple the
streaming path builds for it (its own length bucket, its task's class
width, the streaming dummy rows), so the resident fit's epoch stats and
parameters, its checkpoints and its predictions are bit-equal to the
streaming path's (``==`` and ``torch.equal``). Against the JAX package,
with its parameters carried over by
``bridge.gaussian_hsmm_params_from_numpy``, at test_torch_training.py's
tolerances: a batch's loss rtol 1e-5, epoch losses after Adam rtol 1e-3,
labels equal; the plans' index matrices and the corpus tensors equal.
"""

import argparse
import pickle
import weakref

import jax
import numpy as np
import pytest
import torch

from action_segmentation_torch import main as tmain
from action_segmentation_torch.bridge import gaussian_hsmm_params_from_numpy
from action_segmentation_torch.data import batching as tb
from action_segmentation_torch.data import minigen as tgen
from action_segmentation_torch.data import resident as tres
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models import base as tbase
from action_segmentation_torch.models import semimarkov as tsm
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.parallel.mesh import single_mesh
from action_segmentation_tpu.data import resident as jres
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from tests import test_torch_constrained as tc
from tests.conftest import make_sm_args

STAT_KEYS = ("train_loss", "train_nll_frame_avg", "train_kl_vid_avg", "train_recon_bound")
RAGGED = dict(num_videos=20, n_classes=3, max_len=150, min_len=8, span_k=5, seed=9)


def cfg(**over):
    base = dict(sm_max_span_length=8, epochs=3, lr=1e-2, batch_size=10, seed=3)
    base.update(over)
    return make_sm_args(**base)


def fit(args, train, use_labels):
    """(port model on the CPU, [epoch stats]) after a fit."""
    model = TModel.from_args(args, train, device="cpu")
    stats = []
    model.fit(train, use_labels=use_labels,
              callback_fn=lambda e, s: stats.append([s[k] for k in STAT_KEYS] if s else []))
    return model, stats


def assert_params_equal(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def assert_predictions_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def resident_against_streaming(train, use_labels, **over):
    """Fit the same flags resident and streaming; both bit-equal."""
    m_res, s_res = fit(cfg(**over), train, use_labels)
    assert m_res._get_resident(train, False) is not None  # the resident path ran
    m_str, s_str = fit(cfg(**over, sm_device_resident_mb=0), train, use_labels)
    assert not getattr(m_str, "_resident_cache", None)
    assert s_res == s_str
    assert_params_equal(m_res, m_str)
    return m_res, m_str


def streamed_predictions(model, split):
    """`model`'s predictions through the streaming path."""
    budget = model.args.sm_device_resident_mb
    model.args.sm_device_resident_mb = 0
    try:
        return model.predict(split)
    finally:
        model.args.sm_device_resident_mb = budget


# ---- the single-device tests of tests/test_resident_scan.py ----------------


def test_resident_matches_streaming_unsupervised():
    """Uniform lengths and a partial final batch (25 videos in batches of
    10): the epoch stats and the parameters bit for bit."""
    train = TSplit(num_videos=25, n_classes=3, max_len=24, min_len=24, span_k=4, seed=0)
    resident_against_streaming(train, False, training="unsupervised")


def test_resident_matches_streaming_supervised_gradient():
    train = TSplit(num_videos=20, n_classes=3, max_len=20, min_len=20, span_k=4, seed=1)
    resident_against_streaming(train, True, sm_supervised_method="gradient-based", epochs=2)


def test_resident_matches_streaming_closed_then_gradient():
    train = TSplit(num_videos=20, n_classes=3, max_len=20, min_len=20, span_k=4, seed=7)
    resident_against_streaming(train, True, sm_supervised_method="closed-then-gradient",
                               epochs=2)


def test_resident_matches_streaming_ragged_trajectory():
    """Several length buckets: the fit applies its steps in the shuffled
    epoch order, each batch at its own bucket, so losses and parameters
    are bit-equal, not merely close."""
    train = TSplit(**RAGGED)
    m_res, _ = resident_against_streaming(
        train, True, sm_supervised_method="closed-then-gradient", epochs=2, batch_size=4)
    res = m_res._get_resident(train, False)
    plan = res.make_plan(4, shuffle=True, seed=4, global_order=True)
    assert len(plan.groups) == 1  # epoch order: one group
    assert [b.bix for b in plan.batches()] == list(range(plan.n))
    assert len(set(plan.groups[0].t_widths)) > 1  # each batch its own bucket
    assert len(res.make_plan(4, shuffle=True, seed=4).groups) > 1  # ragged


def test_resident_predict_matches_streaming_on_ragged_corpus():
    train = TSplit(num_videos=18, n_classes=3, max_len=60, min_len=8, span_k=5, seed=2)
    model = TModel.from_args(cfg(sm_supervised_method="closed-form"), train, device="cpu")
    model.fit(train, use_labels=True)
    p_res = model.predict(train)
    assert model._get_resident(train, False) is not None
    assert_predictions_equal(p_res, streamed_predictions(model, train))


@pytest.mark.parametrize("z_dim", [0, 4])
def test_resident_matches_streaming_compound(z_dim):
    """The compound model, with and without a latent: a batch's noise comes
    from a generator seeded by (seed, epoch, the batch's epoch index), so
    the stats and parameters are bit-equal; then its decode."""
    train = TSplit(num_videos=20, n_classes=3, max_len=20, min_len=20, span_k=4,
                   feature_dim=8, seed=4)
    m_res, _ = resident_against_streaming(
        train, False, training="unsupervised", sm_component_model=True,
        sm_component_embedding_dim=8, sm_component_z_dim=z_dim, sm_component_z_hidden_dim=8,
        epochs=2)
    assert_predictions_equal(m_res.predict(train), streamed_predictions(m_res, train))


def test_resident_resume_matches_uninterrupted(tmp_path):
    """A resident run stopped after epoch 1 and resumed ends with the
    uninterrupted run's parameters, bit for bit."""
    train = TSplit(num_videos=20, n_classes=3, max_len=20, min_len=20, span_k=4, seed=5)
    over = dict(sm_supervised_method="gradient-based", epochs=4)
    m_full, _ = fit(cfg(**over), train, True)
    ck = str(tmp_path / "ck")
    fit(cfg(**{**over, "epochs": 2, "checkpoint_dir": ck, "checkpoint_every": 1}), train, True)
    m_res = TModel.from_args(cfg(**over, checkpoint_dir=ck, checkpoint_every=1, resume=True),
                             train, device="cpu")
    epochs_seen = []
    m_res.fit(train, use_labels=True, callback_fn=lambda e, s: epochs_seen.append(e))
    assert epochs_seen == [2, 3]
    assert m_res._get_resident(train, False) is not None
    assert_params_equal(m_res, m_full)


class Flaky:
    """A datasplit one of whose videos fails to load."""

    def __init__(self, base, bad):
        self.base, self.bad = base, bad
        self.videos_by_task = base.videos_by_task

    def __getitem__(self, key):
        return None if key == self.bad else self.base[key]

    def __len__(self):
        return len(self.base) - 1


def flaky(base):
    keys = sorted((t, n) for t, vids in base.videos_by_task.items() for n in vids)
    return Flaky(base, keys[3])


def test_unloadable_video_resident_predict():
    """A video that fails to load is left out of the corpus, sorts as 0 in
    a length-sorted plan, and the other videos decode as they stream."""
    base = TSplit(num_videos=12, n_classes=3, max_len=40, min_len=8, span_k=4, seed=11)
    split = flaky(base)
    model = TModel.from_args(cfg(sm_supervised_method="closed-form"), base, device="cpu")
    model.fit(base, use_labels=True)
    p_res = model.predict(split)
    assert model._get_resident(split, False) is not None
    assert split.bad[1] not in p_res
    assert_predictions_equal(p_res, streamed_predictions(model, split))


def test_budget_fallback_streams():
    train = TSplit(num_videos=12, n_classes=3, max_len=24, min_len=24, span_k=4, seed=6)
    model = TModel.from_args(cfg(training="unsupervised", sm_device_resident_mb=0), train,
                             device="cpu")
    assert model._get_resident(train, False) is None
    model.fit(train, use_labels=False)
    assert model.predict(train)
    assert not getattr(model, "_resident_cache", None)


def test_resident_budget_is_shared_across_cache_entries():
    """--sm_device_resident_mb bounds the live entries together."""
    train = TSplit(num_videos=12, n_classes=3, max_len=64, span_k=8, seed=0)
    dev = TSplit(num_videos=12, n_classes=3, max_len=64, span_k=8, seed=1)
    model = TModel.from_args(cfg(epochs=1, batch_size=6), train, device="cpu")
    r_train = model._get_resident(train, False)
    assert r_train is not None
    model.args.sm_device_resident_mb = r_train.nbytes / float(1 << 20) * 1.5
    assert model._get_resident(dev, False) is None  # 0.5x left, 1x needed
    model._resident_cache.clear()
    assert model._get_resident(dev, False) is not None


def test_resident_eviction_frees_budget_before_new_build():
    splits = [TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=i)
              for i in range(5)]
    model = TModel.from_args(cfg(epochs=1, batch_size=5), splits[0], device="cpu")
    first = model._get_resident(splits[0], False)
    assert first is not None
    model.args.sm_device_resident_mb = first.nbytes / float(1 << 20) * 4.2
    for s in splits[1:4]:
        assert model._get_resident(s, False) is not None
    assert len(model._resident_cache) == tsm.RESIDENT_LRU == 4
    assert model._get_resident(splits[4], False) is not None
    assert len(model._resident_cache) == 4
    assert model._resident_key(splits[0], False) not in model._resident_cache


def test_resident_pin_survives_cache_pressure():
    splits = [TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=i)
              for i in range(6)]
    model = TModel.from_args(cfg(epochs=1, batch_size=5), splits[0], device="cpu")
    assert model._get_resident(splits[0], False) is not None
    model._pin_resident(splits[0], False)
    for s in splits[1:]:
        model._get_resident(s, False)
    key = model._resident_key(splits[0], False)
    assert key in model._resident_cache  # survived 5 later entries
    model._unpin_resident(splits[0], False)
    for s in splits[1:]:
        k = model._resident_key(s, False)
        if k in model._resident_cache:
            model._resident_cache.move_to_end(k)
    model._get_resident(TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=99),
                        False)
    assert key not in model._resident_cache  # unpinned: evictable


def test_resident_key_reflects_baked_args():
    split = TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=0)
    model = TModel.from_args(cfg(epochs=1, batch_size=5), split, device="cpu")
    r1 = model._get_resident(split, False)
    assert r1 is not None
    k1 = model._resident_key(split, False)
    model.args.sm_constrain_narration_weight = 2.5  # keys narration builds only
    assert model._resident_key(split, False) == k1
    assert model._get_resident(split, False) is r1
    ka = model._resident_key(split, True)
    model.args.sm_constrain_narration_weight = 5.0
    assert model._resident_key(split, True) != ka
    model.args.sm_class_shape_bucket = 7
    assert model._resident_key(split, False) != k1
    r2 = model._get_resident(split, False)
    assert r2 is not None and r2 is not r1


def test_resident_failure_watermark_validates_referent():
    """A watermark whose weak referent is another split is purged, not
    allowed to keep this split streaming."""
    split_a = TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=0)
    split_b = TSplit(num_videos=10, n_classes=3, max_len=64, span_k=8, seed=1)
    model = TModel.from_args(cfg(epochs=1, batch_size=5), split_a, device="cpu")
    assert model._get_resident(split_a, False) is not None  # sets up the cache
    key_b = model._resident_key(split_b, False)
    model._resident_failed = {key_b: (weakref.ref(split_a), 1e9)}
    assert model._get_resident(split_b, False) is not None
    assert key_b not in model._resident_failed


# ---- the port's own -------------------------------------------------------


def test_pickle_carries_no_resident_tensors():
    train = TSplit(num_videos=10, n_classes=3, max_len=30, span_k=4, seed=0)
    model = TModel.from_args(cfg(sm_supervised_method="closed-form"), train, device="cpu")
    model.fit(train, use_labels=True)
    want = model.predict(train)
    model._pin_resident(train, False)
    state = model.__getstate__()
    assert not {"_resident_cache", "_resident_pins", "_resident_failed"} & set(state)
    with tbase.unpickle_device("cpu"):
        again = pickle.loads(pickle.dumps(model))
    assert not hasattr(again, "_resident_cache")
    assert_predictions_equal(again.predict(train), want)


def test_batch_accumulation_and_train_limit():
    """--batch_accumulation above 1 streams (no build); --train_limit on
    the resident path takes the streaming path's first batches."""
    train = TSplit(**RAGGED)
    model, _ = fit(cfg(training="unsupervised", batch_size=4, epochs=2, batch_accumulation=2),
                   train, False)
    assert not getattr(model, "_resident_cache", None)
    resident_against_streaming(train, False, training="unsupervised", batch_size=4, epochs=2,
                               train_limit=3)


def test_build_and_gather_errors_raise(monkeypatch):
    """No fallback hides a failure: an error in the build or in a gather
    raises out of fit and predict."""
    train = TSplit(num_videos=10, n_classes=3, max_len=30, span_k=4, seed=0)

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    model = TModel.from_args(cfg(training="unsupervised", epochs=1), train, device="cpu")
    monkeypatch.setattr(tsm, "build_resident_corpus", boom)
    with pytest.raises(RuntimeError, match="boom"):
        model.fit(train, use_labels=False)
    monkeypatch.undo()
    monkeypatch.setattr(tsm, "gather_resident_rows", boom)
    with pytest.raises(RuntimeError, match="boom"):
        model.predict(train)


# ---- against the JAX package's resident path ------------------------------

MODES = {
    "generative": (dict(sm_supervised_method="gradient-based"), True),
    "discriminative": (
        dict(sm_supervised_method="gradient-based", sm_train_discriminatively=True), True),
    "unsupervised": (dict(), False),
}


def carry(jm, tm):
    params = jax.tree_util.tree_map(np.asarray, jm.module.params)
    tm.module.load_state_dict(gaussian_hsmm_params_from_numpy(params, "cpu"))


def jax_pair(args, **split):
    split = {**RAGGED, **split}
    jtrain, ttrain = JSplit(**split), TSplit(**split)
    jm = JModel.from_args(args, jtrain)
    tm = TModel.from_args(args, ttrain, device="cpu")
    carry(jm, tm)
    return jm, tm, jtrain, ttrain


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resident_batch_losses_match_jax(mode):
    """Every batch of an epoch plan, gathered on each side from its own
    resident corpus (JAX at the plan's widest bucket, the port at each
    batch's), from the same moment-initialized parameters: loss rtol 1e-5."""
    overrides, use_labels = MODES[mode]
    args = cfg(sm_max_span_length=10, batch_size=4, **overrides)
    jm, tm, jtrain, ttrain = jax_pair(args)
    jm.module.initialize_gaussian([jtrain._samples[n]["features"]
                                   for n in sorted(jtrain._samples)])
    carry(jm, tm)
    jr, tr = jm._get_resident(jtrain, False), tm._get_resident(ttrain, False)
    jplan = jr.make_plan(4, shuffle=True, seed=5, global_order=True)
    tplan = tr.make_plan(4, shuffle=True, seed=5, global_order=True)
    (g,) = jplan.groups
    loss_fn = jax.jit(jm._build_loss_fn(use_labels))
    feat, length, gt, cons_r, end_r = jres.resident_views(
        jr.device_args, jr.with_cons, jr.with_end)
    table = tr.upload_plan(tplan)
    batches = tplan.batches()
    assert len(batches) == g.n > 1
    for i, b in enumerate(batches):
        f, le, gg, w, c, e = jres.gather_resident_rows(
            feat, length, gt, cons_r, end_r, g.idxs[i], g.t_width, g.vcs.shape[1])
        want, _ = loss_fn(jm.module.params, f, le, g.vcs[i], g.invs[i], gg, c, e, w,
                          jax.random.PRNGKey(0))
        got, _ = tm._loss(*tres.gather_resident_rows(tr, table, b), use_labels=use_labels)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resident_epoch_losses_match_jax(mode):
    """Both packages' resident fits from the same parameters: epoch losses
    after Adam at rtol 1e-3."""
    overrides, use_labels = MODES[mode]
    args = cfg(sm_max_span_length=10, batch_size=4, epochs=3, lr=5e-2, **overrides)
    jm, tm, jtrain, ttrain = jax_pair(args)
    want, got = [], []
    jm.fit(jtrain, use_labels=use_labels,
           callback_fn=lambda ep, s: want.append(float(s["train_loss"])))
    tm.fit(ttrain, use_labels=use_labels, callback_fn=lambda ep, s: got.append(s["train_loss"]))
    assert jm._get_resident(jtrain, False) is not None
    assert tm._get_resident(ttrain, False) is not None
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_resident_predict_matches_jax():
    """The JAX closed-form model's parameters decoded by both resident
    paths on a ragged corpus with an unloadable video: labels equal."""
    args = cfg(sm_max_span_length=10, batch_size=4, sm_supervised_method="closed-form")
    jm, tm, jtrain, ttrain = jax_pair(args)
    jm.fit(jtrain, use_labels=True)
    carry(jm, tm)
    jsplit, tsplit = flaky(jtrain), flaky(ttrain)
    want = jm.predict(jsplit)
    got = tm.predict(tsplit)
    assert jm._get_resident(jsplit, False) is not None
    assert tm._get_resident(tsplit, False) is not None
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)


PLANS = {
    "shuffled, epoch order": dict(shuffle=True, seed=3, global_order=True),
    "shuffled, by bucket": dict(shuffle=True, seed=3),
    "length-sorted": dict(shuffle=False, seed=1, sort_by_length=True),
    "limited": dict(shuffle=True, seed=8, limit=3, global_order=True),
    "rows padded to 4": dict(shuffle=True, seed=3, pad_rows_to=4),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_make_plan_matches_jax(plan):
    """The plans of a ragged corpus with an unloadable video: the same
    batches, index matrices, batch indices, groups and counts."""
    args = cfg(batch_size=3)
    jm, tm, jtrain, ttrain = jax_pair(args)
    jr = jm._get_resident(flaky(jtrain), False)
    tr = tm._get_resident(flaky(ttrain), False)
    jp, tp = jr.make_plan(3, **PLANS[plan]), tr.make_plan(3, **PLANS[plan])
    assert (tp.videos, tp.frames, len(tp.groups)) == (jp.videos, jp.frames, len(jp.groups))
    for jg, tg in zip(jp.groups, tp.groups):
        assert tg.t_width == jg.t_width
        for name in ("idxs", "vcs", "invs", "bixs"):
            np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name), err_msg=name)
        assert (tg.keys, tg.batch_sizes, tg.batch_frames) == (
            jg.keys, jg.batch_sizes, jg.batch_frames)
        np.testing.assert_array_equal(tg.batch_sizes, jg.bws)


# ---- the CrossTask fixture: narration, end masks, the class bucket ---------


@pytest.fixture(scope="module")
def ct_root(tmp_path_factory):
    """Three primary tasks of three steps, one short training video."""
    tasks = {task_id: ["stepA", "stepB", "stepC"] for task_id in tc.PRIMARY[:3]}
    return tc.write_release(str(tmp_path_factory.mktemp("ct")), tasks, n_train=4, n_val=2,
                            short_video="v{}_0".format(tc.PRIMARY[0]))


NARRATION = ("--sm_constrain_transitions", "--sm_constrain_with_narration", "train", "test",
             "--sm_constrain_narration_weight", "-7.5")


def test_resident_tensors_match_jax(ct_root):
    """The corpus the port builds (narration penalties with the rows past
    each length, end masks with the short-video exception) equals JAX's."""
    (jargs, jtrain, _), (targs, ttrain, _) = tc.build(tc.argv_for(ct_root, *NARRATION))
    jm = JModel.from_args(jargs, jtrain)
    tm = TModel.from_args(targs, ttrain, device="cpu")
    jr, tr = jm._get_resident(jtrain, True), tm._get_resident(ttrain, True)
    assert tr.with_cons and tr.with_end and (tr.t_max, tr.c_max) == (jr.t_max, jr.c_max)
    assert tr.nbytes == jr.nbytes and tr.row_of == jr.row_of
    for got, want in zip((tr.feat, tr.length, tr.gt, tr.cons, tr.end), jr.device_args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def streaming_decode_batch(model, batch, split, use_narration):
    """The padded tensors predict's streaming path decodes for `batch`."""
    vc, _, cons, end = model._batch_device_args(batch, split, use_narration)
    features, lengths, cons, end, _ = model._pad_batch_rows(
        single_mesh("cpu"), batch["features"], batch["lengths"], cons, end)
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (features, lengths, vc, cons, end))


@pytest.mark.parametrize("flags", [
    NARRATION, (), ("--sm_class_shape_bucket", "1", "--sm_constrain_transitions")],
    ids=["narration and end masks", "class-bucket padding", "end masks, no bucket"])
def test_gathered_batches_equal_streaming(ct_root, flags):
    """Every batch of a training epoch equals ``_training_batch``'s
    tensors, and every decode batch the tensors predict streams: values,
    dtypes and shapes. Batches of 3 of a task's 4 videos, so every task
    has a partial batch with the streaming dummy rows."""
    targs = tc.parse((tmain.add_data_args, tsm.SemiMarkovModel.add_args,
                      tbase.add_training_args),
                     tc.argv_for(ct_root, *flags, "--batch_size", "3"))
    ttrain = tmain.make_data_splits(targs)["all"][0]
    model = TModel.from_args(targs, ttrain, device="cpu")
    narration = "--sm_constrain_with_narration" in flags
    res = model._get_resident(ttrain, narration)
    assert res is not None and res.with_cons == narration
    assert res.with_end == ("--sm_constrain_transitions" in flags)
    plan = res.make_plan(3, shuffle=True, seed=2, global_order=True)
    assert min(b.size for b in plan.batches()) < 3
    table = res.upload_plan(plan)
    streamed = tb.iter_batches(ttrain, batch_size=3, batch_by_task=True, shuffle=True, seed=2)
    n = 0
    for b, batch in zip(plan.batches(), streamed):
        got = tres.gather_resident_rows(res, table, b)
        want = model._training_batch(batch, ttrain, narration)
        for name, g, w in zip(("features", "lengths", "vc", "inv_map", "gt", "cons", "end",
                               "weights"), got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        n += 1
    assert n == plan.n > 1
    plan = res.make_plan(3, shuffle=False, seed=1, sort_by_length=True)
    table = res.upload_plan(plan)
    streamed = tb.iter_batches(ttrain, batch_size=3, batch_by_task=True, shuffle=False,
                               sort_by_length=True)
    for b, batch in zip(plan.batches(), streamed):
        features, lengths, vc, _, gt, cons, end, _ = tres.gather_resident_rows(
            res, table, b, with_gt=False)
        assert gt is None
        want = streaming_decode_batch(model, batch, ttrain, narration)
        for name, g, w in zip(("features", "lengths", "vc", "cons", "end"),
                              (features, lengths, vc, cons, end), want):
            assert g.dtype == w.dtype and torch.equal(g, w), name


def counting_builds(monkeypatch):
    """A list of (model id, key) of every resident build main.main makes."""
    builds = []
    build = tsm.build_resident_corpus

    def counted(model, datasplit, use_narration, *args, **kwargs):
        builds.append((id(model), model._resident_key(datasplit, use_narration)))
        return build(model, datasplit, use_narration, *args, **kwargs)

    monkeypatch.setattr(tsm, "build_resident_corpus", counted)
    return builds


def test_main_builds_each_split_once(ct_root, monkeypatch):
    """Through the command line, 3 epochs with per-epoch train and dev
    decodes: a model builds each (split, narration) once; the constrained
    fit resident, bit-equal to --sm_device_resident_mb 0."""
    argv = ["--classifier", "semimarkov", "--training", "unsupervised", *tc.argv_for(ct_root),
            *NARRATION]
    argv[argv.index("--epochs") + 1] = "3"
    builds = counting_builds(monkeypatch)
    np.random.seed(0)  # F1 samples frames from numpy's global stream
    stats = tmain.main(argv, device="cpu")
    assert len(builds) == len(set(builds)) >= 3
    # the training model: the train split at train (narration), the train
    # subset and the dev split at test
    assert len([b for b in builds if b[0] == builds[0][0]]) == 3
    del builds[:]
    np.random.seed(0)
    streamed = tmain.main(argv + ["--sm_device_resident_mb", "0"], device="cpu")
    assert not builds
    assert list(streamed) == list(stats)
    for split in stats:
        for task, want in stats[split].items():
            got = streamed[split][task]
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                              err_msg=key)


def test_breakfast_train_split_serves_fit_and_eval(tmp_path, monkeypatch):
    """Breakfast hands one datasplit as train and train subset: one build
    serves the fit and every per-epoch decode of it."""
    root = str(tmp_path / "bf")
    tgen.write_mini_breakfast(root, np.random.RandomState(0), dim=8)
    argv = ["--classifier", "semimarkov", "--training", "supervised", "--dataset", "breakfast",
            "--features", "raw", "--data_root", root, "--sm_supervised_method",
            "gradient-based", "--epochs", "2", "--sm_max_span_length", "6"]
    builds = counting_builds(monkeypatch)
    tmain.main(argv, device="cpu")
    parser = argparse.ArgumentParser()
    tmain.add_data_args(parser)
    n_splits = len(tmain.make_data_splits(parser.parse_known_args(argv)[0]))
    assert len(builds) == len(set(builds))
    # per held-out split: train (fit and train-subset decodes), the dev
    # split, and the test split again for the best epoch's unpickled model
    assert len(builds) == 3 * n_splits, (len(builds), n_splits)
