"""The training slice end to end against the JAX package.

The JAX model's initial parameters are carried into the port's model by
``bridge.gaussian_hsmm_params_from_numpy`` (the two packages' PRNG
streams differ), then both see the same synthetic corpus and the same
batches. On the CPU the port's partition runs its kernels' plain
versions and JAX's runs autodiff of its jnp scan. Tolerances: a batch's
loss rtol 1e-5 and its gradients rtol 2e-3 / atol 2e-4 (the JAX package's
gradient tolerance, tests/test_hsmm_grad.py); epoch losses after Adam
rtol 1e-3 (the two clips differ by the 1e-6 that torch adds to the norm);
raw parameters after training are not compared, since Adam's
normalised steps amplify last-digit gradient differences. The port-only
mirrors keep the JAX tests' thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.api import Segmenter as TSegmenter
from action_segmentation_torch.bridge import gaussian_hsmm_params_from_numpy
from action_segmentation_torch.data import batching as tb
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models import base as tbase
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_tpu.api import Segmenter as JSegmenter
from action_segmentation_tpu.data import batching as jb
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models.base import ReduceLROnPlateau as JPlateau
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from tests.conftest import make_sm_args
from tests.test_torch_semimarkov import fitted

SPLIT = dict(n_classes=3, max_len=40, span_k=5)
MODES = {
    "generative": (dict(sm_supervised_method="gradient-based"), True),
    "discriminative": (
        dict(sm_supervised_method="gradient-based", sm_train_discriminatively=True), True
    ),
    "unsupervised": (dict(), False),
}


def pair(args, n_train=40):
    """(JAX model, port model with the JAX model's parameters, splits)."""
    jtrain = JSplit(num_videos=n_train, seed=0, **SPLIT)
    ttrain = TSplit(num_videos=n_train, seed=0, **SPLIT)
    jm = JModel.from_args(args, jtrain)
    tm = TModel.from_args(args, ttrain, device="cpu")
    carry(jm, tm)
    return jm, tm, jtrain, ttrain


def carry(jm, tm):
    params = jax.tree_util.tree_map(np.asarray, jm.module.params)
    tm.module.load_state_dict(gaussian_hsmm_params_from_numpy(params, "cpu"))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_first_batch_loss_and_grads_match_jax(mode):
    overrides, use_labels = MODES[mode]
    args = make_sm_args(sm_max_span_length=20, **overrides)
    jm, tm, jtrain, ttrain = pair(args)
    feats = [jtrain._samples[n]["features"] for n in sorted(jtrain._samples)[:20]]
    jm.module.initialize_gaussian(feats)
    carry(jm, tm)

    kw = dict(batch_size=args.batch_size, batch_by_task=True, shuffle=True, seed=args.seed)
    jbatch = next(iter(jb.iter_batches(jtrain, **kw)))
    vc, inv_map, cons, end = jm._batch_device_args(jbatch, jtrain, False)
    padded = jm._pad_batch_rows(jbatch["features"], jbatch["lengths"],
                                jbatch["gt_single"], cons, end)
    f, l, g, c, e, w = (jnp.asarray(x) for x in padded)
    loss_fn = jm._build_loss_fn(use_labels)
    (want, _), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jm.module.params, f, l, jnp.asarray(vc), jnp.asarray(inv_map), g, c, e, w,
        jax.random.PRNGKey(0),
    )

    tbatch = next(iter(tb.iter_batches(ttrain, **kw)))
    got, _ = tm._loss(*tm._training_batch(tbatch), use_labels=use_labels)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grads[name]),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize(
    "mode,extra",
    [
        ("generative", {}),
        ("discriminative", {}),
        ("unsupervised", {}),
        # a window of two batches, the last window of each epoch partial
        # (dropped), and at most 3 batches an epoch
        ("unsupervised", dict(batch_accumulation=2, train_limit=3)),
    ],
)
def test_epoch_losses_match_jax(mode, extra):
    overrides, use_labels = MODES[mode]
    args = make_sm_args(sm_max_span_length=20, epochs=3, lr=5e-2, **overrides, **extra)
    jm, tm, jtrain, ttrain = pair(args)
    want, got = [], []
    jm.fit(jtrain, use_labels=use_labels,
           callback_fn=lambda ep, s: want.append(float(s["train_loss"])))
    tm.fit(ttrain, use_labels=use_labels,
           callback_fn=lambda ep, s: got.append(s["train_loss"]))
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_closed_then_gradient_discriminative_matches_jax():
    args = make_sm_args(sm_max_span_length=20, epochs=2, lr=5e-2,
                        sm_supervised_method="closed-then-gradient",
                        sm_train_discriminatively=True)
    jm, tm, jtrain, ttrain = pair(args)
    want, got = [], []
    jm.fit(jtrain, use_labels=True, callback_fn=lambda ep, s: want.append((ep, dict(s))))
    tm.fit(ttrain, use_labels=True, callback_fn=lambda ep, s: got.append((ep, dict(s))))
    assert [ep for ep, _ in got] == [ep for ep, _ in want] == [-1, 0, 1]
    assert got[0][1] == want[0][1] == {}
    for (_, g), (_, w) in zip(got[1:], want[1:]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], float(w[k]), rtol=1e-3, err_msg=k)


# ---- port-only mirrors of the JAX package's training tests ----------------


def token_accuracy(model, data):
    preds = model.predict(data)
    match = total = 0
    for name, pred in preds.items():
        gold = data.gt_single(name)
        assert len(pred) == len(gold)
        match += int((pred == gold).sum())
        total += len(gold)
    return match / total


@pytest.fixture(scope="module")
def toy_data():
    train = TSplit(num_videos=60, n_classes=3, max_len=40, span_k=5, seed=0)
    test = TSplit(num_videos=20, n_classes=3, max_len=40, span_k=5, seed=1)
    return train, test


def test_gradient_supervised(toy_data):
    train, test = toy_data
    args = make_sm_args(sm_max_span_length=20, sm_supervised_method="gradient-based",
                        epochs=3, lr=5e-2, batch_size=10)
    model = TModel.from_args(args, train, device="cpu")
    losses = []
    model.fit(train, use_labels=True, callback_fn=lambda e, s: losses.append(s["train_loss"]))
    assert losses[-1] < losses[0], losses
    assert token_accuracy(model, test) > 0.7


def test_unsupervised_improves_likelihood(toy_data):
    train, _ = toy_data
    args = make_sm_args(sm_max_span_length=20, epochs=3, lr=5e-2, batch_size=10)
    model = TModel.from_args(args, train, device="cpu")
    losses = []
    model.fit(train, use_labels=False, callback_fn=lambda e, s: losses.append(s["train_loss"]))
    assert losses[-1] < losses[0], losses
    preds = model.predict(train)
    assert all(len(p) > 0 for p in preds.values())


def test_discriminative_training():
    train = TSplit(num_videos=30, n_classes=3, max_len=24, span_k=4, seed=0)
    test = TSplit(num_videos=10, n_classes=3, max_len=24, span_k=4, seed=1)
    args = make_sm_args(sm_max_span_length=10, sm_supervised_method="gradient-based",
                        sm_train_discriminatively=True, epochs=2, lr=5e-2)
    model = TModel.from_args(args, train, device="cpu")
    losses = []
    model.fit(train, use_labels=True, callback_fn=lambda e, s: losses.append(s["train_loss"]))
    assert losses[-1] < losses[0]
    assert token_accuracy(model, test) > 0.6


# ---- serving: labels with marginals ---------------------------------------


@pytest.mark.parametrize("valid_classes", [None, [0, 2]])
def test_segment_with_marginals_matches_jax(valid_classes):
    args = make_sm_args(sm_max_span_length=20, sm_supervised_method="closed-form")
    jm, tm, _, ttest = fitted(args)
    names = sorted(ttest._samples)[:3]
    feats = [ttest._samples[n]["features"] for n in names]
    jseg = JSegmenter(jm, valid_classes=valid_classes)
    tseg = TSegmenter(tm, valid_classes=valid_classes)
    many = tseg.segment_many(feats, batch_size=5)
    for f, m in zip(feats, many):
        want_labels, want_marg = jseg.segment_with_marginals(f)
        labels, marg = tseg.segment_with_marginals(f)
        np.testing.assert_array_equal(labels, np.asarray(want_labels))
        np.testing.assert_array_equal(labels, m)
        assert marg.shape == (f.shape[0], tm.n_classes)
        np.testing.assert_allclose(marg, np.asarray(want_marg), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(marg.sum(axis=1), 1.0, atol=1e-4)


# ---- the optimizer recipe --------------------------------------------------


def test_plateau_controller_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.00001, 3.9, 3.9, 3.9, 3.9, 3.9, float("nan"), 1.0]
    want = JPlateau(5e-3, factor=0.2, patience=1, min_lr=1e-4)
    got = tbase.ReduceLROnPlateau(5e-3, factor=0.2, patience=1, min_lr=1e-4)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]


def test_mask_grads_and_clip():
    """A frozen Parameter gets a zero gradient and no Adam update; the
    clip returns the norm before clipping, which the log line shows."""
    frozen = torch.nn.Parameter(torch.ones(3))
    free = torch.nn.Parameter(torch.ones(4))
    named = [("frozen", frozen), ("free", free)]
    (frozen.sum() * 3 + (free * 100).sum()).backward()
    tbase.mask_grads(named, {"frozen": False, "free": True})
    assert (frozen.grad == 0).all()
    norm = tbase.clip_grads([frozen, free], 10.0)
    np.testing.assert_allclose(float(norm), 200.0, rtol=1e-6)
    np.testing.assert_allclose(float(tbase.global_norm([free.grad])), 10.0, rtol=1e-5)
    args = make_sm_args()
    optimizer, scheduler = tbase.make_optimizer(args, [frozen, free])
    optimizer.step()
    assert (frozen == 1).all() and (free < 1).all()
    assert scheduler.lr == args.lr
    tbase.set_lr(optimizer, 1e-4)
    assert optimizer.param_groups[0]["lr"] == 1e-4
