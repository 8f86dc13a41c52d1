"""The port's baselines against the JAX package's.

On the CPU (``device="cpu"``), from the same numpy inputs: the
sufficient statistics' three extra covariance moments (rtol 1e-6; the
keys the closed-form HSMM fit reads bit-equal), the per-class diagonal
and the full-covariance emissions, shared and per class (rtol 1e-5 /
atol 1e-4; a class whose fp32 Cholesky fails gives NaN log-likelihoods
in both packages, and the argmax labels agree), each of the seven
classifiers through ``main.main`` on the mini CrossTask fixture (stats
equal, numerators and denominators; the two trained taggers from the
JAX package's initial weights through ``bridge``, at --ff_dropout_p 0,
their epoch losses at rtol 1e-4), one training step of each tagger
(loss at rtol 1e-5, gradients at rtol 2e-3, the JAX package's gradient
tolerance, finite where padded frames carry out-of-task labels), the
tagger's dropout, the twins of the JAX package's baseline tests, and the
baselines' pickles.
"""

import argparse
import contextlib
import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import bridge, checkpoint
from action_segmentation_torch import main as tmain
from action_segmentation_torch.data import breakfast as tbf
from action_segmentation_torch.data import minigen as tgen
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models import framewise as tfw
from action_segmentation_torch.models import sequential as tseq
from action_segmentation_torch.models.base import add_training_args
from action_segmentation_torch.ops import distributions as tdist
from action_segmentation_torch.ops import stats as tstats
from action_segmentation_tpu import main as jmain
from action_segmentation_tpu.models import framewise as jfw
from action_segmentation_tpu.models import sequential as jseq
from action_segmentation_tpu.ops import distributions as jdist
from action_segmentation_tpu.ops import stats as jstats
from tests.test_crosstask_pipeline import _base_argv, mini_crosstask  # noqa: F401

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-4  # the emissions (tests/test_hsmm_pallas.py's scores)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4  # the JAX package's gradient tolerance
LOSS_RTOL = 1e-5  # one step's loss
EPOCH_RTOL = 1e-4  # epoch losses after a few hundred Adam steps
COVARIANCES = ("tied_diag", "diag", "full", "tied")
HSMM_KEYS = ("span_counts", "span_lengths", "span_start_counts", "span_transition_counts",
             "instance_count", "gaussian_means", "gaussian_cov")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def labelled_corpus(D=12, C=4, few=4, seed=0):
    """Three videos of D-dim features at scale 10 (so the fp32 rounding of
    a rank-deficient covariance dwarfs its 1e-6 regularisation); class
    C - 1 has `few` < D frames, the others dozens."""
    rng = np.random.RandomState(seed)
    feats = [(10 * rng.randn(40, D) + 5).astype(np.float32) for _ in range(3)]
    labels = [rng.randint(0, C - 1, 40) for _ in range(3)]
    labels[2][:few] = C - 1
    return feats, labels


@pytest.mark.parametrize("covariance_type", COVARIANCES)
def test_sufficient_stats_match_jax(covariance_type):
    feats, labels = labelled_corpus()
    got = tstats.semimarkov_sufficient_stats(feats, labels, 4, max_k=100,
                                             covariance_type=covariance_type)
    want = jstats.semimarkov_sufficient_stats(feats, labels, 4, max_k=100,
                                              covariance_type=covariance_type)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0, err_msg=key)
    # the closed-form HSMM fit's keys do not depend on the covariance type
    plain = tstats.semimarkov_sufficient_stats(feats, labels, 4, max_k=100)
    for key in HSMM_KEYS + ("gaussian_cov_diag",):
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _emissions(kind, x, stats):
    means = stats["gaussian_means"]
    if kind == "diag":
        cov = stats["gaussian_cov_diag"]
        fns = (tdist.gaussian_emission_log_probs_diag, jdist.gaussian_emission_log_probs_diag)
    else:
        cov = stats["gaussian_cov_" + kind]
        fns = (tdist.gaussian_emission_log_probs_fullcov,
               jdist.gaussian_emission_log_probs_fullcov)
    got = fns[0](torch.from_numpy(x), torch.from_numpy(means), torch.from_numpy(cov)).numpy()
    want = np.asarray(fns[1](jnp.asarray(x), jnp.asarray(means), jnp.asarray(cov)))
    return got, want, cov


@pytest.mark.parametrize("kind", ["diag", "tied", "full"])
def test_emissions_match_jax(kind):
    feats, labels = labelled_corpus()
    stats = jstats.semimarkov_sufficient_stats(
        feats, labels, 4, max_k=100, covariance_type={"diag": "tied_diag"}.get(kind, kind))
    x = (10 * np.random.RandomState(1).randn(2, 30, 12) + 5).astype(np.float32)
    got, want, cov = _emissions(kind, x, stats)
    assert got.shape == want.shape == (2, 30, 4)
    nan_got, nan_want = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_got, nan_want)
    failed = tdist.cholesky_or_nan(torch.from_numpy(cov))[1].numpy() if kind != "diag" else 0
    if kind == "full":
        # the 4-frame class's fp32 factor fails: a NaN column on both sides
        np.testing.assert_array_equal(failed != 0, [False, False, False, True])
        assert nan_want[..., 3].all() and not nan_want[..., :3].any()
    else:
        assert not nan_want.any() and np.all(failed == 0)
    np.testing.assert_allclose(got[~nan_got], want[~nan_want], rtol=RTOL, atol=ATOL)
    # an argmax takes a NaN as the maximum in both packages
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(got), -1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(want), -1)))


def test_fullcov_chunks_agree(monkeypatch):
    """Whitening a few frames at a time gives the one-pass result (to the
    emissions' tolerance: a GEMM's sum order may change with its width)."""
    feats, labels = labelled_corpus(few=20)
    stats = tstats.semimarkov_sufficient_stats(feats, labels, 4, covariance_type="full")
    x = torch.from_numpy(feats[0])
    args = (torch.from_numpy(stats["gaussian_means"]),
            torch.from_numpy(stats["gaussian_cov_full"]))
    whole = tdist.gaussian_emission_log_probs_fullcov(x, *args)
    monkeypatch.setattr(tdist, "FULLCOV_CHUNK", 4 * 12 * 7)  # 7 frames a chunk
    chunked = tdist.gaussian_emission_log_probs_fullcov(x, *args)
    torch.testing.assert_close(chunked, whole, rtol=RTOL, atol=ATOL)


# ----- the classifiers through main.main -----


@pytest.fixture(autouse=True)
def seeded_test(monkeypatch):
    """F1 and FramewiseBaseline's sampling draw from numpy's global stream:
    every test() call of either package starts it from seed 0."""
    for mod in (tmain, jmain):
        def seeded(*args, _test=mod.test, **kwargs):
            np.random.seed(0)
            return _test(*args, **kwargs)
        monkeypatch.setattr(mod, "test", seeded)


@contextlib.contextmanager
def recorded(monkeypatch, cls):
    """Record every epoch's train_loss that `cls.fit` reports."""
    losses = []
    fit = cls.fit

    def recording_fit(self, train_data, use_labels, callback_fn=None):
        def callback(epoch, stats):
            losses.append(stats["train_loss"])
            if callback_fn:
                callback_fn(epoch, stats)
        return fit(self, train_data, use_labels, callback_fn=callback)

    monkeypatch.setattr(cls, "fit", recording_fit)
    yield losses


def bridge_initial_weights(monkeypatch):
    """The port's taggers start from the JAX package's initial weights
    (the same args and corpus build the JAX model for them)."""
    for cls, jcls, attr, convert in (
        (tfw.FramewiseDiscriminative, jfw.FramewiseDiscriminative, "mlp",
         bridge.framewise_params_from_numpy),
        (tseq.SequentialDiscriminative, jseq.SequentialDiscriminative, "tagger",
         bridge.sequential_params_from_numpy),
    ):
        def init(self, args, train_data, device=None, _init=cls.__init__, _jcls=jcls,
                 _attr=attr, _convert=convert):
            _init(self, args, train_data, device)
            params = np_tree(_jcls(args, train_data).params)
            getattr(self, _attr).load_state_dict(_convert(params, self.device))
        monkeypatch.setattr(cls, "__init__", init)


def assert_stats_equal(got, want):
    assert got.keys() == want.keys()
    for split in want:
        assert got[split].keys() == want[split].keys()
        for task, w in want[split].items():
            for key in w:
                np.testing.assert_array_equal(np.asarray(got[split][task][key]),
                                              np.asarray(w[key]),
                                              err_msg="{} {} {}".format(split, task, key))


def quiet_main(mod, argv, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.main(argv, **kw)


TAGGER_FLAGS = ["--epochs", "2", "--lr", "1e-2"]
CLASSIFIER_CASES = {
    "gmm_tied_diag": ["framewise_gaussian_mixture"],
    "gmm_diag": ["framewise_gaussian_mixture", "--gm_covariance", "diag"],
    "gmm_full": ["framewise_gaussian_mixture", "--gm_covariance", "full"],
    "gmm_tied": ["framewise_gaussian_mixture", "--gm_covariance", "tied"],
    "majority": ["framewise_baseline", "--framewise_baseline_type", "majority_class"],
    "sampled": ["framewise_baseline", "--framewise_baseline_type",
                "sample_class_distribution"],
    "canonical": ["sequential_canonical_baseline"],
    "constraints": ["sequential_predict_constraints"],
    "oracle": ["sequential_ground_truth"],
    "framewise_linear": ["framewise_discriminative", "--ff_dropout_p", "0", *TAGGER_FLAGS],
    "framewise_hidden": ["framewise_discriminative", "--ff_dropout_p", "0",
                         "--ff_hidden_layers", "2", "--ff_hidden_dim", "16", *TAGGER_FLAGS],
    "bilstm": ["sequential_discriminative", "--seq_hidden_size", "32", *TAGGER_FLAGS],
}


@pytest.mark.parametrize("case", sorted(CLASSIFIER_CASES))
def test_classifier_matches_jax(mini_crosstask, monkeypatch, case):  # noqa: F811
    root, _ = mini_crosstask
    classifier, *extra = CLASSIFIER_CASES[case]
    argv = _base_argv(root, classifier) + extra
    bridge_initial_weights(monkeypatch)
    tcls, jcls = tmain.CLASSIFIERS[classifier], jmain.CLASSIFIERS[classifier]
    with recorded(monkeypatch, tcls) as got_losses, recorded(monkeypatch, jcls) as want_losses:
        got = quiet_main(tmain, argv, device="cpu")
        want = quiet_main(jmain, argv)
    assert_stats_equal(got, want)
    assert len(got_losses) == len(want_losses)
    if classifier.endswith("discriminative"):
        assert len(got_losses) == 2 and np.isfinite(got_losses).all()
        np.testing.assert_allclose(got_losses, want_losses, rtol=EPOCH_RTOL)


# ----- one training step of each tagger -----


def _tagger_args(**overrides):
    parser = argparse.ArgumentParser()
    tfw.FramewiseDiscriminative.add_args(parser)
    tseq.SequentialDiscriminative.add_args(parser)
    add_training_args(parser)
    parser.add_argument("--batch_size", type=int, default=2)
    args = parser.parse_args([])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def _padded_batch(rng, B=2, T=16, D=6, C=7):
    """A batch of one task's videos (classes 0-3 of 7) whose padded frames
    carry an out-of-task label."""
    lengths = np.array([T, T - 5])
    gt = rng.randint(0, 4, (B, T))
    gt[1, lengths[1]:] = 6
    return {
        "features": rng.randn(B, T, D).astype(np.float32),
        "gt_single": gt.astype(np.int64),
        "lengths": lengths,
        "task_indices": [np.arange(4)] * B,
    }


def _jax_loss(logits_fn, batch, C=7):
    valid = np.zeros(C, bool)
    valid[batch["task_indices"][0]] = True
    T = batch["features"].shape[1]
    mask = (np.arange(T)[None] < batch["lengths"][:, None]).astype(np.float32)

    def loss_fn(p):  # the JAX package's training step loss
        logits = logits_fn(p, jnp.asarray(batch["features"]), jnp.asarray(valid))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(batch["gt_single"])[..., None],
                                   axis=-1)[..., 0]
        nll = jnp.where(mask > 0, nll, 0.0)
        return jnp.sum(nll) / jnp.maximum(mask.sum(), 1.0)

    return loss_fn


@pytest.mark.parametrize("tagger", ["framewise_linear", "framewise_hidden", "bilstm"])
def test_training_step_matches_jax(tagger):
    rng = np.random.RandomState(0)
    batch = _padded_batch(rng)
    train = TSplit(num_videos=2, n_classes=7, max_len=16, span_k=3, feature_dim=6)
    args = _tagger_args(ff_dropout_p=0.0, ff_hidden_layers=2 if tagger.endswith("hidden") else 0,
                        ff_hidden_dim=8, seq_hidden_size=10)
    if tagger == "bilstm":
        jmodel = jseq.SequentialDiscriminative(args, train)
        model = tseq.SequentialDiscriminative(args, train, device=CPU)
        module, convert = model.tagger, bridge.sequential_params_from_numpy
        lengths = jnp.asarray(batch["lengths"])

        def logits_fn(p, x, valid):
            return jseq._seq_logits(p, x, lengths, valid)
    else:
        jmodel = jfw.FramewiseDiscriminative(args, train)
        model = tfw.FramewiseDiscriminative(args, train, device=CPU)
        module, convert = model.mlp, bridge.framewise_params_from_numpy

        def logits_fn(p, x, valid):
            return jfw.mask_to_valid_classes(jfw.feed_forward_apply(p, x), valid)
    module.load_state_dict(convert(np_tree(jmodel.params), CPU))
    got = model.loss(batch)
    got.backward()
    want, grads = jax.value_and_grad(_jax_loss(logits_fn, batch))(jmodel.params)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    want_grads = convert(np_tree(grads), CPU)
    for name, p in module.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_masked_nll_selects_out_padded_frames():
    """An out-of-task label on a padded frame changes neither the loss nor
    its gradient (a multiply-out would give NaN)."""
    logits = torch.randn(1, 4, 3, requires_grad=True)
    valid = torch.tensor([True, True, False])
    mask = torch.tensor([[True, True, True, False]])
    losses, grads = [], []
    for pad_label in (0, 2):
        gt = torch.tensor([[0, 1, 0, pad_label]])
        loss = tfw.masked_nll(tfw.mask_to_valid_classes(logits, valid), gt, mask)
        (grad,) = torch.autograd.grad(loss, logits)
        losses.append(loss)
        grads.append(grad)
    assert torch.isfinite(losses[1]) and torch.isfinite(grads[1]).all()
    assert torch.equal(losses[0], losses[1]) and torch.equal(grads[0], grads[1])


# ----- dropout -----


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(3)
    out = tfw.feed_forward_apply(lambda h: h, x, dropout_p=0.3, generator=gen)
    kept = out != 0
    # 100,000 Bernoulli(0.7) draws: the keep rate within 5 standard errors
    assert abs(kept.float().mean().item() - 0.7) < 5 * np.sqrt(0.21 / x.numel())
    assert torch.all(out[kept] == torch.tensor(1 / 0.7, dtype=torch.float32))
    # no generator (predict) or p = 0: no dropout
    assert torch.equal(tfw.feed_forward_apply(lambda h: h, x, dropout_p=0.3), x)
    assert torch.equal(tfw.feed_forward_apply(lambda h: h, x, 0.0, gen), x)


def test_dropout_fits_repeat_with_one_seed():
    train = TSplit(num_videos=4, n_classes=3, max_len=12, span_k=3, feature_dim=5)
    params = []
    for seed in (5, 5, 6):
        args = _tagger_args(ff_dropout_p=0.5, epochs=2, seed=seed)
        model = tfw.FramewiseDiscriminative(args, train, device=CPU)
        with torch.no_grad():  # one start, so only the masks can differ
            for p in model.mlp.parameters():
                p.fill_(0.1)
        model.fit(train, use_labels=True)
        params.append(model.mlp.state_dict())
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])
    assert not all(torch.equal(params[0][k], params[2][k]) for k in params[0])


# ----- twins of the JAX package's baseline tests -----


def test_framewise_discriminative_twin(mini_crosstask):  # noqa: F811
    """tests/test_baseline_models.py::test_framewise_discriminative."""
    root, _ = mini_crosstask
    stats = quiet_main(tmain, _base_argv(root, "framewise_discriminative")
                       + ["--epochs", "3", "--lr", "1e-2"], device="cpu")
    for task, s in stats["all"].items():
        assert s["mof"][0] / s["mof"][1] > 0.5, task


def test_sequential_discriminative_twin(mini_crosstask):  # noqa: F811
    """tests/test_baseline_models.py::test_sequential_discriminative."""
    root, _ = mini_crosstask
    stats = quiet_main(tmain, _base_argv(root, "sequential_discriminative")
                       + ["--epochs", "2", "--lr", "1e-2", "--seq_hidden_size", "32"],
                       device="cpu")
    assert "all" in stats
    for s in stats["all"].values():
        assert np.isfinite(s["mof"][0])


def test_framewise_baseline_majority_twin(mini_crosstask):  # noqa: F811
    """tests/test_baseline_models.py::test_framewise_baseline_majority."""
    root, _ = mini_crosstask
    stats = quiet_main(tmain, _base_argv(root, "framewise_baseline")
                       + ["--framewise_baseline_type", "majority_class"], device="cpu")
    for s in stats["all"].values():
        n, d = s["predicted_label_types_per_video"]
        assert n / d == 1.0


def test_sequential_predict_constraints_twin(mini_crosstask):  # noqa: F811
    """tests/test_baseline_models.py::test_sequential_predict_constraints:
    the fixture's constraints are the true step intervals."""
    root, _ = mini_crosstask
    stats = quiet_main(tmain, _base_argv(root, "sequential_predict_constraints"),
                       device="cpu")
    for task, s in stats["all"].items():
        assert s["mof_non_bg"][0] / s["mof_non_bg"][1] > 0.9, task


def test_gm_covariance_all_types_twin():
    """tests/test_model_variants.py::test_gm_covariance_all_types."""
    data = TSplit(num_videos=30, n_classes=3, max_len=24, span_k=4, feature_dim=8, seed=0)
    want_ndim = {"tied_diag": 1, "diag": 2, "full": 3, "tied": 2}
    for cov_type, ndim in want_ndim.items():
        args = _tagger_args(gm_covariance=cov_type)
        model = tfw.FramewiseGaussianMixture.from_args(args, data, device=CPU)
        model.fit(data, use_labels=True)
        assert model.cov.ndim == ndim, cov_type
        if cov_type == "full":
            assert model.cov.shape[0] == 3
        preds = model.predict(data)
        match = sum(int((np.asarray(p) == data.gt_single(n)).sum()) for n, p in preds.items())
        total = sum(len(data.gt_single(n)) for n in preds)
        assert match / total > 0.6, (cov_type, match / total)


def test_framewise_gaussian_pipeline_twin(mini_crosstask):  # noqa: F811
    """tests/test_crosstask_pipeline.py::test_framewise_gaussian_pipeline."""
    root, _ = mini_crosstask
    for extra in ([], ["--gm_covariance", "full"]):
        stats = quiet_main(tmain, _base_argv(root, "framewise_gaussian_mixture") + extra,
                           device="cpu")
        for task, s in stats["all"].items():
            assert s["mof"][0] / s["mof"][1] > 0.5, (extra, task)


def test_sequential_baselines_pipeline_twin(mini_crosstask):  # noqa: F811
    """tests/test_crosstask_pipeline.py::test_sequential_baselines_pipeline."""
    root, _ = mini_crosstask
    stats = quiet_main(tmain, _base_argv(root, "sequential_ground_truth"), device="cpu")
    for s in stats["all"].values():
        assert s["mof"][0] / s["mof"][1] == 1.0
    assert "all" in quiet_main(tmain, _base_argv(root, "sequential_canonical_baseline"),
                               device="cpu")


def test_breakfast_gaussian_mixture_matches_jax(tmp_path):
    """tests/test_breakfast_pipeline.py's Gaussian-mixture case: the PCA
    features of a mini Breakfast release, both packages on them."""
    root = str(tmp_path)
    tgen.write_mini_breakfast(root, np.random.RandomState(0))
    tbf.pca_and_serialize_features(
        mapping_file=str(tmp_path / "breakfast" / "mapping.txt"),
        feature_root=str(tmp_path / "breakfast" / "reduced_fv_64"),
        label_root=str(tmp_path / "breakfast" / "BreakfastII_15fps_qvga_sync"),
        output_feature_root=str(tmp_path / "breakfast" / "breakfast_processed"
                                / "breakfast_pca-64_with-bkg_by-task"),
        remove_background=False, pca_components_per_group=64, by_task=True,
        task_ids=list(tgen.BREAKFAST_TASKS.keys()), device="cpu",
    )
    argv = ["--classifier", "framewise_gaussian_mixture", "--dataset", "breakfast",
            "--features", "pca", "--pca_components_per_group", "64", "--data_root", root,
            "--epochs", "1"]
    got = quiet_main(tmain, argv, device="cpu")
    assert set(got) == {"s1", "s2", "s3", "s4"}
    assert_stats_equal(got, quiet_main(jmain, argv))


# ----- pickles -----

PICKLE_CASES = ["gmm_full", "majority", "canonical", "constraints", "oracle",
                "framewise_hidden", "bilstm"]


def _fitted(root, case):
    argv = _base_argv(root, CLASSIFIER_CASES[case][0]) + CLASSIFIER_CASES[case][1:]
    args = tmain.build_parser().parse_args(argv + ["--epochs", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        train, _, test = next(iter(tmain.make_data_splits(args).values()))
    model = tmain.CLASSIFIERS[args.classifier].from_args(args, train, device=CPU)
    model.fit(train, use_labels=True)
    return model, test


def _tensors(model):
    out = {}
    for key, value in vars(model).items():
        if isinstance(value, torch.nn.Module):
            out.update({key + "." + k: v for k, v in value.state_dict().items()})
        elif isinstance(value, torch.Tensor):
            out[key] = value
    return out


@pytest.mark.parametrize("case", PICKLE_CASES)
def test_baseline_pickles_round_trip(mini_crosstask, monkeypatch, case):  # noqa: F811
    """A baseline pickles its weights on the CPU and no device; it loads
    onto the CPU when asked and predicts the same labels; loaded with no
    device it goes to the card, which raises where there is none."""
    root, _ = mini_crosstask
    model, test = _fitted(root, case)
    data = pickle.dumps(model)
    state = model.__getstate__()
    assert "device" not in state
    assert all(t.device == CPU for t in _tensors(model).values())
    loaded = checkpoint.loads(data, device="cpu")
    assert loaded.device == CPU and type(loaded) is type(model)
    assert _tensors(loaded).keys() == _tensors(model).keys()
    assert all(torch.equal(v, _tensors(model)[k]) for k, v in _tensors(loaded).items())
    np.random.seed(0)
    want = model.predict(test)
    np.random.seed(0)
    got = loaded.predict(test)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.loads(data)

