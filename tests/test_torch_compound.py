"""The port's compound HSMM and BiLSTM encoder against their JAX twins.

``action_segmentation_torch.models.compound.ComponentHsmm`` and
``models/rnn.py`` against ``action_segmentation_tpu.models.compound`` and
``models/rnn.py`` on the same numpy inputs and the same weights (JAX's
params carried across by ``bridge.compound_hsmm_params_from_numpy``; the
PRNG streams differ, so the two inits are compared by structure and
distribution only). z is held at its mean, or both packages get the same
noise array. Covered: the encoder on ragged lengths; compute_potentials
with z off, z at its mean, --no_sm_compound_structure,
--sm_reference_pooling, decomposed steps with constraints, class padding
and merged classes, and the flow; logZ and decoded labels; the
unsupervised loss with log_det and kl and one step's gradients; z's
padding invariance; and twins of tests/test_compound_and_flow.py and the
U7 pipeline tests of tests/test_crosstask_pipeline.py through the port's
``main.main(device="cpu")``. Tolerances: rtol 1e-5 / atol 1e-4 for
potentials, log-dets, KL and logZ; rtol 2e-3 for gradients; labels
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import bridge
from action_segmentation_torch.api import Segmenter as TSegmenter
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models.compound import ComponentHsmm as TComponent
from action_segmentation_torch.models.rnn import LSTMEncoder
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_torch.ops import hsmm as th
from action_segmentation_tpu.api import Segmenter as JSegmenter
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models import rnn as jrnn
from action_segmentation_tpu.models.compound import ComponentHsmm as JComponent
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from action_segmentation_tpu.ops import hsmm as jh
from tests.conftest import make_sm_args

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL = 2e-3
BIG_NEG = -1e9
D, E = 8, 16
C, NC = 6, 4  # classes, components of the decomposed-steps variant


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), rtol=rtol, atol=atol, err_msg=msg)


def test_lstm_encoder_matches_jax():
    """nn.LSTM over a packed batch against JAX's masked scan on JAX's
    weights: ragged lengths down to 1, zeros past each length."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 15, D).astype(np.float32)
    lengths = np.array([15, 9, 1, 12], np.int32)
    params = jrnn.lstm_init(jax.random.PRNGKey(0), D, 5, num_layers=2, xavier_w=True)
    enc = LSTMEncoder(D, 5, torch.Generator().manual_seed(0), num_layers=2, device="cpu")
    enc.load_state_dict({k[len("encoder."):]: v for k, v in bridge.tensors(
        bridge.lstm_params_from_numpy(np_tree(params)), "cpu").items()})
    got = enc(torch.from_numpy(x), torch.from_numpy(lengths))
    want = jrnn.lstm_apply(params, jnp.asarray(x), jnp.asarray(lengths))
    close(got, want)
    assert not got[2, 1:].any() and not got[1, 9:].any()


def structure(decompose):
    """ComponentHsmm's constructor arguments shared by both packages."""
    if not decompose:
        return dict(n_components=C, class_to_components={c: {c} for c in range(C)})
    return dict(
        n_components=NC,
        class_to_components={0: {0}, 1: {0, 1}, 2: {2}, 3: {1, 3}, 4: {3}, 5: {0, 2, 3}},
        allowed_starts={0, 1, 3},
        allowed_transitions={0: {1, 2}, 1: {2, 3, 5}, 2: {3, 4}, 3: {4, 5}, 4: {5}, 5: {0}},
        allowed_ends={4, 5},
        merge_classes={0: 0, 1: 1, 2: 2, 3: 3, 4: 2, 5: 2},
    )


VARIANTS = {
    "z off": dict(),
    "z at its mean": dict(sm_component_z_dim=4),
    "no compound structure": dict(sm_component_z_dim=4, sm_compound_structure=False),
    "reference pooling": dict(sm_component_z_dim=4, sm_reference_pooling=True),
    "decomposed steps": dict(sm_component_z_dim=4, decompose=True),
    "flow": dict(sm_component_z_dim=4, sm_feature_projection=True, flow_scale=True,
                 flow_scale_no_zero=True, flow_couple_layers=2, flow_hidden_units=8),
}


def component_pair(variant, **extra):
    """(JAX module, port module holding JAX's weights, args)."""
    overrides = dict(VARIANTS[variant], **extra)
    decompose = overrides.pop("decompose", False)
    args = make_sm_args(sm_max_span_length=6, sm_component_model=True,
                        sm_component_embedding_dim=E, sm_component_z_hidden_dim=8,
                        **overrides)
    kw = structure(decompose)
    jmod = JComponent(args, C, feature_dim=D, allow_self_transitions=True, **kw)
    tmod = TComponent(args, C, feature_dim=D, allow_self_transitions=True, device="cpu", **kw)
    tmod.load_state_dict(bridge.compound_hsmm_params_from_numpy(np_tree(jmod.params), "cpu"))
    return jmod, tmod, args


def inputs(seed=0, T=20, lengths=(20, 13, 1)):
    """features, lengths, vc (a padded class slot), cons, end_allowed."""
    rng = np.random.RandomState(seed)
    B = len(lengths)
    vc = np.array([0, 2, 3, 4, 5, -1], np.int64)
    feats = rng.randn(B, T, D).astype(np.float32)
    cons = (rng.rand(B, T, len(vc)) < 0.1).astype(np.float32) * -3.0
    end = np.zeros((B, len(vc)), np.float32)
    end[:, -1] = BIG_NEG
    return feats, np.asarray(lengths, np.int64), vc, cons, end


def both_potentials(jmod, tmod, arrays, use_mean=True, eps=None, monkeypatch=None):
    feats, lengths, vc, cons, end = arrays
    key = jax.random.PRNGKey(7)
    if eps is not None:
        monkeypatch.setattr(tmod, "_noise", lambda b, g, d: torch.from_numpy(eps))
    got = tmod.compute_potentials(*(torch.from_numpy(a) for a in arrays),
                                  use_mean_z=use_mean)
    want = jmod.compute_potentials(jmod.params, *map(jnp.asarray, arrays), key,
                                   use_mean_z=use_mean)
    return got, want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compute_potentials_match_jax(variant):
    """init, trans, lens, emit, end_mask, log_det and kl on the same
    weights, z at its mean; with z in the structure the factors differ
    per video. logZ and the traceback Viterbi's best score too."""
    jmod, tmod, _ = component_pair(variant)
    arrays = inputs()
    (pots, log_det, kl), (jpots, jld, jkl) = both_potentials(jmod, tmod, arrays)
    for name, got, want in zip(pots._fields, pots, jpots):
        close(got, want, msg=name)
    close(log_det, jld)
    close(kl, jkl)
    if tmod.structure_uses_z:
        assert not torch.equal(pots.trans[0], pots.trans[1])
    lengths = torch.from_numpy(arrays[1])
    close(th.hsmm_partition(pots, lengths), jh.hsmm_partition(jpots, jnp.asarray(arrays[1])))
    close(th.hsmm_viterbi(pots, lengths)[1], jh.hsmm_viterbi(jpots, jnp.asarray(arrays[1]))[1])


def test_sampled_z_matches_jax_on_the_same_noise(monkeypatch):
    """z drawn from its posterior: both packages fed JAX's noise array."""
    jmod, tmod, args = component_pair("z at its mean")
    eps = np.array(jax.vmap(lambda k: jax.random.normal(k, (args.sm_component_z_dim,)))(
        jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(jnp.arange(3))))
    (pots, _, kl), (jpots, _, jkl) = both_potentials(jmod, tmod, inputs(), use_mean=False,
                                                     eps=eps, monkeypatch=monkeypatch)
    for name, got, want in zip(pots._fields, pots, jpots):
        close(got, want, msg=name)
    close(kl, jkl)


def test_z_without_a_generator_raises():
    _, tmod, _ = component_pair("z at its mean")
    with pytest.raises(ValueError, match="generator"):
        tmod.compute_potentials(*(torch.from_numpy(a) for a in inputs()), use_mean_z=False)


def test_port_init_matches_jax_structure_and_distribution():
    """The port's own init: the names and shapes of JAX's params once
    bridged (strict load), xavier-bounded embeddings and weights,
    torch-default biases, zero per-class biases and emission bias."""
    jmod, _, args = component_pair("flow")
    own = TComponent(args, C, feature_dim=D, allow_self_transitions=True, device="cpu",
                     **structure(False))
    want = bridge.compound_hsmm_params_from_numpy(np_tree(jmod.params), "cpu")
    got = own.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        assert value.shape == want[name].shape, name
    emb_bound = np.sqrt(6 / (C + E))
    assert float(own.initial_embeddings.weight.detach().abs().max()) <= emb_bound
    assert float(own.transition_weights.bias.detach().abs().max()) <= 1 / np.sqrt(E + 4)
    for name in ("initial_bias", "transition_bias", "length_bias", "emission_mean_bias"):
        assert not got[name].any(), name
    # zero scale cells unless --flow_scale_no_zero (set in this variant)
    assert got["feature_projector.scale_cell0.out_layer.weight"].any()


def test_decode_labels_match_jax():
    """SemiMarkovModel decode (z at its mean) through Segmenter.segment_many,
    and segment_with_marginals, on the same weights."""
    args = make_sm_args(sm_max_span_length=8, sm_component_model=True,
                        sm_component_embedding_dim=E, sm_component_z_dim=4,
                        sm_component_z_hidden_dim=8)
    split = dict(num_videos=8, n_classes=3, max_len=30, span_k=5, feature_dim=D, seed=0)
    jm = JModel.from_args(args, JSplit(**split))
    tm = TModel.from_args(args, TSplit(**split), device="cpu")
    # spread the weights off the symmetric init, where labels would tie
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32),
        np_tree(jm.module.params))
    params["gaussian_cov"] = np.abs(params["gaussian_cov"]) + 0.5
    jm.module.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm.module.load_state_dict(bridge.compound_hsmm_params_from_numpy(params, "cpu"))
    test = TSplit(num_videos=6, n_classes=3, max_len=40, span_k=5, feature_dim=D, seed=1)
    feats = [test._samples[n]["features"] for n in sorted(test._samples)]
    got = TSegmenter(tm).segment_many(feats, batch_size=4)
    want = JSegmenter(jm).segment_many(feats, batch_size=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    labels, marg = TSegmenter(tm).segment_with_marginals(feats[0])
    jlabels, jmarg = JSegmenter(jm).segment_with_marginals(feats[0])
    np.testing.assert_array_equal(labels, jlabels)
    close(marg, jmarg, rtol=GRAD_RTOL, atol=2e-4)


def test_unsupervised_loss_and_gradients_match_jax(monkeypatch):
    """One unsupervised step: -wmean(logZ) - wmean(log_det) + wmean(kl)
    with z drawn from the same noise, its aux terms, and every
    parameter's gradient (rtol 2e-3), on a padded, weighted batch."""
    args = make_sm_args(sm_max_span_length=8, sm_component_model=True,
                        sm_component_embedding_dim=E, sm_component_z_dim=4,
                        sm_component_z_hidden_dim=8, sm_feature_projection=True,
                        flow_scale=True, flow_scale_no_zero=True, flow_couple_layers=2,
                        flow_hidden_units=8, batch_size=6)
    split = dict(num_videos=5, n_classes=3, max_len=24, span_k=5, feature_dim=D, seed=0)
    jm = JModel.from_args(args, JSplit(**split))
    tsplit = TSplit(**split)
    tm = TModel.from_args(args, tsplit, device="cpu")
    tm.module.load_state_dict(bridge.compound_hsmm_params_from_numpy(
        np_tree(jm.module.params), "cpu"))
    from action_segmentation_torch.data.batching import iter_batches

    batch = next(iter_batches(tsplit, batch_size=6, batch_by_task=True, shuffle=False))
    arrays = [t.numpy() for t in tm._training_batch(batch)]
    assert arrays[-1].tolist() == [1, 1, 1, 1, 1, 0]  # one padded row
    rng = jax.random.PRNGKey(11)
    eps = np.array(jax.vmap(lambda k: jax.random.normal(k, (4,)))(
        jax.vmap(lambda i: jax.random.fold_in(rng, i))(jnp.arange(6))))
    monkeypatch.setattr(tm.module, "_noise", lambda b, g, d: torch.from_numpy(eps))
    loss, aux = tm._loss(*(torch.from_numpy(a) for a in arrays), use_labels=False)
    loss.backward()
    (jloss, jaux), jgrads = jax.value_and_grad(jm._build_loss_fn(False), has_aux=True)(
        jm.module.params, *map(jnp.asarray, arrays), rng)
    close(loss, jloss)
    for key in ("nll", "kl", "log_det"):
        close(aux[key], jaux[key], msg=key)
    assert float(aux["kl"]) > 0 and float(aux["log_det"]) != 0
    want = bridge.compound_hsmm_params_from_numpy(np_tree(jgrads), "cpu")
    for name, p in tm.module.named_parameters():
        scale = float(want[name].abs().max())
        close(p.grad, want[name], rtol=GRAD_RTOL, atol=GRAD_RTOL * max(scale, 1e-3), msg=name)


def test_compound_z_padding_invariant():
    """Twin of tests/test_model_variants.py::test_compound_z_padding_invariant:
    the masked pool and the masked flow log-det make a video's z,
    potentials, KL and log-det independent of its batch's pad width. The
    reference's pool (--sm_reference_pooling) is not: batched with a
    longer video, a short video's pool takes its zero-padded frames."""
    data = TSplit(num_videos=6, n_classes=3, max_len=20, span_k=4, feature_dim=D, seed=0)
    rng = np.random.RandomState(0)
    T_real = 14
    feats = rng.randn(1, T_real, D).astype(np.float32)
    longer = rng.randn(1, T_real + 18, D).astype(np.float32)

    def run(model, T_pad, with_longer):
        f = np.zeros((1, T_pad, D), np.float32)
        f[:, :T_real] = feats
        lengths = [T_real]
        if with_longer:
            f = np.concatenate([f, longer[:, :T_pad]])
            lengths.append(T_pad)
        B, vc = len(lengths), torch.arange(model.n_classes)
        pots, log_det, kl = model.module.compute_potentials(
            torch.from_numpy(f), torch.tensor(lengths), vc,
            torch.zeros(B, T_pad, model.n_classes), torch.zeros(B, model.n_classes))
        return [as_numpy(x)[:1] for x in (log_det, kl, pots.trans, pots.emit[:, :T_real])]

    outs = {}
    for pooling in (False, True):
        args = make_sm_args(sm_max_span_length=8, sm_component_model=True,
                            sm_component_embedding_dim=16, sm_component_z_dim=8,
                            sm_feature_projection=True, flow_scale=True,
                            sm_reference_pooling=pooling)
        model = TModel.from_args(args, data, device="cpu")
        with torch.no_grad():
            outs[pooling] = [run(model, T_real, False), run(model, T_real + 18, False),
                             run(model, T_real + 18, True)]
    for alone, padded, batched in [outs[False]]:
        for x, y, z in zip(alone, padded, batched):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(x, z, rtol=1e-5, atol=1e-5)
    alone, padded, batched = outs[True]
    for x, y in zip(alone, padded):  # the window stops at the batch's longest video
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    assert np.abs(alone[1] - batched[1]).max() > 1e-4  # kl moves with the batch


@pytest.fixture(scope="module")
def toy_data():
    return TSplit(num_videos=30, n_classes=3, max_len=24, span_k=5, feature_dim=D, seed=0)


def test_component_model_trains(toy_data):
    """Twin of tests/test_compound_and_flow.py::test_component_model_trains."""
    args = make_sm_args(sm_max_span_length=10, sm_component_model=True,
                        sm_component_embedding_dim=16, epochs=2, lr=1e-2)
    model = TModel.from_args(args, toy_data, device="cpu")
    losses = []
    model.fit(toy_data, use_labels=False,
              callback_fn=lambda e, s: losses.append(s["train_loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    preds = model.predict(toy_data)
    assert all(len(p) > 0 for p in preds.values())


def test_component_model_with_vae_z(toy_data):
    """Twin of tests/test_compound_and_flow.py::test_component_model_with_vae_z;
    the epoch's KL is reported."""
    args = make_sm_args(sm_max_span_length=10, sm_component_model=True,
                        sm_component_embedding_dim=16, sm_component_z_dim=4,
                        sm_component_z_hidden_dim=16, epochs=1, lr=1e-2)
    model = TModel.from_args(args, toy_data, device="cpu")
    stats = []
    model.fit(toy_data, use_labels=False, callback_fn=lambda e, s: stats.append(s))
    assert np.isfinite([s["train_loss"] for s in stats]).all()
    assert stats[0]["train_kl_vid_avg"] > 0
    preds = model.predict(toy_data)
    assert all(len(p) > 0 for p in preds.values())


def test_closed_form_refuses_the_component_model(toy_data):
    model = TModel.from_args(make_sm_args(sm_component_model=True), toy_data, device="cpu")
    with pytest.raises(NotImplementedError, match="component model"):
        model.fit(toy_data, use_labels=True)


def test_latent_noise_depends_on_seed_epoch_and_batch_only(toy_data):
    """A batch's noise generator is seeded from (--seed, epoch, batch):
    the same draws whenever that batch runs, other draws elsewhere."""
    args = make_sm_args(sm_component_model=True, sm_component_embedding_dim=16,
                        sm_component_z_dim=4, seed=3)
    model = TModel.from_args(args, toy_data, device="cpu")

    def draw(epoch, batch):
        return torch.randn(4, generator=model._noise_generator(epoch, batch, False))

    assert torch.equal(draw(1, 2), draw(1, 2))
    assert not torch.equal(draw(1, 2), draw(2, 1))
    assert not torch.equal(draw(1, 2), draw(1, 3))
    assert model._noise_generator(1, 2, True) is None
    # every seed its own stream, 0 and 1 included
    draws = {}
    for seed in (0, 1, 3):
        model.args.seed = seed
        draws[seed] = draw(0, 0)
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[3])
    assert not torch.equal(draws[0], draws[3])


@pytest.fixture(scope="module")
def mini_crosstask(tmp_path_factory):
    from action_segmentation_torch.data.minigen import write_mini_crosstask

    root = str(tmp_path_factory.mktemp("data"))
    write_mini_crosstask(root, np.random.RandomState(0))
    return root


def _base_argv(root):
    from action_segmentation_torch.data.minigen import DIM_PER_GROUP

    return ["--classifier", "semimarkov", "--dataset", "crosstask", "--features", "pca",
            "--pca_components_per_group", str(DIM_PER_GROUP), "--data_root", root,
            "--mix_tasks", "--task_specific_steps", "--training", "unsupervised",
            "--sm_component_model", "--sm_component_embedding_dim", "16", "--epochs", "1",
            "--sm_max_span_length", "10", "--lr", "1e-2"]


def test_u7_component_model_pipeline(mini_crosstask):
    """Twin of tests/test_crosstask_pipeline.py::test_u7_component_model_pipeline
    through the port's command line: the unsupervised compound HSMM with
    canonical-ordering constraints and narration at train."""
    from action_segmentation_torch import main as tmain

    stats = tmain.main(_base_argv(mini_crosstask) + [
        "--annotate_background_with_previous", "--sm_constrain_transitions",
        "--sm_constrain_with_narration", "train"], device="cpu")
    assert "all" in stats
    for task, s in stats["all"].items():
        assert np.isfinite(s["mof"][0]), task


def test_component_decompose_steps(mini_crosstask):
    """Twin of tests/test_crosstask_pipeline.py::test_component_decompose_steps:
    classes embed as the mean of their word components, shared across
    tasks."""
    from action_segmentation_torch import main as tmain

    stats = tmain.main(_base_argv(mini_crosstask) + ["--sm_component_decompose_steps"],
                       device="cpu")
    assert "all" in stats
    for task, s in stats["all"].items():
        assert np.isfinite(s["mof"][0]), task
