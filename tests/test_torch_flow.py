"""The port's small nets and NICE flow against their JAX twins.

``action_segmentation_torch.models.nn`` and ``models/flow.py`` against
``action_segmentation_tpu.models.nn`` and ``models/flow.py`` on the same
numpy inputs and the same weights (the JAX params, carried across by
``bridge.py``; the two packages' PRNG streams differ, so their own inits
are compared by distribution only). The Gaussian HSMM with the flow
(--sm_feature_projection): its potentials, masked per-step log-det and
loss, one supervised step's gradients, the moment init in the projected
space, and --sm_init_non_projection_parameters_from. Tolerances:
rtol 1e-5 / atol 1e-4 for outputs, potentials and log-dets; rtol 2e-3
for gradients (docs/DESIGN.md:111).
"""

import argparse
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch import bridge
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models import flow as tflow
from action_segmentation_torch.models import nn as tnn
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models import flow as jflow
from action_segmentation_tpu.models import nn as jnn
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from tests.conftest import make_sm_args

RTOL, ATOL = 1e-5, 1e-4
GRAD_RTOL = 2e-3
D = 8
SPLIT = dict(num_videos=12, n_classes=3, max_len=24, span_k=5, feature_dim=D, seed=0)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), rtol=rtol, atol=atol, err_msg=msg)


def flow_args(scale=False, no_zero=False, units=6, layers=1, couple=4):
    return argparse.Namespace(flow_hidden_layers=layers, flow_hidden_units=units,
                              flow_couple_layers=couple, flow_scale=scale,
                              flow_scale_no_zero=no_zero)


def load_flat(module, flat, prefix):
    """Load a flat dict of ``bridge.py``'s names, `prefix` cut off."""
    module.load_state_dict({k[len(prefix):]: v for k, v in bridge.tensors(flat, "cpu").items()})
    return module


def port_flow(args, jparams):
    """The port's NiceFlow holding JAX's flow weights."""
    return load_flat(tflow.NiceFlow(args, D, torch.Generator().manual_seed(0)),
                     bridge.flow_params_from_numpy(np_tree(jparams)), "feature_projector.")


def test_linear_mlp_and_residual_mlp_match_jax():
    """The three building blocks on JAX's weights, transposed."""
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7, 6).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)

    lin = jnn.linear_init(key, 6, 4, xavier=True)
    layer = load_flat(tnn.linear(6, 4, gen), bridge._linear(np_tree(lin), "x"), "x.")
    close(layer(torch.from_numpy(x)), jnn.linear(lin, jnp.asarray(x)))

    mlp = jnn.mlp_init(key, [6, 9, 3])
    port = tnn.MLP([6, 9, 3], gen)
    flat = {}
    for i, p in enumerate(np_tree(mlp)["layers"]):
        flat.update(bridge._linear(p, "layers.{}".format(i)))
    load_flat(port, flat, "")
    for final in (False, True):
        close(port(torch.from_numpy(x), final_activation=final),
              jnn.mlp_apply(mlp, jnp.asarray(x), final_activation=final))

    res = jnn.residual_mlp_init(key, 6, 5, 2, n_residual=2)
    port = load_flat(tnn.residual_mlp(6, 5, 2, 2, gen), bridge._residual_mlp(np_tree(res), "m"),
                     "m.")
    close(port(torch.from_numpy(x)), jnn.residual_mlp_apply(res, jnp.asarray(x)))


def test_init_distributions_match_jax():
    """The port's own draws follow JAX's distributions: xavier-uniform
    weights within sqrt(6 / (fan_in + fan_out)), every bias (xavier path
    too) and every default weight within 1/sqrt(fan_in), and the zero
    path all zeros. Shapes equal JAX's, transposed."""
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    for xavier in (False, True):
        layer = tnn.linear(400, 300, gen, xavier=xavier)
        want = jnn.linear_init(key, 400, 300, xavier=xavier)
        assert layer.weight.shape == want["w"].T.shape
        w_bound = np.sqrt(6 / 700) if xavier else 1 / np.sqrt(400)
        for got, ref, bound in ((layer.weight, want["w"], w_bound),
                                (layer.bias, want["b"], 1 / np.sqrt(400))):
            for x in (got.detach().numpy(), np.asarray(ref)):
                # within the bound, and spread over it
                assert 0.9 * bound < np.abs(x).max() <= bound
    zero = tnn.linear(4, 3, gen, zero=True)
    assert not zero.weight.any() and not zero.bias.any()


@pytest.mark.parametrize("scale,no_zero", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("per_step", [False, True])
def test_nice_flow_matches_jax(scale, no_zero, per_step):
    """h and log_det of the NICE flow (additive, affine with zero scale
    cells, affine with live ones) on JAX's weights, for (B, T, D) frames
    and per frame."""
    args = flow_args(scale, no_zero)
    jparams = jflow.nice_init(jax.random.PRNGKey(2), args, D)
    flow = port_flow(args, jparams)
    x = np.random.RandomState(3).randn(3, 11, D).astype(np.float32)
    h, log_det = flow(torch.from_numpy(x), per_step=per_step)
    jh, jld = jflow.nice_apply(jparams, jnp.asarray(x), per_step=per_step)
    close(h, jh)
    close(log_det, jld)
    assert log_det.shape == tuple(jld.shape)


def _nice_invert(flow, h):
    """Test-local inverse of the coupling stack: reversed layer order, the
    odd layers transform the first half from the second."""
    half = h.shape[-1] // 2
    out = h
    for i in reversed(range(flow.couple_layers)):
        h1, h2p = out[..., :half], out[..., half:]
        if i % 2 == 1:
            h1, h2p = h2p, h1
        t = getattr(flow, "cell{}".format(i))(h1)
        if flow.scale:
            h2 = (h2p - t) * torch.exp(-getattr(flow, "scale_cell{}".format(i))(h1))
        else:
            h2 = h2p - t
        if i % 2 == 1:
            h1, h2 = h2, h1
        out = torch.cat([h1, h2], dim=-1)
    return out


def test_nice_flow_invertibility_props():
    """Twin of tests/test_compound_and_flow.py::test_nice_flow_invertibility_props
    on the port's own draws: the additive log-det is zero and the flow
    inverts; zero scale cells reproduce the additive flow's h (the
    coupling nets draw the same numbers); live scale cells give a
    nonzero log-det and still invert."""
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 5, D).astype(np.float32))

    def build(**kw):
        return tflow.NiceFlow(flow_args(units=8, **kw), D, torch.Generator().manual_seed(0))

    additive = build()
    h_add, log_det = additive(x)
    assert h_add.shape == x.shape and not log_det.any()
    close(_nice_invert(additive, h_add), x, atol=1e-5)
    h, log_det = build(scale=True)(x)
    assert not log_det.any()
    close(h, h_add, rtol=1e-6, atol=1e-6)
    affine = build(scale=True, no_zero=True)
    h, log_det = affine(x)
    assert float(log_det.detach().abs().max()) > 0
    close(_nice_invert(affine, h), x, rtol=1e-4, atol=1e-4)


def flow_model_pair(**overrides):
    """(JAX model, port model holding JAX's weights, port split) of a
    Gaussian HSMM with the flow, after the moment init."""
    args = make_sm_args(sm_max_span_length=10, sm_feature_projection=True, flow_scale=True,
                        flow_scale_no_zero=True, flow_couple_layers=2, flow_hidden_units=8,
                        **overrides)
    jtrain, ttrain = JSplit(**SPLIT), TSplit(**SPLIT)
    jm = JModel.from_args(args, jtrain)
    tm = TModel.from_args(args, ttrain, device="cpu")
    tm.module.load_state_dict(bridge.gaussian_hsmm_params_from_numpy(
        np_tree(jm.module.params), "cpu"))
    feats = [ttrain._samples[n]["features"] for n in sorted(ttrain._samples)]
    jm.module.initialize_gaussian(feats)
    tm.module.initialize_gaussian(feats)
    return jm, tm, ttrain


def test_moment_init_in_projected_space_matches_jax():
    jm, tm, _ = flow_model_pair()
    for name in ("gaussian_means", "gaussian_cov"):
        close(getattr(tm.module, name), jm.module.params[name], msg=name)


def batch_arrays(split, model, T_extra=6):
    """A padded training batch (the port's arrays as numpy)."""
    from action_segmentation_torch.data.batching import iter_batches

    batch = next(iter_batches(split, batch_size=6, batch_by_task=True, shuffle=False))
    pad = np.zeros(batch["features"].shape[:1] + (T_extra, D), np.float32)
    batch["features"] = np.concatenate([batch["features"], pad], axis=1)
    batch["gt_single"] = np.pad(batch["gt_single"], ((0, 0), (0, T_extra)))
    return [t.numpy() for t in model._training_batch(batch)]


def test_flow_potentials_log_det_and_loss_match_jax():
    """compute_potentials (the masked per-frame log-det over a padded
    batch), the loss -wmean(gold) - wmean(log_det) and its gradients, on
    the same weights and the same padded batch."""
    jm, tm, ttrain = flow_model_pair(sm_supervised_method="gradient-based")
    arrays = batch_arrays(ttrain, tm)
    features, lengths, vc, inv_map, gt, cons, end_allowed, weights = arrays
    assert (lengths < features.shape[1]).all()  # every video has padded frames
    t_in = [torch.from_numpy(a) for a in arrays]
    pots, log_det, kl = tm.module.compute_potentials(
        t_in[0], t_in[1].long(), t_in[2], t_in[5], t_in[6])
    jpots, jld, jkl = jm.module.compute_potentials(
        jm.module.params, *map(jnp.asarray, (features, lengths, vc, cons, end_allowed)),
        jax.random.PRNGKey(0), use_mean_z=True)
    for name, got, want in zip(pots._fields, pots, jpots):
        close(got, want, msg=name)
    close(log_det, jld)
    assert not kl.any()

    loss, aux = tm._loss(*t_in, use_labels=True)
    loss.backward()
    jloss_fn = jm._build_loss_fn(use_labels=True)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jm.module.params, *map(jnp.asarray, arrays), jax.random.PRNGKey(0))
    close(loss, jloss)
    for key in ("nll", "log_det", "kl"):
        close(aux[key], jaux[key], msg=key)
    want = bridge.gaussian_hsmm_params_from_numpy(np_tree(jgrads), "cpu")
    for name, p in tm.module.named_parameters():
        close(p.grad, want[name], rtol=GRAD_RTOL, atol=1e-4, msg=name)


def test_flow_projector_trains():
    """Twin of tests/test_compound_and_flow.py::test_flow_projector_trains."""
    train = TSplit(num_videos=30, n_classes=3, max_len=24, span_k=5, feature_dim=D, seed=0)
    args = make_sm_args(sm_max_span_length=10, sm_feature_projection=True, flow_couple_layers=2,
                        flow_hidden_units=16, sm_supervised_method="gradient-based", epochs=2,
                        lr=1e-2)
    model = TModel.from_args(args, train, device="cpu")
    losses = []
    model.fit(train, use_labels=True, callback_fn=lambda e, s: losses.append(s["train_loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_closed_form_refuses_the_flow():
    train = TSplit(**SPLIT)
    model = TModel.from_args(make_sm_args(sm_feature_projection=True), train, device="cpu")
    with pytest.raises(NotImplementedError, match="feature projector"):
        model.fit(train, use_labels=True)


def test_init_non_projection_parameters_from(tmp_path):
    """Twin of tests/test_model_variants.py::test_init_non_projection_parameters_from:
    every non-flow weight comes from a pickled model, the flow stays."""
    train = TSplit(num_videos=20, n_classes=3, max_len=40, span_k=5, seed=0)
    base = TModel.from_args(make_sm_args(sm_max_span_length=10), train, device="cpu")
    base.fit(train, use_labels=True)
    path = str(tmp_path / "base.pkl")
    with open(path, "wb") as f:
        pickle.dump(base, f)
    args = make_sm_args(sm_max_span_length=10, sm_feature_projection=True, flow_couple_layers=2,
                        flow_hidden_units=8, sm_init_non_projection_parameters_from=path,
                        epochs=0)
    warm = TModel.from_args(args, train, device="cpu")
    for name, value in base.module.state_dict().items():
        np.testing.assert_array_equal(warm.module.state_dict()[name].numpy(), value.numpy())
    assert warm.module.feature_projector is not None
    assert any(k.startswith("feature_projector.") for k in warm.module.state_dict())
