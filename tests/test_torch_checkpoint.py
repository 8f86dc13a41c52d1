"""The port's checkpoints, pickles and reference state-dict exchange.

Twins of tests/test_checkpoint.py on the port (``checkpoint.py`` with
torch files in orbax's place), a resumed run against an uninterrupted
one (losses and parameters at rtol 1e-6: on the CPU both runs do the
same float32 operations in the same order), the Gaussian HSMM crossing
between the packages through the reference state dict in both directions
(parameters at rtol 1e-5, decoded labels equal), pickles that hold no
device, and ``Segmenter.load`` (a twin of
tests/test_api.py::test_segmenter_roundtrip).
"""

import argparse
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from action_segmentation_torch import checkpoint as ckpt
from action_segmentation_torch.api import Segmenter as TSegmenter
from action_segmentation_torch.data.synthetic import SyntheticDatasplit as TSplit
from action_segmentation_torch.models.semimarkov import SemiMarkovModel as TModel
from action_segmentation_tpu import checkpoint as jckpt
from action_segmentation_tpu.api import Segmenter as JSegmenter
from action_segmentation_tpu.data.synthetic import SyntheticDatasplit as JSplit
from action_segmentation_tpu.models.semimarkov import SemiMarkovModel as JModel
from tests.conftest import make_sm_args

CPU = torch.device("cpu")
TRAIN = dict(num_videos=20, n_classes=3, max_len=20, span_k=4, seed=0)


def make_args(**overrides):
    return make_sm_args(**overrides)


def test_train_checkpoint_and_resume(tmp_path):
    train = TSplit(**TRAIN)
    ck_dir = str(tmp_path / "run")
    common = dict(sm_max_span_length=8, sm_supervised_method="gradient-based", lr=1e-2,
                  checkpoint_dir=ck_dir, checkpoint_every=1)
    model = TModel.from_args(make_args(epochs=2, **common), train, device=CPU)
    model.fit(train, use_labels=True)
    assert ckpt.latest_step(ck_dir) == 1
    assert sorted(os.listdir(ck_dir)) == [
        "step_0.args.json", "step_0.pt", "step_1.args.json", "step_1.pt"]

    # resume: continue to more epochs without redoing earlier ones
    model2 = TModel.from_args(make_args(epochs=3, resume=True, **common), train, device=CPU)
    epochs_seen = []
    model2.fit(train, use_labels=True, callback_fn=lambda e, s: epochs_seen.append(e))
    assert epochs_seen == [2], epochs_seen  # only the resumed epoch runs
    assert ckpt.latest_step(ck_dir) == 2


def test_init_subset_from():
    params = {"a": torch.zeros(3), "feature_projector.w": torch.zeros(2)}
    src = {"a": torch.ones(3), "feature_projector.w": torch.ones(2), "extra": torch.ones(1)}
    out = ckpt.init_subset_from(params, src)
    np.testing.assert_array_equal(out["a"].numpy(), np.ones(3))
    np.testing.assert_array_equal(out["feature_projector.w"].numpy(), np.zeros(2))
    assert "extra" not in out


def test_train_state_checkpoint_roundtrip(tmp_path):
    """Resume restores the FULL train state: params, Adam moments, and
    the plateau scheduler's live learning rate (a params-only restore
    silently resets optimizer state)."""
    module = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(module.parameters(), lr=1e-2)
    module(torch.ones(4, 3)).sum().backward()  # one update: nonzero moments
    opt.step()

    args = argparse.Namespace(lr=5e-3, foo="bar", nested={"not": "json"})
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint({"params": module.state_dict(), "opt_state": opt.state_dict()},
                         args, 3, d, lr=1e-3)
    state, args_dict, step = ckpt.load_checkpoint(d)
    assert step == 3 and args_dict == {"lr": 5e-3, "foo": "bar"}
    fresh = torch.nn.Linear(3, 2)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    fresh.load_state_dict(state["params"])
    fresh_opt.load_state_dict(state["opt_state"])
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy())
    for p, q in zip(module.parameters(), fresh.parameters()):
        got, want = fresh_opt.state[q], opt.state[p]
        assert set(got) == set(want) == {"step", "exp_avg", "exp_avg_sq"}
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert ckpt.load_meta(d, step)["lr"] == 1e-3
    assert ckpt.load_meta(d, 4) is None


def test_resume_restores_plateau_state(tmp_path):
    """Resume must restore the plateau controller's POST-step
    best/num_bad, not just the rate: a reset best=inf counts the next
    epoch as an improvement and skips a pending LR cut."""
    train = TSplit(**TRAIN)
    ck_dir = str(tmp_path / "run")
    common = dict(sm_max_span_length=8, sm_supervised_method="gradient-based", lr=1e-2,
                  checkpoint_dir=ck_dir, checkpoint_every=1)
    TModel.from_args(make_args(epochs=2, **common), train, device=CPU).fit(
        train, use_labels=True)
    step = ckpt.latest_step(ck_dir)
    sched = ckpt.load_meta(ck_dir, step)["sched"]
    assert np.isfinite(sched["best"])  # a real epoch loss, not a reset

    # resume with epochs == step+1: no epoch runs, so the controller
    # after fit IS the restored one
    model2 = TModel.from_args(make_args(epochs=step + 1, resume=True, **common), train,
                              device=CPU)
    model2.fit(train, use_labels=True)
    st = model2._scheduler
    assert (st.lr, st.best, st.num_bad) == (sched["lr"], sched["best"], sched["num_bad"])


COMPOUND_Z = dict(sm_component_model=True, sm_component_embedding_dim=8,
                  sm_component_z_dim=4, sm_component_z_hidden_dim=8)


@pytest.mark.parametrize("use_labels,model", [(False, {}), (True, {}), (False, COMPOUND_Z)],
                         ids=["unsupervised", "supervised", "compound with z"])
def test_resumed_run_matches_uninterrupted(tmp_path, use_labels, model):
    """--epochs 2 then --epochs 3 --resume gives the uninterrupted 3-epoch
    run's epoch-2 loss and final parameters (rtol 1e-6); a patience of 0
    moves the learning rate inside the run. The compound model with a
    latent draws each batch's noise from (seed, epoch, batch), so its
    resumed epoch draws what the uninterrupted one drew."""
    train = TSplit(**TRAIN)
    common = dict(sm_max_span_length=8, sm_supervised_method="gradient-based", lr=5e-2,
                  checkpoint_every=1, reduce_plateau_patience=0, reduce_plateau_min_lr=1e-5,
                  **model)

    def run(ck_dir, epochs, resume=False):
        model = TModel.from_args(
            make_args(epochs=epochs, resume=resume, checkpoint_dir=ck_dir, **common),
            train, device=CPU)
        stats = {}
        model.fit(train, use_labels=use_labels,
                  callback_fn=lambda e, s: stats.__setitem__(e, s["train_loss"]))
        return model, stats

    whole, whole_stats = run(str(tmp_path / "whole"), 3)
    run(str(tmp_path / "split"), 2)
    resumed, resumed_stats = run(str(tmp_path / "split"), 3, resume=True)
    assert sorted(whole_stats) == [0, 1, 2] and sorted(resumed_stats) == [2]
    np.testing.assert_allclose(resumed_stats[2], whole_stats[2], rtol=1e-6)
    want = whole.module.state_dict()
    for k, v in resumed.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
    assert resumed._scheduler.lr == whole._scheduler.lr


def _closed_form(cls_split, cls_model, **kw):
    train = cls_split(num_videos=40, n_classes=3, max_len=40, span_k=5, seed=0)
    model = cls_model.from_args(
        make_args(sm_max_span_length=20, sm_supervised_method="closed-form"), train, **kw)
    model.fit(train, use_labels=True)
    return model


def _test_features():
    test = TSplit(num_videos=8, n_classes=3, max_len=40, span_k=5, seed=1)
    return [test._samples[n]["features"] for n in sorted(test._samples)]


def _perturbed(params, seed):
    """The fitted parameters moved off the closed form, so the exchange
    carries weights neither package would derive on its own."""
    rng = np.random.RandomState(seed)
    out = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k in ("poisson_log_rates", "transition_logits", "init_logits", "gaussian_means"):
        out[k] = out[k] + 0.1 * rng.randn(*out[k].shape).astype(np.float32)
    return out


def test_reference_state_dict_jax_to_port():
    """JAX params -> JAX's reference_state_dict_from_params -> the port's
    params_from_reference_state_dict: the port decodes JAX's labels."""
    jm = _closed_form(JSplit, JModel)
    jm.module.params = jax.tree_util.tree_map(
        jax.numpy.asarray, _perturbed(jax.tree_util.tree_map(np.asarray, jm.module.params), 0))
    sd = jckpt.reference_state_dict_from_params(jm.module.params)
    assert sd["gaussian_cov"].ndim == 2
    params, skipped = ckpt.params_from_reference_state_dict(
        {"model." + k: torch.tensor(v) for k, v in sd.items()}, device=CPU)
    assert skipped == []
    tm = _closed_form(TSplit, TModel, device=CPU)
    tm.module.load_state_dict(params)
    for k, v in tm.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm.module.params[k]), rtol=1e-5,
                                   err_msg=k)
    feats = _test_features()
    got = TSegmenter(tm).segment_many(feats, batch_size=4)
    want = JSegmenter(jm).segment_many(feats, batch_size=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reference_state_dict_port_to_jax():
    """The port's state dict -> the port's reference_state_dict_from_params
    -> JAX's params_from_reference_state_dict: JAX decodes the port's
    labels."""
    tm = _closed_form(TSplit, TModel, device=CPU)
    sd0 = {k: v.numpy() for k, v in tm.module.state_dict().items()}
    tm.module.load_state_dict(
        {k: torch.from_numpy(v) for k, v in _perturbed(sd0, 1).items()})
    sd = ckpt.reference_state_dict_from_params(tm.module.state_dict())
    assert sd["gaussian_cov"].ndim == 2
    sd["init_constraints"] = np.zeros(3, np.float32)  # a buffer: skipped
    params, skipped = jckpt.params_from_reference_state_dict(sd)
    assert skipped == ["init_constraints"]
    jm = _closed_form(JSplit, JModel)
    jm.module.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    for k, v in tm.module.state_dict().items():
        np.testing.assert_allclose(np.asarray(params[k]), v.numpy(), rtol=1e-5, err_msg=k)
    feats = _test_features()
    got = JSegmenter(jm).segment_many(feats, batch_size=4)
    want = TSegmenter(tm).segment_many(feats, batch_size=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pickle_holds_no_device(tmp_path, monkeypatch):
    """A fitted model pickles its weights on the CPU with no device,
    optimizer or plateau controller; it unpickles onto the device its
    loader asks for, and by default onto the card, which raises where
    there is none."""
    train = TSplit(**TRAIN)
    model = TModel.from_args(make_args(sm_max_span_length=8, epochs=1,
                                       sm_supervised_method="gradient-based"), train,
                             device=CPU)
    model.fit(train, use_labels=True)
    assert model._scheduler is not None
    path = str(tmp_path / "m.pkl")
    ckpt.save_pickle(model, path)
    state = model.__getstate__()
    assert "device" not in state and "_scheduler" not in state
    assert state["module"] is not model.module and state["args"] is model.args
    assert all(t.device == CPU for t in state["module"].state_dict().values())

    loaded = ckpt.load_pickle(path, device="cpu")
    assert loaded.device == CPU and not hasattr(loaded, "_scheduler")
    for k, v in model.module.state_dict().items():
        np.testing.assert_array_equal(loaded.module.state_dict()[k].numpy(), v.numpy())
    feats = _test_features()
    got = TSegmenter(loaded).segment_many(feats)
    want = TSegmenter(model).segment_many(feats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the in-memory pickles of main.train
    again = ckpt.loads(pickle.dumps(model), model.device)
    got, want = again.predict(train), model.predict(train)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load_pickle(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSegmenter.load(path)


def test_segmenter_roundtrip(tmp_path):
    model = _closed_form(TSplit, TModel, device=CPU)
    path = str(tmp_path / "model.pkl")
    with open(path, "wb") as f:
        pickle.dump(model, f)

    seg = TSegmenter.load(path, device="cpu")
    assert seg.model.device == CPU
    test = TSplit(num_videos=8, n_classes=3, max_len=40, span_k=5, seed=1)
    feats, golds = [], []
    for name in sorted(test._samples):
        feats.append(test._samples[name]["features"])
        golds.append(test._samples[name]["gt_single"])
    preds = seg.segment_many(feats, batch_size=4)
    match = total = 0
    for p, g in zip(preds, golds):
        assert len(p) == len(g)
        match += int((p == g).sum())
        total += len(g)
    assert match / total > 0.7

    single = seg.segment(feats[0])
    np.testing.assert_array_equal(single, preds[0])
    # and the JAX package's Segmenter on the same fit decodes the same
    want = JSegmenter(_closed_form(JSplit, JModel)).segment_many(feats, batch_size=4)
    for p, w in zip(preds, want):
        np.testing.assert_array_equal(p, w)


def test_checkpoint_sidecar_matches_jax(tmp_path):
    """The sidecar json carries the same keys and values as JAX's."""
    args = make_args(sm_max_span_length=5)
    sched = {"lr": 1e-3, "best": 2.5, "num_bad": 1}
    ckpt.save_checkpoint({"w": torch.ones(2)}, args, 4, str(tmp_path / "t"), lr=5e-3,
                         sched_state=sched)
    jckpt.save_orbax({"w": np.ones(2)}, args, 4, str(tmp_path / "j"), lr=5e-3,
                     sched_state=sched)
    with open(tmp_path / "t" / "step_4.args.json") as f, \
            open(tmp_path / "j" / "step_4.args.json") as g:
        assert json.load(f) == json.load(g)
    assert ckpt.latest_step(str(tmp_path / "t")) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None


# ---- the compound model and the flow through the reference state dict ------

FLOW = dict(sm_feature_projection=True, flow_scale=True, flow_scale_no_zero=True,
            flow_couple_layers=2, flow_hidden_units=8)
REF_VARIANTS = {
    "gaussian with flow": dict(FLOW),
    "compound": dict(sm_component_model=True, sm_component_embedding_dim=8),
    "compound with z and flow": dict(sm_component_model=True, sm_component_embedding_dim=8,
                                     sm_component_z_dim=4, sm_component_z_hidden_dim=8,
                                     **FLOW),
}


def _reference_state_dict(variant):
    """A reference-style state dict (reference names, torch tensors, the
    (D, D) covariance, a 'model.' prefix and a constraint buffer), from a
    JAX model's weights moved off its init."""
    train = JSplit(num_videos=12, n_classes=3, max_len=30, span_k=5, feature_dim=6, seed=0)
    jm = JModel.from_args(make_args(sm_max_span_length=8, **REF_VARIANTS[variant]), train)
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.2 * rng.randn(*np.shape(x)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jm.module.params))
    params["gaussian_cov"] = np.abs(params["gaussian_cov"]) + 0.5
    sd = jckpt.reference_state_dict_from_params(params)
    assert sd["gaussian_cov"].ndim == 2
    ref = {"model." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    ref["model.init_constraints"] = torch.zeros(3)
    return ref, sd


def _fresh_args():
    return make_args(sm_max_span_length=8)


@pytest.mark.parametrize("variant", sorted(REF_VARIANTS))
def test_reference_state_dict_compound_and_flow_both_ways(variant):
    """A reference-style state dict imports in the port and in JAX to the
    same weights (the port's state dict equals JAX's params carried by
    ``bridge.py``), both decode the same labels, and the port exports it
    back to the same dict (and to JAX's export of its own import)."""
    from action_segmentation_torch import bridge
    from action_segmentation_torch.models.semimarkov import (
        semimarkov_from_reference_state_dict as t_import,
    )
    from action_segmentation_tpu.models.semimarkov import (
        semimarkov_from_reference_state_dict as j_import,
    )

    ref, sd = _reference_state_dict(variant)
    tm = t_import(_fresh_args(), ref, device=CPU)
    jm = j_import(_fresh_args(), {k: v.numpy() for k, v in ref.items()})
    assert type(tm.module).__name__ == type(jm.module).__name__
    for flag in ("sm_component_model", "sm_feature_projection", "flow_scale",
                 "flow_couple_layers", "flow_hidden_units", "sm_component_z_dim",
                 "sm_compound_structure", "sm_component_embedding_dim"):
        assert getattr(tm.args, flag, None) == getattr(jm.args, flag, None), flag
    jparams = jax.tree_util.tree_map(np.asarray, jm.module.params)
    convert = (bridge.compound_hsmm_params_from_numpy if "initial_embeddings" in jparams
               else bridge.gaussian_hsmm_params_from_numpy)
    want = convert(jparams, CPU)
    got = tm.module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)

    test = TSplit(num_videos=6, n_classes=3, max_len=40, span_k=5, feature_dim=6, seed=1)
    feats = [test._samples[n]["features"] for n in sorted(test._samples)]
    for g, w in zip(TSegmenter(tm).segment_many(feats, batch_size=4),
                    JSegmenter(jm).segment_many(feats, batch_size=4)):
        np.testing.assert_array_equal(g, w)

    back = ckpt.reference_state_dict_from_params(tm.module.state_dict())
    jback = jckpt.reference_state_dict_from_params(jm.module.params)
    assert sorted(back) == sorted(sd) == sorted(jback)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
        np.testing.assert_allclose(back[k], jback[k], rtol=1e-6, err_msg=k)


def test_compound_state_dict_meta_matches_jax():
    """The architecture read off a compound state dict, as JAX reads it."""
    ref, _ = _reference_state_dict("compound with z and flow")
    _, meta = ckpt.compound_params_from_reference_state_dict(ref, device=CPU)
    _, jmeta = jckpt.compound_params_from_reference_state_dict(ref)
    flow = meta.pop("flow")
    assert meta == jmeta
    assert flow == {"flow_couple_layers": 2, "flow_hidden_units": 8, "flow_hidden_layers": 1,
                    "flow_scale": True}


def test_import_reference_state_dict(tmp_path):
    """Twin of tests/test_checkpoint.py::test_import_reference_state_dict:
    a reference-trained SemiMarkovModule state dict (torch tensors,
    reference names and constraint buffers) imports through the port's
    tool into a pickle whose decode matches a model built with the same
    weights; the export tool writes the reference's dict back."""
    from action_segmentation_torch.models.semimarkov import semimarkov_from_reference_state_dict
    from action_segmentation_torch.tools.export_reference_model import main as export_main
    from action_segmentation_torch.tools.import_reference_model import main as import_main

    Cn, D = 4, 6
    rng = np.random.RandomState(0)
    sd = {
        "poisson_log_rates": torch.tensor(rng.randn(Cn).astype(np.float32)),
        "gaussian_means": torch.tensor(rng.randn(Cn, D).astype(np.float32) * 2),
        "gaussian_cov": torch.tensor(np.abs(rng.randn(D)).astype(np.float32) + 0.5),
        "transition_logits": torch.tensor(rng.randn(Cn, Cn).astype(np.float32)),
        "init_logits": torch.tensor(rng.randn(Cn).astype(np.float32)),
        "init_constraints": torch.zeros(Cn),  # a buffer: skipped
        "transition_constraints": torch.zeros(Cn, Cn),
    }
    sd_path = str(tmp_path / "ref_module.pt")
    torch.save(sd, sd_path)
    out_path = str(tmp_path / "imported.pkl")
    import_main(["--state_dict", sd_path, "--output", out_path], device="cpu")

    seg = TSegmenter.load(out_path, device="cpu")
    feats = rng.randn(30, D).astype(np.float32) + 0.5
    got = seg.segment(feats)
    native = semimarkov_from_reference_state_dict(make_args(), {k: v.numpy() for k, v in
                                                                sd.items()}, device=CPU)
    np.testing.assert_array_equal(got, TSegmenter(native).segment(feats))
    assert got.shape == (30,)

    exported = str(tmp_path / "exported.pt")
    export_main(["--model", out_path, "--output", exported], device="cpu")
    back = torch.load(exported, weights_only=True)
    assert sorted(back) == sorted(ckpt.REFERENCE_PARAM_KEYS)
    for k in ckpt.REFERENCE_PARAM_KEYS:
        want = torch.diag(sd[k]) if k == "gaussian_cov" else sd[k]
        assert torch.equal(back[k], want), k


def test_compound_pickle_roundtrip_through_the_tools(tmp_path, monkeypatch):
    """A compound model with a latent and a flow: its reference dict
    through the import tool into a pickle, which decodes the labels of the
    in-memory import and exports back to the same dict. Without
    device="cpu" both tools ask for the card, and raise without one."""
    from action_segmentation_torch.models.semimarkov import semimarkov_from_reference_state_dict
    from action_segmentation_torch.tools.export_reference_model import main as export_main
    from action_segmentation_torch.tools.import_reference_model import main as import_main

    ref, sd = _reference_state_dict("compound with z and flow")
    sd_path, pkl, out = (str(tmp_path / n) for n in ("ref.pt", "m.pkl", "back.pt"))
    torch.save(ref, sd_path)
    import_main(["--state_dict", sd_path, "--output", pkl, "--sm_max_span_length", "8"],
                device="cpu")
    loaded = ckpt.load_pickle(pkl, device="cpu")
    native = semimarkov_from_reference_state_dict(_fresh_args(), ref, device=CPU)
    test = TSplit(num_videos=5, n_classes=3, max_len=40, span_k=5, feature_dim=6, seed=2)
    feats = [test._samples[n]["features"] for n in sorted(test._samples)]
    for g, w in zip(TSegmenter(loaded).segment_many(feats), TSegmenter(native).segment_many(feats)):
        np.testing.assert_array_equal(g, w)
    export_main(["--model", pkl, "--output", out], device="cpu")
    back = torch.load(out, weights_only=True)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_main(["--state_dict", sd_path, "--output", pkl, "--sm_max_span_length", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_main(["--model", pkl, "--output", out])
