"""Carry weights across from the JAX package.

The JAX package's params (``module.params`` as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, module.params)``) become a state
dict of the port's module, so both packages compute the same thing from
the same weights:

    module.load_state_dict(gaussian_hsmm_params_from_numpy(params, device))
    module.load_state_dict(compound_hsmm_params_from_numpy(params, device))
    model.mlp.load_state_dict(framewise_params_from_numpy(params, device))
    model.tagger.load_state_dict(sequential_params_from_numpy(params, device))

The JAX package nests its layers (``res``, ``cells``, ``scale_cells``,
``layers`` lists) and stores every linear and LSTM weight as (in, out);
the port's modules carry the reference's flat names and torch's (out, in)
layout, so each weight is transposed. A JAX pickle cannot be unpickled
where JAX is absent; these take only numpy arrays.
"""

import numpy as np
import torch

GAUSSIAN_HSMM_KEYS = (
    "poisson_log_rates",  # (C,)
    "gaussian_means",  # (C, D)
    "gaussian_cov",  # (D,)
    "transition_logits",  # (C, C) [to, from]
    "init_logits",  # (C,)
)
COMPOUND_HSMM_KEYS = (
    "initial_embeddings", "transition_embeddings", "emission_embeddings",
    "length_embeddings", "initial_weights", "transition_weights", "emission_mean_mlp",
    "emission_mean_bias", "length_mlp", "gaussian_cov",
)
# optional groups: all of a group or none of it
COMPOUND_OPTIONAL = (
    ("initial_bias", "transition_bias", "length_bias"),
    ("encoder", "encoder_to_params"),
    ("feature_projector",),
)


def _check_keys(kind, params, required, optional=()):
    allowed = set(required).union(*optional)
    extra = set(params) - allowed
    missing = set(required) - set(params)
    for group in optional:
        present = set(group) & set(params)
        if present and present != set(group):
            missing |= set(group) - present
    if extra or missing:
        raise KeyError("{} params: missing {}, unexpected {}".format(
            kind, sorted(missing), sorted(extra)))


def _linear(p, prefix):
    """{w (in, out), b} -> ``prefix.weight`` (out, in), ``prefix.bias``."""
    return {prefix + ".weight": np.asarray(p["w"]).T, prefix + ".bias": p["b"]}


def _residual_mlp(p, prefix):
    out = _linear(p["in"], "{}.0".format(prefix))
    for i, r in enumerate(p["res"]):
        out.update(_linear(r["lin1"], "{}.{}.lin1".format(prefix, i + 1)))
        out.update(_linear(r["lin2"], "{}.{}.lin2".format(prefix, i + 1)))
    out.update(_linear(p["out"], "{}.{}".format(prefix, 1 + len(p["res"]))))
    return out


def _relu_net(p, prefix):
    layers = p["layers"]
    out = _linear(layers[0], prefix + ".in_layer")
    for j, layer in enumerate(layers[1:-1]):
        out.update(_linear(layer, "{}.cell{}".format(prefix, j)))
    out.update(_linear(layers[-1], prefix + ".out_layer"))
    return out


def flow_params_from_numpy(flow, prefix="feature_projector"):
    """The JAX NICE flow ({cells: [{layers: [...]}], scale_cells}) as the
    port's ``NiceFlow`` weights under `prefix`."""
    out = {}
    for kind in ("cells", "scale_cells"):
        for i, cell in enumerate(flow.get(kind, [])):
            out.update(_relu_net(cell, "{}.{}{}".format(prefix, kind[:-1], i)))
    return out


def lstm_params_from_numpy(lstm, prefix="encoder.encoder"):
    """The JAX scan LSTM ({layers: [[forward cell, backward cell], ...]},
    each {w_ih (in, 4H), w_hh (H, 4H), b_ih, b_hh}) as nn.LSTM weights
    under `prefix` (weight_ih_l{l}[_reverse] (4H, in), ...)."""
    out = {}
    for layer, cells in enumerate(lstm["layers"]):
        for cell, suffix in zip(cells, ("", "_reverse")):
            for name in ("ih", "hh"):
                key = "{}.weight_{}_l{}{}".format(prefix, name, layer, suffix)
                out[key] = np.asarray(cell["w_" + name]).T
                key = "{}.bias_{}_l{}{}".format(prefix, name, layer, suffix)
                out[key] = cell["b_" + name]
    return out


def tensors(params, device):
    """{name: array} -> {name: float32 tensor on `device`}."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device) for k, v in params.items()}


def gaussian_hsmm_params_from_numpy(params, device):
    """{name: np.ndarray} (and a nested ``feature_projector``) -> {name:
    float32 tensor on `device`} for ``GaussianHsmm.load_state_dict``.
    Raises on missing or extra keys (a compound model's params do not fit
    this module)."""
    _check_keys("GaussianHsmm", params, GAUSSIAN_HSMM_KEYS, [("feature_projector",)])
    flat = {k: params[k] for k in GAUSSIAN_HSMM_KEYS}
    if "feature_projector" in params:
        flat.update(flow_params_from_numpy(params["feature_projector"]))
    return tensors(flat, device)


def compound_hsmm_params_from_numpy(params, device):
    """The JAX ``ComponentHsmm.params`` (numpy leaves, nested) -> a
    ``ComponentHsmm`` state dict on `device`, every linear and LSTM weight
    transposed. Raises on missing or extra keys."""
    _check_keys("ComponentHsmm", params, COMPOUND_HSMM_KEYS, COMPOUND_OPTIONAL)
    flat = {}
    for name in ("initial", "transition", "emission", "length"):
        flat[name + "_embeddings.weight"] = params[name + "_embeddings"]
    for name in ("initial_weights", "transition_weights", "encoder_to_params"):
        if name in params:
            flat.update(_linear(params[name], name))
    for name in ("emission_mean_mlp", "length_mlp"):
        flat.update(_residual_mlp(params[name], name))
    for name in ("emission_mean_bias", "gaussian_cov", "initial_bias", "transition_bias",
                 "length_bias"):
        if name in params:
            flat[name] = params[name]
    if "encoder" in params:
        flat.update(lstm_params_from_numpy(params["encoder"]))
    if "feature_projector" in params:
        flat.update(flow_params_from_numpy(params["feature_projector"]))
    return tensors(flat, device)


def framewise_params_from_numpy(params, device):
    """The JAX framewise tagger's MLP ({layers: [{w, b}, ...]}) -> an
    ``nn.MLP`` state dict (``layers.{i}.weight`` (out, in), ...) on
    `device`."""
    _check_keys("MLP", params, ("layers",))
    flat = {}
    for i, layer in enumerate(params["layers"]):
        flat.update(_linear(layer, "layers.{}".format(i)))
    return tensors(flat, device)


def sequential_params_from_numpy(params, device):
    """The JAX BiLSTM tagger ({encoder, proj}) -> a ``SequentialTagger``
    state dict (``encoder.encoder.*``, ``proj.*``) on `device`."""
    _check_keys("SequentialTagger", params, ("encoder", "proj"))
    flat = lstm_params_from_numpy(params["encoder"])
    flat.update(_linear(params["proj"], "proj"))
    return tensors(flat, device)
