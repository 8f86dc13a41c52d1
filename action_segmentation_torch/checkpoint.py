"""Checkpointing: pickled models, train-state checkpoints, and the
reference state-dict exchange.

Twin of the JAX package's ``checkpoint.py``:

* ``save_pickle`` / ``load_pickle`` keep the pickle-with-args format the
  command line writes (``--model_output_path``). A model pickles its
  args, its bookkeeping and its weights on the CPU
  (``models/base.DeviceModel``, which every model class extends);
  ``load_pickle(path, device)`` puts it on `device`, the card unless the
  caller asks for the CPU.
* ``save_checkpoint`` / ``latest_step`` / ``load_checkpoint`` /
  ``load_meta`` take the place of the JAX package's orbax checkpoints:
  ``step_<N>.pt`` holds the train state (``torch.save`` of the module's
  and the optimizer's state dicts, on the CPU) and ``step_<N>.args.json``
  beside it the same sidecar as JAX's: the step, the JSON-able args, the
  learning rate, and the plateau controller's post-step state.
* ``init_subset_from`` is the reference's strict-filtered warm start.
* ``params_from_reference_state_dict``,
  ``compound_params_from_reference_state_dict`` and
  ``reference_state_dict_from_params`` convert a Gaussian HSMM or a
  compound model, with its flow and its encoder, between the port's
  state dict and the reference's parameter names, so a model trained by
  either package decodes in the other. The port's modules carry the
  reference's names; only the covariance changes shape.
"""

import json
import os
import pickle
import re

import numpy as np
import torch

from action_segmentation_torch import resolve_device
from action_segmentation_torch.bridge import tensors
from action_segmentation_torch.models.base import unpickle_device


def save_pickle(model, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(model, f)


def load_pickle(path, device=None):
    """Unpickle a model onto `device` (None: the card, which raises when
    no card is present)."""
    with open(path, "rb") as f, unpickle_device(device):
        return pickle.load(f)


def loads(data, device=None):
    """``pickle.loads`` of a model onto `device` (None: the card)."""
    with unpickle_device(device):
        return pickle.loads(data)


def _args_to_jsonable(args):
    return {
        k: v
        for k, v in vars(args).items()
        if isinstance(v, (int, float, str, bool, list, type(None)))
    }


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _checkpoint_path(directory, step):
    return os.path.join(os.path.abspath(directory), "step_{}.pt".format(step))


def save_checkpoint(state, args, step, directory, lr=None, sched_state=None):
    """Write ``state`` (a state dict, or a train state
    ``{"params": module.state_dict(), "opt_state": optimizer.state_dict()}``)
    to ``step_<step>.pt`` on the CPU, and its sidecar json.

    `lr` is the live learning rate; `sched_state` the plateau
    controller's POST-step state (lr/best/num_bad), the state that
    governs epoch step+1, so a resumed run reproduces the uninterrupted
    run's rates even when interrupted mid-plateau."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = _checkpoint_path(directory, step)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)  # a re-launched run overwrites a step it reaches again
    meta = {"step": step, "args": _args_to_jsonable(args)}
    if lr is not None:
        meta["lr"] = float(lr)
    if sched_state:
        meta["sched"] = {
            "lr": float(sched_state["lr"]),
            "best": float(sched_state["best"]),
            "num_bad": int(sched_state["num_bad"]),
        }
    with open(os.path.join(directory, "step_{}.args.json".format(step)), "w") as f:
        json.dump(meta, f, indent=2)


def latest_step(directory):
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for m in (re.fullmatch(r"step_(\d+)\.pt", name) for name in os.listdir(directory))
        if m
    ]
    return max(steps) if steps else None


def load_checkpoint(directory, step=None):
    """Restore (state, args_dict, step), the state's tensors on the CPU;
    `step` None takes the latest."""
    if step is None:
        step = latest_step(directory)
        assert step is not None, "no checkpoints in {}".format(directory)
    state = torch.load(_checkpoint_path(directory, step), map_location="cpu",
                       weights_only=True)
    meta = load_meta(directory, step)
    return state, (meta["args"] if meta else None), step


def load_meta(directory, step):
    """The sidecar json for a step (args + saved lr), or None."""
    meta_path = os.path.join(os.path.abspath(directory), "step_{}.args.json".format(step))
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def init_subset_from(params, source_params, exclude_prefixes=("feature_projector",)):
    """Copy every matching non-excluded entry from source into params
    (the reference's strict-filtered warm start)."""
    out = dict(params)
    for key, val in source_params.items():
        if any(key.startswith(p) for p in exclude_prefixes):
            continue
        if key in out:
            out[key] = val
    return out


REFERENCE_PARAM_KEYS = (
    "poisson_log_rates",
    "gaussian_means",
    "gaussian_cov",
    "transition_logits",
    "init_logits",
)
# constraint masks are derived from args/corpus on this side, not weights
REFERENCE_BUFFER_KEYS = ("init_constraints", "transition_constraints")
FLOW_PREFIX = "feature_projector."
LSTM_PREFIX = "encoder.encoder."


def _strip(state_dict):
    """{name without a 'model.' prefix: float32 numpy}."""
    return {(k[len("model."):] if k.startswith("model.") else k): _numpy(v)
            for k, v in state_dict.items()}


def _numpy(val):
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.asarray(val, np.float32)


def _diag_from_reference_cov(val):
    """The reference stores the tied diagonal covariance as a full
    (D, D) matrix (semimarkov_modules.py:149-151); keep the diagonal."""
    off_diag = val - np.diag(np.diag(val))
    assert np.abs(off_diag).max() <= 1e-6 * max(1.0, np.abs(val).max()), (
        "reference gaussian_cov is not diagonal"
    )
    return np.diag(val).copy()


def _indices(names, pattern):
    """Sorted ints that `pattern`'s first group matches in `names`."""
    pat = re.compile(pattern)
    return sorted({int(m.group(1)) for m in map(pat.match, names) if m})


def flow_params_from_reference_state_dict(sd, prefix=FLOW_PREFIX):
    """The reference NICETrans weights (flow.py:59-126) under `prefix` of
    a numpy state dict: (weights {name: array} under the port's names,
    which are the reference's, and the flow's flags {flow_couple_layers,
    flow_hidden_units, flow_hidden_layers, flow_scale}). The
    architectures are the same; the port's ``NiceFlow`` loads the
    weights by name."""
    names = [k[len(prefix):] for k in sd if k.startswith(prefix)]
    cells = _indices(names, r"cell(\d+)\.")
    assert cells == list(range(len(cells))) and cells, "no flow cells under " + prefix
    hidden = _indices([n[len("cell0."):] for n in names if n.startswith("cell0.")],
                      r"cell(\d+)\.")
    flags = {
        "flow_couple_layers": len(cells),
        "flow_hidden_units": int(sd[prefix + "cell0.in_layer.weight"].shape[0]),
        "flow_hidden_layers": len(hidden),
        "flow_scale": bool(_indices(names, r"scale_cell(\d+)\.")),
    }
    return {k: v for k, v in sd.items() if k.startswith(prefix)}, flags


def lstm_params_from_reference_state_dict(sd, prefix=LSTM_PREFIX):
    """The torch nn.LSTM weights under `prefix` of a numpy state dict:
    (weights, {layers, hidden_per_dir}). The port's
    encoder is the reference's nn.LSTM (the JAX package's scan LSTM has
    its equations and i/f/g/o gate order, and transposes these), so the
    weights load by name."""
    layers = _indices([k[len(prefix):] for k in sd if k.startswith(prefix)],
                      r"weight_ih_l(\d+)$")
    assert layers == list(range(len(layers))) and layers, "no LSTM layers under " + prefix
    shape = {
        "layers": len(layers),
        "hidden_per_dir": int(sd[prefix + "weight_hh_l0"].shape[1]),
    }
    return {k: v for k, v in sd.items() if k.startswith(prefix)}, shape


def params_from_reference_state_dict(state_dict, device=None):
    """Map a reference SemiMarkovModule state_dict (torch tensors or
    numpy arrays, an optional 'model.' prefix) to a ``GaussianHsmm``
    state dict on `device` (None: the card), the flow's weights
    (``feature_projector.*``) included. Returns (params, skipped_keys);
    the constraint buffers and any other name are skipped."""
    sd = _strip(state_dict)
    params, skipped = {}, []
    for key, name in zip(state_dict, sd):
        val = sd[name]
        if name in REFERENCE_PARAM_KEYS:
            if name == "gaussian_cov" and val.ndim == 2:
                val = _diag_from_reference_cov(val)
            params[name] = val
        elif not name.startswith(FLOW_PREFIX):
            skipped.append(key)
    missing = [k for k in REFERENCE_PARAM_KEYS if k not in params]
    assert not missing, "state_dict missing reference params: {}".format(missing)
    if any(name.startswith(FLOW_PREFIX) for name in sd):
        params.update(flow_params_from_reference_state_dict(sd)[0])
    return tensors(params, resolve_device(device)), skipped


def compound_params_from_reference_state_dict(state_dict, device=None):
    """Map a reference ComponentSemiMarkovModule state_dict
    (semimarkov_modules.py:755-812) to a ``ComponentHsmm`` state dict on
    `device` (None: the card). The port's module carries the reference's
    names (its EmbeddingBag tables, Linear layers, residual-MLP
    Sequentials, the encoder's nn.LSTM and the flow), so the weights map
    by name; the (D, D) diagonal covariance becomes its diagonal, and
    constraint buffers are dropped.

    Returns (params, meta): meta holds the architecture the shapes imply
    (n_components, embedding_dim, mean_layers, length_layers,
    feature_dim, n_classes (None without per-class biases),
    per_class_bias, z_dim, z_hidden_dim, encoder_layers,
    compound_structure) and, with a flow, its flags under "flow"."""
    sd = _strip(state_dict)
    params = {k: v for k, v in sd.items() if k not in REFERENCE_BUFFER_KEYS}
    if params["gaussian_cov"].ndim == 2:
        params["gaussian_cov"] = _diag_from_reference_cov(params["gaussian_cov"])

    def residual_layers(prefix):
        return len(_indices(sd, re.escape(prefix) + r"\.(\d+)\.")) - 2

    emb = sd["initial_embeddings.weight"]
    per_class_bias = "initial_bias" in sd
    meta = {
        "n_components": emb.shape[0],
        "embedding_dim": emb.shape[1],
        "mean_layers": residual_layers("emission_mean_mlp"),
        "length_layers": residual_layers("length_mlp"),
        "feature_dim": sd["emission_mean_bias"].shape[0],
        "n_classes": sd["initial_bias"].shape[0] if per_class_bias else None,
        "per_class_bias": per_class_bias,
        "z_dim": 0, "z_hidden_dim": 0, "encoder_layers": 0,
        "compound_structure": True,
    }
    if any(k.startswith(LSTM_PREFIX) for k in sd):
        _, shape = lstm_params_from_reference_state_dict(sd)
        meta["z_dim"] = sd["encoder_to_params.weight"].shape[0] // 2
        meta["z_hidden_dim"] = 2 * shape["hidden_per_dir"]
        meta["encoder_layers"] = shape["layers"]
        # --no_sm_compound_structure takes z out of the structure heads:
        # their input is e wide, not e + z
        meta["compound_structure"] = (
            sd["initial_weights.weight"].shape[1] == emb.shape[1] + meta["z_dim"])
    if any(k.startswith(FLOW_PREFIX) for k in sd):
        meta["flow"] = flow_params_from_reference_state_dict(sd)[1]
    return tensors(params, resolve_device(device)), meta


def reference_state_dict_from_params(params):
    """Inverse of the imports: a Gaussian HSMM's or a compound model's
    state dict (tensors or numpy arrays), the flow and the encoder
    included, as a reference-named numpy state_dict that the reference's
    own ``load_state_dict`` accepts (the tied diagonal covariance as its
    (D, D) matrix)."""
    sd = {name: _numpy(val) for name, val in params.items()}
    if "initial_embeddings.weight" not in sd:
        missing = [k for k in REFERENCE_PARAM_KEYS if k not in sd]
        assert not missing, "params missing reference params: {}".format(missing)
    cov = sd["gaussian_cov"]
    sd["gaussian_cov"] = np.diag(cov) if cov.ndim == 1 else cov
    return sd
