"""Checkpointing: pickled models, train-state checkpoints, and the
reference state-dict exchange.

Twin of the JAX package's ``checkpoint.py``:

* ``save_pickle`` / ``load_pickle`` keep the pickle-with-args format the
  command line writes (``--model_output_path``). A model pickles its
  args, its bookkeeping and its module's weights on the CPU
  (``SemiMarkovModel.__getstate__``); ``load_pickle(path, device)`` puts
  it on `device`, the card unless the caller asks for the CPU.
* ``save_checkpoint`` / ``latest_step`` / ``load_checkpoint`` /
  ``load_meta`` take the place of the JAX package's orbax checkpoints:
  ``step_<N>.pt`` holds the train state (``torch.save`` of the module's
  and the optimizer's state dicts, on the CPU) and ``step_<N>.args.json``
  beside it the same sidecar as JAX's: the step, the JSON-able args, the
  learning rate, and the plateau controller's post-step state.
* ``init_subset_from`` is the reference's strict-filtered warm start.
* ``params_from_reference_state_dict`` and
  ``reference_state_dict_from_params`` convert a Gaussian HSMM between
  the port's state dict and the reference's parameter names, so a model
  trained by either package decodes in the other. The flow, compound and
  LSTM weights come with the compound model (ROADMAP.md §1 item 7).
"""

import json
import os
import pickle
import re

import numpy as np
import torch

from action_segmentation_torch import resolve_device
from action_segmentation_torch.bridge import gaussian_hsmm_params_from_numpy
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
# top-level names of the flow's, the compound model's and its VAE
# encoder's weights
_ITEM7_NAMES = frozenset((
    "feature_projector", "initial_embeddings", "transition_embeddings",
    "emission_embeddings", "length_embeddings", "initial_weights",
    "transition_weights", "emission_mean_mlp", "length_mlp", "emission_mean_bias",
    "initial_bias", "transition_bias", "length_bias", "encoder", "encoder_to_params",
))


def _refuse_compound(name):
    if name.split(".")[0] in _ITEM7_NAMES:
        raise NotImplementedError(
            "{}: flow, compound and LSTM weights are not ported yet; they come "
            "with the compound model (ROADMAP.md §1 item 7)".format(name)
        )


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


def params_from_reference_state_dict(state_dict, device=None):
    """Map a reference SemiMarkovModule state_dict (torch tensors or
    numpy arrays, an optional 'model.' prefix) to a ``GaussianHsmm``
    state dict on `device` (None: the card). Returns (params,
    skipped_keys); the constraint buffers are skipped."""
    params = {}
    skipped = []
    for key, val in state_dict.items():
        name = key[len("model."):] if key.startswith("model.") else key
        _refuse_compound(name)
        if name in REFERENCE_PARAM_KEYS:
            val = _numpy(val)
            if name == "gaussian_cov" and val.ndim == 2:
                val = _diag_from_reference_cov(val)
            params[name] = val
        else:
            skipped.append(key)
    missing = [k for k in REFERENCE_PARAM_KEYS if k not in params]
    assert not missing, "state_dict missing reference params: {}".format(missing)
    return gaussian_hsmm_params_from_numpy(params, resolve_device(device)), skipped


def reference_state_dict_from_params(params):
    """Inverse of ``params_from_reference_state_dict``: a Gaussian HSMM's
    state dict (tensors or numpy arrays) as a reference-named numpy
    state_dict that the reference's own ``load_state_dict`` accepts (the
    tied diagonal covariance as its (D, D) matrix)."""
    for name in params:
        _refuse_compound(name)
    sd = {name: _numpy(params[name]) for name in REFERENCE_PARAM_KEYS}
    cov = sd["gaussian_cov"]
    sd["gaussian_cov"] = np.diag(cov) if cov.ndim == 1 else cov
    return sd
