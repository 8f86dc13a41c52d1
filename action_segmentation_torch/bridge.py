"""Carry weights across from the JAX package.

The JAX ``GaussianHsmm.params`` dict (as numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, module.params)``) becomes a state
dict of the port's ``GaussianHsmm``, so both packages compute the same
thing from the same weights:

    module.load_state_dict(gaussian_hsmm_params_from_numpy(params, device))

A JAX pickle cannot be unpickled where JAX is absent; this takes only
numpy arrays.
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


def gaussian_hsmm_params_from_numpy(params, device):
    """{name: np.ndarray} -> {name: float32 tensor on `device`} for
    ``GaussianHsmm.load_state_dict``. Raises on missing or extra keys
    (a flow or compound model's params do not fit this module)."""
    extra = set(params) - set(GAUSSIAN_HSMM_KEYS)
    missing = set(GAUSSIAN_HSMM_KEYS) - set(params)
    if extra or missing:
        raise KeyError(
            "GaussianHsmm params: missing {}, unexpected {}".format(
                sorted(missing), sorted(extra)
            )
        )
    return {
        k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
        for k in GAUSSIAN_HSMM_KEYS
    }
