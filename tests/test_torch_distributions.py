"""The port's potentials (ops/distributions.py) against their JAX twins.

Same numpy inputs through both packages; every factor within rtol 1e-5
(float32 sums in another order on the two sides; atol only where a
factor can be exactly 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_segmentation_torch.ops import distributions as td
from action_segmentation_tpu.ops import distributions as jd

RTOL = 1e-5


@pytest.mark.parametrize("batched_means", [False, True])
def test_gaussian_emission_matches_jax(batched_means):
    rng = np.random.RandomState(0)
    B, T, D, C = 3, 17, 30, 7
    feats = rng.randn(B, T, D).astype(np.float32)
    shape = (B, C, D) if batched_means else (C, D)
    means = rng.randn(*shape).astype(np.float32)
    cov = (np.abs(rng.randn(D)) + 0.5).astype(np.float32)
    want = np.asarray(jd.gaussian_emission_log_probs(
        jnp.asarray(feats), jnp.asarray(means), jnp.asarray(cov)))
    got = td.gaussian_emission_log_probs(
        torch.from_numpy(feats), torch.from_numpy(means), torch.from_numpy(cov)).numpy()
    assert got.shape == (B, T, C)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("max_k", [1, 2, 20])
def test_poisson_lengths_match_jax(max_k):
    rng = np.random.RandomState(max_k)
    log_rates = (rng.randn(2, 5) * 0.3 + 1.5).astype(np.float32)
    want = np.asarray(jd.poisson_length_log_probs(jnp.asarray(log_rates), max_k))
    got = td.poisson_length_log_probs(torch.from_numpy(log_rates), max_k).numpy()
    assert got.shape == want.shape == (2, max(max_k, 2), 5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("allow_self", [True, False])
def test_transition_and_initial_match_jax(allow_self):
    rng = np.random.RandomState(2)
    C = 6
    logits = rng.randn(C, C).astype(np.float32)
    mask = rng.rand(C, C) < 0.3
    mask[:, 0] = True  # one fully-masked column stays finite (BIG_NEG)
    for m in (None, mask):
        want = np.asarray(jd.transition_log_probs(
            jnp.asarray(logits), None if m is None else jnp.asarray(m), allow_self))
        got = td.transition_log_probs(
            torch.from_numpy(logits), None if m is None else torch.from_numpy(m),
            allow_self).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    init = rng.randn(C).astype(np.float32)
    imask = rng.rand(C) < 0.5
    want = np.asarray(jd.initial_log_probs(jnp.asarray(init), jnp.asarray(imask)))
    got = td.initial_log_probs(torch.from_numpy(init), torch.from_numpy(imask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(
        td.masked_log_softmax(torch.from_numpy(logits), dim=0).numpy(),
        np.asarray(jd.masked_log_softmax(jnp.asarray(logits), axis=0)),
        rtol=RTOL, atol=1e-6,
    )
