"""Baseline normal equations: the feature-first moments
(models/baseline.py:normal_eq_ff, fed by the rollout kernel's layout)
against the batch-major phi^T phi, their sums across env shards, and
the fit they feed."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trpo_robot_control_tpu.models import baseline


def _batch(T, do, N, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    obs_ff = jax.random.normal(k1, (T, do, N))
    y = jax.random.normal(k2, (T, N)) * 3.0 + 1.0
    return obs_ff, y


def _batch_major(obs_ff, y, T):
    obs = jnp.transpose(obs_ff, (2, 0, 1))                 # (N, T, do)
    phi = baseline.features(obs, T).reshape(-1, 2 * obs.shape[-1] + 4)
    return baseline.normal_eq(phi, y.T.reshape(-1))


@pytest.mark.parametrize("T,do,N", [
    (16, 24, 256),     # c3 obs width
    (16, 27, 256),     # c5 obs width (task one-hot)
    (10, 11, 128),     # odd obs width and horizon
])
def test_normal_eq_ff_matches_batch_major(T, do, N):
    obs_ff, y = _batch(T, do, N)
    A_ff, b_ff = jax.jit(lambda o, y: baseline.normal_eq_ff(o, y, T))(
        obs_ff, y)
    A, b = jax.jit(lambda o, y: _batch_major(o, y, T))(obs_ff, y)
    np.testing.assert_allclose(np.asarray(A_ff), np.asarray(A), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(b_ff), np.asarray(b), rtol=1e-4,
                               atol=1e-3)


def test_normal_eq_ff_bf16_storage_bounded():
    """bf16 storage (the c3-c5 kernel emission): A and b stay within the
    storage rounding (2^-8 relative) of the exact fp32 moments on the
    same rounded obs."""
    obs_ff, y = _batch(16, 24, 256, seed=1)
    A32, b32 = baseline.normal_eq_ff(
        obs_ff.astype(jnp.bfloat16).astype(jnp.float32), y, 16)
    A16, b16 = baseline.normal_eq_ff(obs_ff.astype(jnp.bfloat16), y, 16)
    scale_A = float(jnp.abs(A32).max())
    assert float(jnp.abs(A16 - A32).max()) <= 2e-2 * scale_A
    assert float(jnp.abs(b16 - b32).max()) <= 2e-2 * float(
        jnp.abs(b32).max())


def test_normal_eq_ff_sums_over_env_shards():
    """Every block of (A, b) is a sum over samples, so the moments of env
    shards add up to the global moments (the psum in trpo/update.py)."""
    T, do, N = 8, 9, 64
    obs_ff, y = _batch(T, do, N, seed=2)
    A, b = baseline.normal_eq_ff(obs_ff, y, T)
    parts = [baseline.normal_eq_ff(obs_ff[..., i::4], y[:, i::4], T)
             for i in range(4)]
    np.testing.assert_allclose(np.asarray(sum(p[0] for p in parts)),
                               np.asarray(A), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(sum(p[1] for p in parts)),
                               np.asarray(b), rtol=1e-5, atol=1e-3)


def test_normal_eq_fit_agrees_end_to_end():
    """The fitted baselines from the two layouts agree on what the update
    consumes: the predictions."""
    T, do, N = 12, 9, 128
    obs_ff, _ = _batch(T, do, N, seed=3)
    obs = jnp.transpose(obs_ff, (2, 0, 1))
    phi = baseline.features(obs, T)
    w_true = jax.random.normal(jax.random.PRNGKey(4), (phi.shape[-1],))
    y = (phi @ w_true).T + 0.01 * jax.random.normal(
        jax.random.PRNGKey(5), (T, N))
    reg = 1e-3 * jnp.eye(phi.shape[-1])
    A_ff, b_ff = baseline.normal_eq_ff(obs_ff, y, T)
    w_ff = baseline.fit_normal(A_ff + reg, b_ff)
    w_bm = baseline.fit(phi.reshape(-1, phi.shape[-1]), y.T.reshape(-1),
                        1e-3)
    v_ff, v_bm = np.asarray(phi @ w_ff), np.asarray(phi @ w_bm)
    np.testing.assert_allclose(v_ff, v_bm, atol=1e-2 * np.abs(v_bm).max())
    np.testing.assert_allclose(v_bm, np.asarray(phi @ w_true), atol=0.1)


def test_fit_normal_survives_ill_conditioning():
    """fit_normal's Jacobi scaling and relative eigenvalue floor: a
    rank-deficient design (duplicated feature) still gives finite
    weights that reproduce the targets."""
    rng = np.random.RandomState(6)
    X = rng.standard_normal((400, 5))
    X = np.concatenate([X, X[:, :1]], axis=1)              # exact duplicate
    y = X[:, :5] @ rng.standard_normal(5)
    A, b = baseline.normal_eq(jnp.asarray(X, jnp.float32),
                              jnp.asarray(y, jnp.float32))
    w = np.asarray(baseline.fit_normal(A, b))
    assert np.all(np.isfinite(w))
    np.testing.assert_allclose(X @ w, y, atol=1e-2 * np.abs(y).max())


def test_normal_eq_pins_highest_precision():
    """The batch-major normal equations (the path of the XLA rollout's
    batch) ask for full fp32 in the jaxpr: cond(A) reaches ~1e8, which a
    TF32 matmul would not survive."""
    phi = jnp.ones((64, 10))
    y = jnp.ones(64)
    jaxpr = jax.make_jaxpr(baseline.normal_eq)(phi, y)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    hi = jax.lax.Precision.HIGHEST
    for e in dots:
        assert e.params["precision"] == (hi, hi), e.params["precision"]
