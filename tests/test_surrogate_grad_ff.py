"""The closed-form surrogate gradient on the rollout kernel's
feature-first layout (models/policy.py:surrogate_grad_ff) against
jax.grad of the batch-major surrogate, at the configs' widths and at
non-power-of-two, non-multiple-of-8 hidden widths."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.models import policy


def _params(key, do, da, hidden=(64, 64)):
    p = policy.init_params(key, do, da, hidden, -0.5)
    # a non-trivial head so every layer's gradient is well above rounding
    p[f"W{len(hidden)}"] = p[f"W{len(hidden)}"] * 30.0
    return p


def _batch(key, T, do, da, N):
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.normal(k1, (T, do, N)),
            jax.random.normal(k2, (T, da, N)),
            jax.random.normal(k3, (T, N)))


def _grad_ref(params, obs_ff, act_ff, adv_ff):
    """jax.grad of the standard surrogate at theta_old on the
    batch-major layout (the update's batch-major path)."""
    do, da = obs_ff.shape[1], act_ff.shape[1]
    obs = jnp.transpose(obs_ff, (2, 0, 1)).reshape(-1, do)
    act = jnp.transpose(act_ff, (2, 0, 1)).reshape(-1, da)
    adv = adv_ff.T.reshape(-1)
    mu0, ls0 = policy.dist(params, obs)
    logp_old = policy.log_prob(mu0, ls0, act)

    def surr(p):
        mu, ls = policy.dist(p, obs)
        return jnp.mean(jnp.exp(policy.log_prob(mu, ls, act) - logp_old)
                        * adv)

    return jax.grad(surr)(params), mu0, logp_old


def _check(params, obs_ff, act_ff, adv_ff, rtol=1e-4):
    g, mu, logp = jax.jit(policy.surrogate_grad_ff)(params, obs_ff, act_ff,
                                                    adv_ff)
    g_ref, mu_ref, logp_ref = jax.jit(_grad_ref)(params, obs_ff, act_ff,
                                                 adv_ff)
    for k in g_ref:
        ref = np.asarray(g_ref[k])
        np.testing.assert_allclose(np.asarray(g[k]), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(),
                                   err_msg=k)
    return (g, mu, logp), (g_ref, mu_ref, logp_ref)


@pytest.mark.parametrize("T,do,da,N", [
    (8, 27, 7, 512),      # c5 widths
    (12, 24, 7, 256),     # c3 widths
    (10, 9, 2, 64),       # c1 widths
])
def test_surrogate_grad_ff_matches_jax_grad(T, do, da, N):
    key = jax.random.PRNGKey(T * 1000 + N)
    _check(_params(key, do, da), *_batch(key, T, do, da, N))


@pytest.mark.parametrize("hidden", [(48, 40), (33, 57)])
def test_surrogate_grad_ff_padded_hidden_widths(hidden):
    key = jax.random.PRNGKey(sum(hidden))
    _check(_params(key, 27, 7, hidden), *_batch(key, 8, 27, 7, 128))


def test_surrogate_grad_ff_single_hidden_layer():
    key = jax.random.PRNGKey(11)
    _check(_params(key, 12, 3, (32,)), *_batch(key, 6, 12, 3, 40))


def test_surrogate_grad_ff_mu_and_logp_outputs():
    """The old means and log-probs it returns for the line search equal
    policy.dist / policy.log_prob on the same samples."""
    key = jax.random.PRNGKey(12)
    T, do, da, N = 6, 24, 7, 32
    (_, mu, logp), (_, mu_ref, logp_ref) = _check(
        _params(key, do, da), *_batch(key, T, do, da, N))
    np.testing.assert_allclose(
        np.asarray(jnp.transpose(mu, (2, 0, 1)).reshape(-1, da)),
        np.asarray(mu_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(logp.T.reshape(-1)),
                               np.asarray(logp_ref), rtol=1e-5, atol=1e-4)


def test_surrogate_grad_ff_bf16_storage_direction():
    """bf16-stored activations and cotangents (trpo.ff_store_dtype) at c5
    widths: the flat gradient keeps its direction (cosine >= 0.999) and
    its norm within 1%."""
    key = jax.random.PRNGKey(13)
    params = _params(key, 27, 7)
    batch = _batch(key, 8, 27, 7, 512)
    g32, _, _ = policy.surrogate_grad_ff(params, *batch)
    g16, _, _ = policy.surrogate_grad_ff(params, *batch,
                                         store_dtype=jnp.bfloat16)
    a, b = ravel_pytree(g32)[0], ravel_pytree(g16)[0]
    cos = float(a @ b / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))
    assert cos >= 0.999, cos
    assert abs(float(jnp.linalg.norm(b) / jnp.linalg.norm(a)) - 1) < 1e-2


def test_surrogate_grad_ff_sums_over_env_shards():
    """The gradient is a batch mean: the size-weighted mean of per-shard
    gradients is the global gradient (the pmean in trpo/update.py)."""
    key = jax.random.PRNGKey(14)
    params = _params(key, 9, 2)
    obs, act, adv = _batch(key, 8, 9, 2, 64)
    g, _, _ = policy.surrogate_grad_ff(params, obs, act, adv)
    parts = [policy.surrogate_grad_ff(params, obs[..., i::4],
                                      act[..., i::4], adv[:, i::4])[0]
             for i in range(4)]
    for k in g:
        np.testing.assert_allclose(
            np.asarray(sum(p[k] for p in parts) / 4), np.asarray(g[k]),
            rtol=1e-4, atol=1e-4 * float(jnp.abs(g[k]).max()))


def test_policy_matmuls_pin_highest():
    """Every policy matmul asks for full fp32 in the jaxpr (TF32 at c1's
    batch size broke the oracle step-size bound on the card)."""
    key = jax.random.PRNGKey(15)
    params = _params(key, 9, 2)
    obs, act, adv = _batch(key, 4, 9, 2, 8)
    hi = jax.lax.Precision.HIGHEST
    for fn, args in ((policy.mean_net, (params, obs[:, :, 0])),
                     (policy.surrogate_grad_ff, (params, obs, act, adv))):
        jaxpr = jax.make_jaxpr(fn)(*args)
        dots = [e for e in jaxpr.jaxpr.eqns
                if e.primitive.name == "dot_general"]
        assert dots
        for e in dots:
            assert e.params["precision"] == (hi, hi), e
