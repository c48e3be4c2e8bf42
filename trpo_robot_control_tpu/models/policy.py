"""Gaussian tanh-MLP policy (SURVEY.md section 3: "Gaussian-MLP policy").

Parameters are a flat dict {W0,b0,...,Wk,bk,logstd} with the SAME keys as
the fp64 oracle (oracle/net.py), so `jax.flatten_util.ravel_pytree` —
which flattens dicts in sorted-key order — produces vectors directly
comparable to the oracle's `net.flatten`.

Every policy matmul asks for full fp32 (HIGHEST). At the default
precision the GPU runs fp32 matmuls as TF32 (~1e-3 relative), which at
c1's 3,200 samples moved the natural-gradient step size 2.4e-3 off the
fp64 oracle on an H100, past the 1e-3 parity bound (SURVEY.md 4.8).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

LOG2PI = math.log(2.0 * math.pi)
_HI = jax.lax.Precision.HIGHEST


def init_params(key, obs_dim, act_dim, hidden, logstd_init):
    """Same family as oracle init (scaled Gaussian, small final layer)."""
    assert len(hidden) < 9, "sorted-key flattening assumes < 10 layers"
    sizes = [obs_dim] + list(hidden) + [act_dim]
    params = {}
    n_layers = len(sizes) - 1
    keys = jax.random.split(key, n_layers)
    for i in range(n_layers):
        scale = 1.0 / math.sqrt(sizes[i])
        if i == n_layers - 1:
            scale *= 0.01
        params[f"W{i}"] = scale * jax.random.normal(
            keys[i], (sizes[i], sizes[i + 1]), jnp.float32)
        params[f"b{i}"] = jnp.zeros(sizes[i + 1], jnp.float32)
    params["logstd"] = jnp.full(act_dim, logstd_init, jnp.float32)
    return params


def n_layers(params):
    return sum(1 for k in params if k.startswith("W"))


def mean_net(params, obs):
    """obs (..., do) -> mu (..., da). tanh MLP, linear head."""
    h = obs
    L = n_layers(params)
    for i in range(L - 1):
        h = jnp.tanh(jnp.matmul(h, params[f"W{i}"], precision=_HI)
                     + params[f"b{i}"])
    return jnp.matmul(h, params[f"W{L-1}"], precision=_HI) \
        + params[f"b{L-1}"]


def dist(params, obs):
    """-> (mu, logstd) with logstd broadcast over the batch."""
    return mean_net(params, obs), params["logstd"]


def sample(params, obs, key):
    mu, logstd = dist(params, obs)
    return mu + jnp.exp(logstd) * jax.random.normal(key, mu.shape, mu.dtype)


def log_prob(mu, logstd, actions):
    z = (actions - mu) * jnp.exp(-logstd)
    return -0.5 * jnp.sum(z ** 2 + 2.0 * logstd + LOG2PI, axis=-1)


def kl(mu_old, logstd_old, mu_new, logstd_new):
    """Mean over batch of KL(old || new), diagonal Gaussians
    (SURVEY.md section 4.4 closed form)."""
    var_old = jnp.exp(2.0 * logstd_old)
    var_new = jnp.exp(2.0 * logstd_new)
    per_dim = (logstd_new - logstd_old
               + (var_old + (mu_old - mu_new) ** 2) / (2.0 * var_new) - 0.5)
    return jnp.mean(jnp.sum(per_dim, axis=-1))


def entropy(logstd):
    return jnp.sum(logstd + 0.5 * (1.0 + LOG2PI))


# --------------------------------------------------------- feature-first
# Twins of dist/log_prob/the surrogate gradient that consume the fused
# rollout kernels' NATIVE (T, d, N) layout. Purpose: layout, not math —
# with the standard path, XLA relayouts the kernel-emitted batch into a
# column-major (B, do) copy for the gradient's outer products through a
# chunked while+dynamic-update-slice loop (~17 ms/update at c4); the
# feature-first einsums consume (T, d, N) operands as produced and the
# unused (N, T, do) transpose is dead-code-eliminated from the fused
# train step. The gradient is written out manually (the surrogate's
# output cotangent at theta_old is closed-form: the importance ratio is
# 1), summed over (t, n) — identical math, reassociated.

def hidden_ff(params, obs_ff, store_dtype=None):
    """obs_ff (T, do, N) -> all hidden activations [(T, h, N), ...].

    store_dtype=bfloat16 halves the HBM footprint of the (T, h, N)
    intermediates — the surrogate-gradient pass is memory-bound on
    exactly these arrays. The
    matmuls themselves stay fp32-accumulating (type promotion against
    the fp32 weights); only the stored tanh outputs round to bf16."""
    hs = []
    h = obs_ff
    for i in range(n_layers(params) - 1):
        h = jnp.tanh(jnp.einsum("io,tin->ton", params[f"W{i}"], h,
                                precision=_HI)
                     + params[f"b{i}"][None, :, None])
        if store_dtype is not None:
            h = h.astype(store_dtype)
        hs.append(h)
    return hs


def dist_ff(params, obs_ff, hs=None):
    """-> (mu_ff (T, da, N), logstd)."""
    L = n_layers(params)
    h = (hs or hidden_ff(params, obs_ff))[-1]
    mu = jnp.einsum("io,tin->ton", params[f"W{L - 1}"], h,
                    precision=_HI) \
        + params[f"b{L - 1}"][None, :, None]
    return mu, params["logstd"]


def log_prob_ff(mu_ff, logstd, act_ff):
    """(T, da, N) operands -> per-sample logp (T, N)."""
    z = (act_ff - mu_ff) * jnp.exp(-logstd)[None, :, None]
    da = mu_ff.shape[1]
    return -0.5 * (jnp.sum(z ** 2, axis=1)
                   + 2.0 * jnp.sum(logstd) + da * LOG2PI)


def kl_ff(mu_old_ff, logstd_old, mu_new_ff, logstd_new):
    """Mean over batch of KL(old || new) on (T, da, N) means."""
    var_old = jnp.exp(2.0 * logstd_old)
    var_new = jnp.exp(2.0 * logstd_new)
    quad = jnp.mean(jnp.sum((mu_old_ff - mu_new_ff) ** 2
                            / (2.0 * var_new)[None, :, None], axis=1))
    const = jnp.sum(logstd_new - logstd_old
                    + var_old / (2.0 * var_new) - 0.5)
    return quad + const


def surrogate_grad_ff(params, obs_ff, act_ff, adv_ff, hs=None,
                      store_dtype=None):
    """Manual gradient of the surrogate at theta_old in (T, d, N)
    layout. Returns (g_tree, mu_ff, logp_old (T, N)). Matches
    jax.grad of the standard surrogate up to fp32 reassociation
    (tests/test_ff_baseline.py).

    store_dtype=bfloat16 rounds the stored (T, h, N) activations and
    backprop cotangents to bf16 (the pass is HBM-bound on them); all
    contractions still accumulate fp32 via type promotion against the
    fp32 weights. Gradient error is bounded by
    tests/test_ff_baseline.py::test_surrogate_grad_ff_bf16_close."""
    L = n_layers(params)
    T, do, N = obs_ff.shape
    B = T * N
    hs = hs or hidden_ff(params, obs_ff, store_dtype=store_dtype)
    mu, logstd = dist_ff(params, obs_ff, hs=hs)
    inv_var = jnp.exp(-2.0 * logstd)
    z = (act_ff - mu) * jnp.exp(-logstd)[None, :, None]
    logp_old = -0.5 * (jnp.sum(z ** 2, axis=1)
                       + 2.0 * jnp.sum(logstd)
                       + mu.shape[1] * LOG2PI)

    # output cotangent: ratio == 1 at theta_old
    u = adv_ff[:, None, :] * (act_ff - mu) * inv_var[None, :, None] / B
    g = {"logstd": jnp.mean(adv_ff[:, None, :] * (z * z - 1.0),
                            axis=(0, 2))}
    ct = u
    for l in range(L - 1, 0, -1):
        h_in = hs[l - 1]
        g[f"W{l}"] = jnp.einsum("tin,ton->io", h_in, ct, precision=_HI,
                                preferred_element_type=jnp.float32)
        g[f"b{l}"] = jnp.sum(ct.astype(jnp.float32), axis=(0, 2))
        ct = jnp.einsum("io,ton->tin", params[f"W{l}"], ct,
                        precision=_HI) \
            * (1.0 - h_in.astype(jnp.float32) * h_in)
        if store_dtype is not None:
            ct = ct.astype(store_dtype)
    g["W0"] = jnp.einsum("tin,ton->io", obs_ff, ct, precision=_HI,
                         preferred_element_type=jnp.float32)
    g["b0"] = jnp.sum(ct.astype(jnp.float32), axis=(0, 2))
    return g, mu, logp_old
