"""Linear-feature value baseline, fit fully on-device (SURVEY.md section 3
"Value baseline"): ridge regression on phi(s, t) = [obs, obs^2, t/T,
(t/T)^2, (t/T)^3, 1], solved with a Cholesky factorisation — no host
round-trip. Feature layout matches oracle/trpo.py:baseline_features.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def n_features(obs_dim: int) -> int:
    return 2 * obs_dim + 4


def features(obs, horizon: int):
    """obs (N, T, do) -> phi (N, T, F)."""
    N, T, do = obs.shape
    t = (jnp.arange(T, dtype=obs.dtype) / horizon)[None, :, None]
    t = jnp.broadcast_to(t, (N, T, 1))
    return jnp.concatenate(
        [obs, obs ** 2, t, t ** 2, t ** 3, jnp.ones_like(t)], axis=-1)


def features_ff(obs_ff, horizon: int):
    """Feature-first twin of `features`: obs_ff (T, do, N) -> phi
    (T, F, N), same feature order along F. Consumes the fused rollout
    kernels' native layout so the normal equations need no (F, B)
    transpose (trpo/update.py)."""
    T, do, N = obs_ff.shape
    t = (jnp.arange(T, dtype=obs_ff.dtype) / horizon)[:, None, None]
    t = jnp.broadcast_to(t, (T, 1, N))
    return jnp.concatenate(
        [obs_ff, obs_ff ** 2, t, t ** 2, t ** 3, jnp.ones_like(t)],
        axis=1)


def _time_features(T, horizon, dtype):
    """tau (T, 4) = [t, t^2, t^3, 1] in units of t/horizon."""
    t = jnp.arange(T, dtype=dtype) / horizon
    return jnp.stack([t, t ** 2, t ** 3, jnp.ones_like(t)], axis=1)


def values_ff(w, obs_ff, horizon: int, tn: bool = False):
    """predict() without materialising phi: obs_ff (T, do, N) -> values
    (N, T), or the kernel-native (T, N) when tn=True (the ff update
    pipeline runs (T, N) end-to-end so no full-batch transposes are
    emitted — trpo/update.py). The time-feature term is per-timestep
    constant, so only the obs/obs^2 einsums touch the batch (the squares
    fuse into the reads; phi_ff at c5 scale is a 3 GB intermediate).

    obs_ff may be bf16 (kernel-emitted storage, trpo.ff_store_dtype);
    every contraction accumulates fp32 and the time features are always
    fp32 (t^3 in bf16 would lose the fit's conditioning). The weights
    round to the storage dtype too — bounded by tests/test_ff_baseline
    .py::test_values_ff_bf16_weight_cast_bounded."""
    T, do, N = obs_ff.shape
    w_o, w_q, w_t = w[:do], w[do:2 * do], w[2 * do:]
    f32 = jnp.float32
    v = jnp.einsum("tdn,d->tn", obs_ff, w_o.astype(obs_ff.dtype),
                   preferred_element_type=f32) \
        + jnp.einsum("tdn,d->tn", obs_ff * obs_ff,
                     w_q.astype(obs_ff.dtype),
                     preferred_element_type=f32) \
        + (_time_features(T, horizon, f32) @ w_t)[:, None]
    return v if tn else v.T


def normal_eq_ff(obs_ff, targets_tn, horizon: int):
    """LOCAL normal-equation moments (A, b) for the ridge fit, straight
    from the kernel layout: obs_ff (T, do, N), targets_tn (T, N) ->
    (A (F, F), b (F,)) with the features() ordering
    [obs, obs^2, t, t^2, t^3, 1].

    Same math as phi^T phi / phi^T y, reassociated by feature block so
    the (T, F, N) phi never exists: the time features are constant
    across envs (their Gram block is closed-form T-space math), and the
    data-dependent blocks come from ONE Gram of v = [obs, obs^2, y] —
    a single pass over the batch — plus one (T, 4) cross-contraction.
    Under shard_map, psum (A, b) before fit_normal: every block is a
    plain sum over local samples (the tau Gram scales by local N).

    obs_ff may be bf16 (trpo.ff_store_dtype): the Gram then reads bf16
    operands (targets join v in the storage dtype to keep
    the ONE-pass structure) while A, b, and every contraction
    accumulate fp32, and the time-feature blocks are exact fp32 (their
    conditioning drives fit_normal's eigh floor). The bf16 rounding of
    y adds ~0.2% unbiased per-sample noise to a 13M-sample average —
    bounded end-to-end by the c4-scale convergence A/B (the c3 note in
    configs/__init__.py).
    """
    T, do, N = obs_ff.shape
    dt = obs_ff.dtype
    f32 = jnp.float32
    tau = _time_features(T, horizon, f32)                   # (T, 4)
    y_ff = targets_tn[:, None, :].astype(dt)                # (T, 1, N)
    v = jnp.concatenate([obs_ff, obs_ff * obs_ff, y_ff], axis=1)
    # fp32 mode: HIGHEST keeps full fp32 products — at DEFAULT an
    # accelerator may round fp32 operands (TF32 on the GPU, ~1e-3
    # relative), which degrades the ill-conditioned fit (fit_normal).
    # bf16 mode keeps DEFAULT: bf16 operands are already exact in fp32
    # accumulation.
    prec = (jax.lax.Precision.HIGHEST if dt == f32
            else jax.lax.Precision.DEFAULT)
    G = jnp.einsum("tfn,tgn->fg", v, v, precision=prec,
                   preferred_element_type=f32)   # [[A_uu, b_u], ...]
    C = jnp.einsum("tfn,tk->fk", v.astype(f32), tau,
                   precision=jax.lax.Precision.HIGHEST)  # fp32 operands
    A_tt = N * (tau.T @ tau)
    F = 2 * do + 4
    A = jnp.zeros((F, F), f32)
    A = A.at[:2 * do, :2 * do].set(G[:2 * do, :2 * do])
    A = A.at[:2 * do, 2 * do:].set(C[:2 * do])
    A = A.at[2 * do:, :2 * do].set(C[:2 * do].T)
    A = A.at[2 * do:, 2 * do:].set(A_tt)
    b = jnp.concatenate([G[:2 * do, 2 * do], C[2 * do]])
    return A, b


def predict(w, phi):
    return phi @ w


def fit(phi_flat, targets_flat, reg: float):
    """Solve (phi^T phi + reg I) w = phi^T y with Cholesky.

    With data sharding, pass pre-reduced (psum'd) A and b via fit_normal
    instead — see trpo/update.py.
    """
    A, b = normal_eq(phi_flat, targets_flat)
    return fit_normal(A + reg * jnp.eye(A.shape[0], dtype=A.dtype), b)


def normal_eq(phi_flat, targets_flat):
    """Normal-equation moments (phi^T phi, phi^T y) in full fp32:
    cond(A) reaches ~1e8 (fit_normal), so a TF32 or bf16 matmul pass
    would spoil the fit."""
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(phi_flat.T, phi_flat, precision=hi),
            jnp.matmul(phi_flat.T, targets_flat, precision=hi))


def fit_normal(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """Solve the (ridge-regularised) normal equations robustly at fp32.

    The normal equations square the feature matrix's condition number;
    on near-converged policies cond(A) reaches ~1e8 — past the fp32
    Cholesky cliff (observed: NaN weights that then poison GAE targets
    and freeze training). Method:

    1. Jacobi scaling D^-1/2 A D^-1/2 (exact-arithmetic no-op);
    2. eigendecomposition solve with a RELATIVE eigenvalue floor —
       directions with lambda < rel_floor * lambda_max are dropped
       (pseudo-inverse); they are near-null of Phi^T Phi and contribute
       ~nothing to predictions, which is what parity tests compare.

    F is small (2*obs_dim + 4), so eigh costs microseconds.
    """
    d = jnp.sqrt(jnp.diagonal(A) + eps)
    A_s = A / (d[:, None] * d[None, :])
    lam, Q = jnp.linalg.eigh(A_s)
    inv = jnp.where(lam > rel_floor * lam[-1], 1.0 / lam, 0.0)
    w_s = Q @ (inv * (Q.T @ (b / d)))
    w = w_s / d
    # belt-and-braces: a non-finite fit degrades to a zero baseline for
    # one iteration instead of permanently poisoning the GAE targets
    return jnp.where(jnp.isfinite(w), w, 0.0)


# ----------------------------------------------------------------- MLP
# Optional small-MLP baseline (SURVEY.md section 3 "Value baseline:
# linear time-feature fit or small MLP"). Same phi(s, t) features, tanh
# MLP -> scalar value, refit each update with a fixed number of
# full-batch Adam steps inside the jit (warm-started across updates;
# fresh Adam moments per refit keep TrainState.w a plain param pytree).


def init_mlp(key, n_in: int, hidden):
    params = {}
    dims = [n_in] + list(hidden) + [1]
    for i, (m, n) in enumerate(zip(dims[:-1], dims[1:])):
        key, k = jax.random.split(key)
        params[f"W{i}"] = jax.random.normal(k, (m, n)) * jnp.sqrt(2.0 / m)
        params[f"b{i}"] = jnp.zeros(n)
    return params


def predict_mlp(w, phi):
    """phi (..., F) -> values (...)."""
    L = sum(1 for k in w if k.startswith("W"))
    h = phi
    for i in range(L - 1):
        h = jnp.tanh(h @ w[f"W{i}"] + w[f"b{i}"])
    return (h @ w[f"W{L - 1}"] + w[f"b{L - 1}"])[..., 0]


def fit_mlp(w, phi_flat, targets_flat, lr: float, steps: int,
            axis_name=None):
    """`steps` full-batch Adam steps on MSE (pmean-reduced gradients
    under shard_map so every shard applies the identical update)."""
    b1, b2, eps_a = 0.9, 0.999, 1e-8

    def loss(p):
        return jnp.mean((predict_mlp(p, phi_flat) - targets_flat) ** 2)

    def body(carry, i):
        p, m, v = carry
        g = jax.grad(loss)(p)
        if axis_name is not None:
            g = jax.lax.pmean(g, axis_name)
        m = jax.tree.map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = jax.tree.map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
        t = i + 1.0
        scale = jnp.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        p = jax.tree.map(
            lambda pp, mm, vv: pp - lr * scale * mm
            / (jnp.sqrt(vv) + eps_a), p, m, v)
        return (p, m, v), ()

    zeros = jax.tree.map(jnp.zeros_like, w)
    (p, _, _), _ = jax.lax.scan(
        body, (w, zeros, zeros), jnp.arange(steps, dtype=jnp.float32))
    # same non-finite guard as the linear fit
    return jax.tree.map(lambda new, old: jnp.where(jnp.isfinite(new),
                                                   new, old), p, w)
