"""Tensor parallelism over the mesh's 'model' axis (SURVEY.md section 3
parallelism table — completes the row the round-1 build left as a
reserved-axis stub).

Layout (Megatron-style pairing on the first two layers of the tanh MLP):

- W0 (do, H)  -> column-sharded  (do, H/m)   : h0 shard is complete
- b0 (H,)     -> sharded         (H/m,)        per column, tanh local
- W1 (H, H')  -> row-sharded     (H/m, H')   : partial products
- z1 = psum_model(h0_local @ W1_local) + b1  : ONE collective/forward
- b1, W2.., logstd replicated (head dims are tiny for this policy)

Everything downstream (GAE, baseline, whitening) is batch-space and
unchanged. The update-side machinery generalises by operating on
parameter PYTREES instead of flat vectors:

- gradient: jax.grad through the sharded forward inside shard_map —
  the psum's transpose places cotangents correctly, local leaves get
  exact global-gradient shards with no extra collective;
- GN-FVP: jax.linearize of the sharded forward; the jvp contains the
  forward psum, so F v is the action of the GLOBAL Fisher on the
  sharded tangent automatically;
- CG / line search: ops/cg.py + ops/linesearch.py run leafwise on
  pytrees; the only TP-aware piece is `vdot` (psum over 'model' for
  sharded leaves, local for replicated ones);
- after the update, sharded leaves are all-gathered back so TrainState
  keeps full replicated parameters (checkpointing, kernels, CLI
  unchanged).

A 64-wide MLP gains nothing from TP on real meshes — this exists so the
engine's parallelism surface is complete and so larger policies slot in
without rewiring call sites. Correctness: tests/test_tensor_parallel.py
(TP update on a fixed batch == plain update; TP train step improves).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..configs.base import ExperimentConfig
from ..models import baseline, policy
from ..ops.cg import conjugate_gradient
from ..ops.gae import gae
from ..ops.linesearch import line_search

SHARDED_KEYS = ("W0", "b0", "W1")


def shard_policy_params(params, n_model: int, idx):
    """Replicated full params -> this device's local TP shard."""
    H = params["W0"].shape[1]
    assert H % n_model == 0, (H, n_model)
    k = H // n_model
    local = dict(params)
    local["W0"] = jax.lax.dynamic_slice_in_dim(params["W0"], idx * k, k, 1)
    local["b0"] = jax.lax.dynamic_slice_in_dim(params["b0"], idx * k, k, 0)
    local["W1"] = jax.lax.dynamic_slice_in_dim(params["W1"], idx * k, k, 0)
    return local


def unshard_policy_params(local, n_model: int, idx, model_axis: str):
    """Local TP shard -> replicated full params.

    Implemented as zero-pad-to-full + psum over 'model' (rather than
    all_gather) so shard_map's replication tracking (check_vma=True —
    REQUIRED for TP: with tracking off, the forward psum transposes to
    another psum and every sharded-leaf gradient comes out n_model x too
    large) can prove the outputs replicated."""
    k = local["b0"].shape[0]

    def scatter_psum(x, axis):
        shape = list(x.shape)
        shape[axis] = k * n_model
        full = jnp.zeros(shape, x.dtype)
        full = jax.lax.dynamic_update_slice_in_dim(full, x, idx * k, axis)
        return jax.lax.psum(full, model_axis)

    full = dict(local)
    full["W0"] = scatter_psum(local["W0"], 1)
    full["b0"] = scatter_psum(local["b0"], 0)
    full["W1"] = scatter_psum(local["W1"], 0)
    return full


def mean_net_tp(local, obs, model_axis: str):
    """Sharded tanh-MLP mean: one psum over 'model' per forward; full
    fp32 matmuls like models/policy.py:mean_net."""
    L = policy.n_layers(local)
    assert L >= 3, "TP layout needs >= 2 hidden layers"
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    h0 = jnp.tanh(mm(obs, local["W0"]) + local["b0"])
    z1 = jax.lax.psum(mm(h0, local["W1"]), model_axis) + local["b1"]
    h = jnp.tanh(z1)
    for i in range(2, L - 1):
        h = jnp.tanh(mm(h, local[f"W{i}"]) + local[f"b{i}"])
    return mm(h, local[f"W{L - 1}"]) + local[f"b{L - 1}"]


def dist_tp(local, obs, model_axis: str):
    return mean_net_tp(local, obs, model_axis), local["logstd"]


def make_sample_tp(model_axis: str):
    """policy.sample twin on local TP shards (same key on every model
    shard -> identical actions, since mu is replicated post-psum)."""
    def sample(local, obs, key):
        mu, logstd = dist_tp(local, obs, model_axis)
        return mu + jnp.exp(logstd) * jax.random.normal(key, mu.shape,
                                                        mu.dtype)
    return sample


def make_vdot(model_axis: str):
    """Global inner product of two parameter pytrees where SHARDED_KEYS
    leaves are 'model'-sharded and the rest replicated."""
    def vdot(u, v):
        sh = sum(jnp.vdot(u[k], v[k]) for k in SHARDED_KEYS)
        rep = sum(jnp.vdot(u[k], v[k]) for k in u if k not in SHARDED_KEYS)
        return jax.lax.psum(sh, model_axis) + rep
    return vdot


def make_gn_fvp_tp(local, obs, damping: float, data_axis: str,
                   model_axis: str):
    """Tree-mode Gauss-Newton FVP on TP shards (mirrors
    ops/fvp.py:make_gn_fvp; same math, pytree operands).

    TP runs under check_vma=True, whose AD semantics differ from the
    DP path's check_vma=False: the cotangent of an input that is
    REPLICATED over 'data' is automatically psum'd over 'data' by
    shard_map's transpose. So the data-mean is completed by dividing
    the vjp output by the axis size — an explicit pmean would be an
    identity on the already-summed (replicated) value."""
    B = obs.shape[0]
    inv_var = jnp.exp(-2.0 * local["logstd"])

    def dist_fn(p):
        return dist_tp(p, obs, model_axis)

    _, jvp_fn = jax.linearize(dist_fn, local)
    _, vjp_fn = jax.vjp(dist_fn, local)

    def fvp(v_tree):
        dmu, dlogstd = jvp_fn(v_tree)
        n_d = jax.lax.psum(1.0, data_axis) if data_axis else 1.0
        u_mu = dmu * inv_var / B
        # the mu path's cotangent is auto-psum'd over 'data' (obs makes
        # mu data-varying) and then divided below; the logstd output is
        # data-REPLICATED so its direct cotangent is NOT psum'd —
        # pre-multiply so the shared division leaves it at 2*dlogstd
        u_logstd = 2.0 * n_d * dlogstd
        (gv,) = vjp_fn((u_mu, u_logstd))
        if data_axis:
            gv = jax.tree.map(lambda t: t / n_d, gv)
        return jax.tree.map(lambda g, v: g + damping * v, gv, v_tree)

    return fvp


def trpo_update_tp(cfg: ExperimentConfig, local, w, batch,
                   data_axis: str, model_axis: str):
    """One TRPO update on TP-sharded policy params (local shard in,
    local shard out). Mirrors trpo/update.py step for step; batch is
    the 'data'-shard (replicated across 'model')."""
    tr = cfg.trpo
    obs, actions, rewards = batch["obs"], batch["actions"], batch["rewards"]
    N, T, do = obs.shape
    da = actions.shape[-1]
    B = N * T

    def _pmean(x):
        return jax.lax.pmean(x, data_axis) if data_axis else x

    def _psum(x):
        return jax.lax.psum(x, data_axis) if data_axis else x

    # ---- 1) values -> GAE -> whiten -> targets -> refit (batch space,
    #         identical to the DP path; replicated across 'model' — the
    #         baseline is never TP-sharded, both the linear fit and the
    #         MLP's Adam refit run the same replicated computation on
    #         every model shard with 'data'-reduced moments/gradients)
    mlp_baseline = tr.baseline == "mlp"
    phi = baseline.features(obs, cfg.horizon)
    values = baseline.predict_mlp(w, phi) if mlp_baseline \
        else baseline.predict(w, phi)
    adv_raw = gae(rewards, values, tr.gamma, tr.lam,
                  dones=batch.get("dones"))
    m1 = _pmean(jnp.mean(adv_raw))
    m2 = _pmean(jnp.mean(adv_raw ** 2))
    std = jnp.sqrt(jnp.maximum(m2 - m1 ** 2, 0.0))
    adv = (adv_raw - m1) / (std + 1e-8)
    targets = adv_raw + values
    F = phi.shape[-1]
    phi_f = phi.reshape(B, F)
    if mlp_baseline:
        w_new = baseline.fit_mlp(w, phi_f, targets.reshape(B),
                                 tr.baseline_lr, tr.baseline_epochs,
                                 axis_name=data_axis)
    else:
        A_loc, b_loc = baseline.normal_eq(phi_f, targets.reshape(B))
        A = _psum(A_loc) + tr.baseline_reg * jnp.eye(F, dtype=phi.dtype)
        w_new = baseline.fit_normal(A, _psum(b_loc))

    obs_f = obs.reshape(B, do)
    act_f = actions.reshape(B, da)
    adv_f = adv.reshape(B)

    # ---- 2) policy gradient (tree; local shards get exact global rows)
    mu_old, logstd_old = dist_tp(local, obs_f, model_axis)
    mu_old = jax.lax.stop_gradient(mu_old)
    logstd_old = jax.lax.stop_gradient(logstd_old)
    logp_old = policy.log_prob(mu_old, logstd_old, act_f)

    def local_surrogate(p):
        mu, logstd = dist_tp(p, obs_f, model_axis)
        logp = policy.log_prob(mu, logstd, act_f)
        return jnp.mean(jnp.exp(logp - logp_old) * adv_f)

    g = jax.grad(local_surrogate)(local)
    if data_axis:
        # check_vma=True AD auto-psums cotangents of data-replicated
        # params over 'data' (see make_gn_fvp_tp); divide to a mean
        n_d = jax.lax.psum(1.0, data_axis)
        g = jax.tree.map(lambda t: t / n_d, g)
    surr_old = _pmean(jnp.mean(adv_f))

    # ---- 3) CG on the damped TP FVP
    obs_fvp = obs_f[::tr.fvp_subsample] if tr.fvp_subsample > 1 else obs_f
    fvp = make_gn_fvp_tp(local, obs_fvp, tr.cg_damping, data_axis,
                         model_axis)
    vdot = make_vdot(model_axis)
    x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters,
                                                 vdot=vdot)

    # ---- 4) step size from the CG invariant (no extra FVP call)
    xhx = vdot(x, g) - vdot(x, r_final)
    beta = jnp.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # ---- 5) line search on pytrees
    def eval_fn(cand):
        mu, logstd = dist_tp(cand, obs_f, model_axis)
        logp = policy.log_prob(mu, logstd, act_f)
        surr = _pmean(jnp.mean(jnp.exp(logp - logp_old) * adv_f))
        kl = _pmean(policy.kl(mu_old, logstd_old, mu, logstd))
        return surr, kl

    full_step = jax.tree.map(lambda s: beta * s, x)
    new_local, accepted, kl_new, surr_new = line_search(
        eval_fn, local, full_step, surr_old, tr.delta,
        tr.ls_steps, tr.ls_backtrack)

    g_norm = jnp.sqrt(vdot(g, g))
    step_sq = vdot(jax.tree.map(jnp.subtract, new_local, local),
                   jax.tree.map(jnp.subtract, new_local, local))
    stats = dict(
        beta=beta, accepted=accepted, kl=kl_new, surr=surr_new,
        surr_old=surr_old, g_norm=g_norm,
        step_norm=jnp.sqrt(step_sq),
        cg_residual=cg_residual, xhx=xhx,
        entropy=policy.entropy(local["logstd"]),
        mean_return=_pmean(jnp.mean(jnp.sum(rewards, axis=1))),
        adv_std=std,
    )
    return new_local, w_new, stats
