"""The TRPO natural-gradient update — one traced function, fully on-device
(SURVEY.md sections 4, 5.1). Mirrors oracle/trpo.py:trpo_update step for
step; parity is enforced by tests/test_parity.py (cosine(x) >= 0.999,
|beta| rel err <= 1e-3, same accepted line-search exponent).

All batch reductions go through `_pmean`/`_psum` keyed on an optional mesh
axis name, so the SAME code runs single-device (axis_name=None) and under
`shard_map` over the 'data' axis (parallel/mesh.py) — the collectives are
the only difference (SURVEY.md section 7 "Distributed communication").
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..configs.base import ExperimentConfig
from ..models import baseline, policy
from ..ops.cg import conjugate_gradient
from ..ops.fvp import make_gn_fvp
from ..ops.gae import gae
from ..ops.linesearch import line_search


def _pmean(x, axis_name):
    return jax.lax.pmean(x, axis_name) if axis_name else x


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name else x


def trpo_update(cfg: ExperimentConfig, params, w, batch,
                axis_name: Optional[str] = None,
                return_directions: bool = False):
    """One TRPO update on a collected batch.

    batch: dict(obs (N,T,do), actions (N,T,da), rewards (N,T)
    [, dones (N,T)]) — the LOCAL shard when running under shard_map.
    Returns (new_params, new_w, stats).
    """
    tr = cfg.trpo
    obs, actions, rewards = batch["obs"], batch["actions"], batch["rewards"]
    N, T, do = obs.shape
    da = actions.shape[-1]
    B = N * T

    # ---- 1) values (old baseline) -> GAE -> whiten -> targets -> refit.
    # When the batch carries the fused rollout kernel's feature-first
    # obs (T, do, N), the whole linear-baseline pipeline runs in that
    # layout, (T, N)-native end to end: values_ff returns (T, N), GAE
    # scans time axis 0, and the normal equations are decomposed by
    # feature block (models/baseline.py:normal_eq_ff) so the (T, F, N)
    # phi never exists. Same math, reassociated.
    mlp_baseline = tr.baseline == "mlp"
    obs_ff = batch.get("obs_ff") if not mlp_baseline else None
    if obs_ff is not None:
        rewards_tn = batch.get("rewards_ff")
        if rewards_tn is None:
            rewards_tn = rewards.T
        dones_tn = batch.get("dones_ff")
        if dones_tn is None and "dones" in batch:
            dones_tn = batch["dones"].T
        values = baseline.values_ff(w, obs_ff, cfg.horizon,
                                    tn=True)             # (T, N)
        adv_raw = gae(rewards_tn, values, tr.gamma, tr.lam,
                      dones=dones_tn, time_axis=0)       # (T, N)
    else:
        phi = baseline.features(obs, cfg.horizon)
        values = baseline.predict_mlp(w, phi) if mlp_baseline \
            else baseline.predict(w, phi)
        adv_raw = gae(rewards, values, tr.gamma, tr.lam,
                      dones=batch.get("dones"))

    m1 = _pmean(jnp.mean(adv_raw), axis_name)
    m2 = _pmean(jnp.mean(adv_raw ** 2), axis_name)
    std = jnp.sqrt(jnp.maximum(m2 - m1 ** 2, 0.0))
    adv = (adv_raw - m1) / (std + 1e-8)
    targets = adv_raw + values

    if obs_ff is not None:
        A_loc, b_loc = baseline.normal_eq_ff(obs_ff, targets, cfg.horizon)
        A = _psum(A_loc, axis_name) \
            + tr.baseline_reg * jnp.eye(A_loc.shape[0], dtype=A_loc.dtype)
        b_vec = _psum(b_loc, axis_name)
        w_new = baseline.fit_normal(A, b_vec)
    else:
        F = phi.shape[-1]
        phi_f = phi.reshape(B, F)
        if mlp_baseline:
            w_new = baseline.fit_mlp(w, phi_f, targets.reshape(B),
                                     tr.baseline_lr, tr.baseline_epochs,
                                     axis_name=axis_name)
        else:
            A_loc, b_loc = baseline.normal_eq(phi_f, targets.reshape(B))
            A = _psum(A_loc, axis_name) \
                + tr.baseline_reg * jnp.eye(F, dtype=phi.dtype)
            w_new = baseline.fit_normal(A, _psum(b_loc, axis_name))

    # ---- 2) flatten the batch. On the ff path adv is (T, N): align it
    # with the n-major obs_f/act_f order for the (rare) obs_ff-without-
    # actions_ff combination; when actions_ff is present this adv_f is
    # dead code (the ff surrogate and surr_old consume adv directly).
    obs_f = obs.reshape(B, do)
    act_f = actions.reshape(B, da)
    adv_f = (adv.T if obs_ff is not None else adv).reshape(B)

    # ---- 3) policy gradient of the surrogate at theta_old. With a
    # kernel-emitted batch (obs_ff/actions_ff) the policy math runs in
    # the same feature-first layout as the baseline pipeline above: the
    # closed-form gradient (models/policy.py:surrogate_grad_ff) sums
    # over (t, n) with no batch-major arrays.
    theta_old, unravel = ravel_pytree(params)
    ff = obs_ff is not None and "actions_ff" in batch
    if ff:
        act_ff = batch["actions_ff"]
        adv_ff = adv                                # already (T, N)
        store = jnp.bfloat16 if tr.ff_store_dtype == "bf16" else None
        g_tree, mu_old_ff, logp_old_ff = policy.surrogate_grad_ff(
            params, obs_ff, act_ff, adv_ff, store_dtype=store)
        logstd_old = params["logstd"]
    else:
        mu_old, logstd_old = policy.dist(params, obs_f)
        mu_old = jax.lax.stop_gradient(mu_old)
        logstd_old = jax.lax.stop_gradient(logstd_old)
        logp_old = policy.log_prob(mu_old, logstd_old, act_f)

        def local_surrogate(p):
            mu, logstd = policy.dist(p, obs_f)
            logp = policy.log_prob(mu, logstd, act_f)
            return jnp.mean(jnp.exp(logp - logp_old) * adv_f)

        g_tree = jax.grad(local_surrogate)(params)
    g, _ = ravel_pytree(g_tree)
    g = _pmean(g, axis_name)
    surr_old = _pmean(jnp.mean(adv), axis_name)     # ratio == 1

    # ---- 4) CG on the damped Gauss-Newton FVP (the reference's
    # accelerator boundary, SURVEY.md section 5.2 — here: traced
    # matvecs + one pmean per call across the cards).
    # Classic TRPO subsample_factor: the Fisher is an expectation — a
    # strided subsample estimates it at 1/k the CG cost (stride keeps the
    # subsample spread across envs and timesteps deterministically). On
    # the ff path the stride is taken over time in the (T, do, N)
    # layout: with T % k == 0 that selects the SAME sample set as
    # obs_f[::k] (t = 0 mod k for every env; the Fisher sum is order-
    # free), and only the small subsample gets relaid to (B/k, do).
    if ff and tr.fvp_subsample > 1:
        assert obs_ff.shape[0] % tr.fvp_subsample == 0, (
            "ff-path fvp_subsample matches obs_f[::k] only when "
            "horizon %% fvp_subsample == 0; got T="
            f"{obs_ff.shape[0]}, k={tr.fvp_subsample}")
        sub = obs_ff[::tr.fvp_subsample]
        if tr.fvp_env_subsample > 1:
            # Env-axis stride on top of the time stride (unbiased —
            # envs are i.i.d. by construction, same argument as
            # ls_subsample below; the time stride alone is where the
            # bias cliff lives, see TRPOSpec.fvp_env_subsample). XLA
            # fuses both strides into the one gather that materialises
            # the compact (T', do, N') subsample.
            assert N % tr.fvp_env_subsample == 0, (
                "fvp_env_subsample needs (local) n_envs % k == 0 so "
                "the strided env set is sharding-invariant; got N="
                f"{N}, k={tr.fvp_env_subsample}")
            sub = sub[..., ::tr.fvp_env_subsample]
        # only the 1/k subsample is relaid to (B/k, do), in fp32
        # whatever the storage dtype
        obs_fvp = jnp.transpose(sub, (0, 2, 1)).reshape(-1, do) \
            .astype(jnp.float32)
    else:
        src_f = obs_f
        if tr.fvp_env_subsample > 1:
            # n-major layout: slice envs before flattening (obs is
            # (N, T, do) here), matching the ff branch's env set.
            assert N % tr.fvp_env_subsample == 0, (
                "fvp_env_subsample needs (local) n_envs % k == 0; got "
                f"N={N}, k={tr.fvp_env_subsample}")
            src_f = obs[::tr.fvp_env_subsample].reshape(-1, do)
        obs_fvp = src_f[::tr.fvp_subsample] if tr.fvp_subsample > 1 \
            else src_f
    fvp = make_gn_fvp(params, unravel, obs_fvp, tr.cg_damping,
                      axis_name=axis_name)
    x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters)

    # ---- 5) KL-constrained step size from damped curvature. CG gives
    # F x = g - r exactly, so x^T F x = x.g - x.r — no extra FVP call
    # (mathematically identical to the oracle's explicit fvp(x)).
    xhx = jnp.dot(x, g) - jnp.dot(x, r_final)
    beta = jnp.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # ---- 6) backtracking line search (on-device while_loop). With
    # ls_subsample = k > 1 the acceptance statistics are estimated on a
    # 1/k subsample of ENVS — like the Fisher (fvp_subsample above),
    # the surrogate and KL are batch expectations, and each candidate
    # eval is a full forward pass over the batch, so the subsampled
    # estimate costs 1/k. The subsample unit must be
    # whole TRAJECTORIES, not a time stride: GAE advantages and the
    # state distribution are strongly time-structured, so a t % k slice
    # is a BIASED estimator (measured: KL off 2-3x, mean adv off ~9
    # sigma at c3-small), while envs are i.i.d. by construction (reset
    # state, task family, and action noise are all per-env random), so
    # any fixed env subset is an unbiased one. The env slice is STRIDED
    # (every k-th env): with local N % k == 0 the union of per-shard
    # strided sets equals the global strided set, so the subsample —
    # and hence the accepted exponent — is sharding-invariant (the
    # sharded == unsharded contract of test_sharding.py /
    # dryrun_multichip). surr_old is re-estimated on the SAME envs
    # (ratio == 1 at theta_old, so it is the subsample's mean
    # advantage), making the improvement test a paired comparison.
    # Estimator bounds: tests/test_ls_subsample.py; full-scale
    # accepted-k agreement + convergence A/B: configs/__init__.py.
    k_ls = tr.ls_subsample
    if k_ls > 1:
        assert N % k_ls == 0, (
            "ls_subsample needs (local) n_envs % ls_subsample == 0 so "
            "the strided env set is sharding-invariant; got N="
            f"{N}, k={k_ls}")
        if ff:
            obs_ls, act_ls = obs_ff[..., ::k_ls], act_ff[..., ::k_ls]
            adv_ls = adv_ff[:, ::k_ls]
            mu_old_ls = mu_old_ff[..., ::k_ls]
            logp_old_ls = logp_old_ff[:, ::k_ls]
        else:
            # obs_f is n-major: slice envs before flattening. adv is
            # (T, N) when obs_ff is present without actions_ff (the
            # combination line ~136 supports) — mirror adv_f's
            # transpose so the stride hits the ENV axis, not time.
            obs_ls = obs[::k_ls].reshape(-1, do)
            act_ls = actions[::k_ls].reshape(-1, da)
            adv_ls = (adv.T if obs_ff is not None
                      else adv)[::k_ls].reshape(-1)
            mu_old_ls = mu_old.reshape(N, T, da)[::k_ls].reshape(-1, da)
            logp_old_ls = logp_old.reshape(N, T)[::k_ls].reshape(-1)
        surr_old_ls = _pmean(jnp.mean(adv_ls), axis_name)
    else:
        if ff:
            obs_ls, act_ls, adv_ls = obs_ff, act_ff, adv_ff
            mu_old_ls, logp_old_ls = mu_old_ff, logp_old_ff
        else:
            obs_ls, act_ls, adv_ls = obs_f, act_f, adv_f
            mu_old_ls, logp_old_ls = mu_old, logp_old
        surr_old_ls = surr_old

    def eval_fn(theta_c):
        p = unravel(theta_c)
        if ff:
            mu, logstd = policy.dist_ff(
                p, obs_ls, hs=policy.hidden_ff(p, obs_ls,
                                               store_dtype=store))
            logp = policy.log_prob_ff(mu, logstd, act_ls)
            surr = _pmean(jnp.mean(jnp.exp(logp - logp_old_ls) * adv_ls),
                          axis_name)
            kl = _pmean(policy.kl_ff(mu_old_ls, logstd_old, mu, logstd),
                        axis_name)
        else:
            mu, logstd = policy.dist(p, obs_ls)
            logp = policy.log_prob(mu, logstd, act_ls)
            surr = _pmean(jnp.mean(jnp.exp(logp - logp_old_ls) * adv_ls),
                          axis_name)
            kl = _pmean(policy.kl(mu_old_ls, logstd_old, mu, logstd),
                        axis_name)
        return surr, kl

    theta_new, accepted, kl_new, surr_new = line_search(
        eval_fn, theta_old, beta * x, surr_old_ls, tr.delta,
        tr.ls_steps, tr.ls_backtrack)
    new_params = unravel(theta_new)

    stats = dict(
        beta=beta, accepted=accepted, kl=kl_new, surr=surr_new,
        surr_old=surr_old, g_norm=jnp.linalg.norm(g),
        step_norm=jnp.linalg.norm(theta_new - theta_old),
        cg_residual=cg_residual, xhx=xhx,
        entropy=policy.entropy(params["logstd"]),
        # ff path: sum the kernel-native (T, N) rewards over time so the
        # batch-major rewards copy stays dead code in the fused step
        mean_return=_pmean(
            jnp.mean(jnp.sum(rewards_tn, axis=0)) if obs_ff is not None
            else jnp.mean(jnp.sum(rewards, axis=1)), axis_name),
        adv_std=std,
    )
    if return_directions:
        stats["g"] = g
        stats["x"] = x
    return new_params, w_new, stats
