"""Batched arm-reaching environment as pure JAX functions.

Design (SURVEY.md section 2 L4): `(state, action, params) -> (state, obs,
reward)` pure functions, `vmap`-ed over envs and `lax.scan`-rolled over the
horizon — the on-device replacement for the reference's C/Python stepped
simulator. Distributions (init state, target annulus) mirror the fp64
oracle (oracle/trpo.py:OracleEnv) exactly; sequences differ (threefry vs
MT19937), which the parity tests account for by sharing batches.

Task families (config 5, SURVEY.md section 4 "Multi-task"):
  0 reach: static target
  1 track: target orbits world z at cost.track_omega rad/s
  2 push:  reach + match EE velocity to push_speed * dir(to target)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..configs.base import ExperimentConfig
from . import rigid_body as rb
from .rigid_body import ArmConstants


class EnvState(NamedTuple):
    q: jax.Array       # (..., n) joint angles
    qd: jax.Array      # (..., n) joint velocities
    tgt: jax.Array     # (..., 3) target position (world)
    task: jax.Array    # (...,) int32 task family id


def reset(cfg: ExperimentConfig, key, n_envs: int) -> EnvState:
    spec = cfg.arm
    n = spec.n_joints
    planar = ArmConstants(spec).planar
    kq, kqd, kr, kth, ku, kt = jax.random.split(key, 6)
    q = spec.q0_noise * jax.random.uniform(kq, (n_envs, n), minval=-1.0,
                                           maxval=1.0)
    qd = spec.qd0_noise * jax.random.uniform(kqd, (n_envs, n), minval=-1.0,
                                             maxval=1.0)
    r = jax.random.uniform(kr, (n_envs,), minval=spec.target_rmin_frac,
                           maxval=spec.target_rmax_frac) * spec.reach
    if planar:
        th = jax.random.uniform(kth, (n_envs,), minval=0.0,
                                maxval=2.0 * jnp.pi)
        tgt = jnp.stack([r * jnp.cos(th), r * jnp.sin(th),
                         jnp.zeros_like(r)], axis=-1)
    else:
        u = jax.random.normal(ku, (n_envs, 3))
        u = u / (jnp.linalg.norm(u, axis=-1, keepdims=True) + 1e-12)
        u = u.at[:, 2].set(jnp.abs(u[:, 2]))
        tgt = r[:, None] * u
    if cfg.n_tasks > 1:
        task = jax.random.randint(kt, (n_envs,), 0, cfg.n_tasks)
    else:
        task = jnp.zeros(n_envs, jnp.int32)
    return EnvState(q=q, qd=qd, tgt=tgt, task=task)


def observe(cfg: ExperimentConfig, state: EnvState) -> jax.Array:
    """[cos q, sin q, qd*scale, tgt - ee (, task one-hot)] — frozen layout
    matching oracle/trpo.py:OracleEnv.obs."""
    spec = cfg.arm
    ee = rb.ee_pos(spec, state.q)
    parts = [jnp.cos(state.q), jnp.sin(state.q),
             spec.qd_obs_scale * state.qd, state.tgt - ee]
    if cfg.n_tasks > 1:
        parts.append(jax.nn.one_hot(state.task, cfg.n_tasks,
                                    dtype=state.q.dtype))
    return jnp.concatenate(parts, axis=-1)


def _rot_z_apply(omega_dt, v):
    c, s = jnp.cos(omega_dt), jnp.sin(omega_dt)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x - s * y, s * x + c * y, z], axis=-1)


def step(cfg: ExperimentConfig, state: EnvState, action: jax.Array):
    """Applies clipped torques; reward at the POST-step state (matches the
    oracle). Returns (new_state, reward)."""
    spec, cost = cfg.arm, cfg.cost
    tau = jnp.clip(action, -spec.torque_limit, spec.torque_limit)
    q2, qd2 = rb.dynamics_step(spec, state.q, state.qd, tau)

    # track task: target moves before being scored
    if cfg.n_tasks > 1:
        tgt = jnp.where((state.task == 1)[..., None],
                        _rot_z_apply(cost.track_omega * spec.dt, state.tgt),
                        state.tgt)
    else:
        tgt = state.tgt

    R, p, ee = rb.fk(spec, q2)
    delta = ee - tgt
    reward = -(jnp.sum(delta ** 2, axis=-1)
               + cost.ctrl_weight * jnp.sum(tau ** 2, axis=-1))

    if cfg.n_tasks > 1:
        # push task: additionally match EE velocity to an approach velocity
        v_ee = _ee_velocity(spec, q2, qd2, R, p, ee)
        dirn = -delta / (jnp.linalg.norm(delta, axis=-1, keepdims=True) + 1e-6)
        v_err = v_ee - cost.push_speed * dirn
        push_pen = cost.push_weight * jnp.sum(v_err ** 2, axis=-1)
        reward = reward - jnp.where(state.task == 2, push_pen, 0.0)

    if cost.obstacle_weight > 0.0:
        reward = reward - cost.obstacle_weight * obstacle_penalty(
            cfg, p, ee)

    return EnvState(q=q2, qd=qd2, tgt=tgt, task=state.task), reward


def _ee_velocity(spec, q, qd, R, p, ee):
    """v_ee = sum_i qd_i * axis_i x (p_ee - p_i); axis_i = R_i z_hat."""
    z_hat = jnp.asarray([0.0, 0.0, 1.0], q.dtype)
    v = jnp.zeros_like(ee)
    for i in range(ArmConstants(spec).n):
        axis = jnp.einsum("...ij,j->...i", R[i], z_hat)
        v = v + qd[..., i:i + 1] * jnp.cross(axis, ee - p[i])
    return v


def obstacle_penalty(cfg: ExperimentConfig, joint_pos, ee):
    """Smooth contact-free sphere penalty: sum_pts relu(r - d)^2
    (SURVEY.md section 4: obstacle adds a smooth distance penalty)."""
    cost = cfg.cost
    center = jnp.asarray(cost.obstacle_center, ee.dtype)
    pen = jnp.zeros(ee.shape[:-1], ee.dtype)
    for pt in list(joint_pos[1:]) + [ee]:       # skip base joint (fixed)
        d = jnp.linalg.norm(pt - center, axis=-1)
        pen = pen + jnp.maximum(cost.obstacle_radius - d, 0.0) ** 2
    return pen


def resolve_rollout_impl(cfg: ExperimentConfig, backend: str) -> str:
    """The rollout implementation for `backend` (a jax backend name):

    - "xla":    generic vmap + lax.scan path (any config, any backend);
    - "pallas": the fused rollout kernel (ops/pallas/rollout3d_kernel.py)
      for any arm and task mix, compiled through Triton on the GPU and
      run in interpret mode on the CPU;
    - "auto":   the kernel on the GPU, the scan on any other backend.

    Early termination (done_dist > 0) needs in-kernel episode
    resampling, which the kernel does not have: "auto" routes such
    configs to the scan, and an explicit "pallas" is an error.
    """
    impl = cfg.rollout_impl
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown rollout_impl {impl!r}")
    if impl == "auto":
        impl = "pallas" if backend == "gpu" and cfg.done_dist == 0.0 \
            else "xla"
    if impl == "pallas" and cfg.done_dist > 0.0:
        raise ValueError("rollout_impl='pallas' has no early termination; "
                         "use 'auto' or 'xla' with done_dist > 0")
    return impl


def make_rollout_fn(cfg: ExperimentConfig):
    """Returns fn(params, key, n_envs=None) -> batch dict, with the
    implementation chosen by resolve_rollout_impl for the default
    backend (static, at trace-graph build)."""
    from ..models import policy as _policy

    backend = jax.default_backend()
    if resolve_rollout_impl(cfg, backend) == "xla":
        return lambda params, key, n_envs=None: rollout(
            cfg, params, _policy.sample, key, n_envs=n_envs)

    from ..ops.pallas.rollout3d_kernel import pallas_rollout3d

    # kernel-side bf16 emission of obs_ff/actions_ff feeds the
    # feature-first update path pre-rounded operands and halves the
    # rollout's output writes
    store = jnp.bfloat16 if cfg.trpo.ff_store_dtype == "bf16" else None

    def fn(params, key, n_envs=None):
        return pallas_rollout3d(cfg, params, key, n_envs=n_envs,
                                interpret=backend == "cpu",
                                store_dtype=store)

    return fn


def rollout(cfg: ExperimentConfig, params, policy_sample, key, n_envs=None):
    """Collect a fresh batch: reset all envs, scan the horizon.

    `policy_sample(params, obs, key) -> action` keeps the policy pluggable.
    Returns dict(obs (N,T,do), actions (N,T,da), rewards (N,T)) plus
    dones (N,T) when early termination is enabled (cfg.done_dist > 0):
    an env whose post-step end-effector reaches within done_dist of the
    target is flagged done and auto-reset to a fresh episode before the
    next step (mirrors oracle/trpo.py:collect_rollouts).
    """
    n_envs = cfg.n_envs if n_envs is None else n_envs
    terminating = cfg.done_dist > 0.0
    k_reset, k_roll = jax.random.split(key)
    state0 = reset(cfg, k_reset, n_envs)

    def body(carry, key_t):
        state = carry
        o = observe(cfg, state)
        if terminating:
            k_act, k_re = jax.random.split(key_t)
        else:
            k_act = key_t
        a = policy_sample(params, o, k_act)
        state2, r = step(cfg, state, a)
        if not terminating:
            return state2, (o, a, r, jnp.zeros_like(r))
        ee = rb.ee_pos(cfg.arm, state2.q)
        done = jnp.sum((ee - state2.tgt) ** 2, axis=-1) \
            < cfg.done_dist ** 2
        fresh = reset(cfg, k_re, n_envs)
        state3 = jax.tree.map(
            lambda new, old: jnp.where(
                done.reshape(done.shape + (1,) * (new.ndim - 1)),
                new, old),
            fresh, state2)
        return state3, (o, a, r, done.astype(r.dtype))

    keys = jax.random.split(k_roll, cfg.horizon)
    _, (obs, act, rew, don) = jax.lax.scan(body, state0, keys)
    # scan stacks on axis 0 (time); transpose to (N, T, ...)
    batch = dict(obs=jnp.swapaxes(obs, 0, 1),
                 actions=jnp.swapaxes(act, 0, 1),
                 rewards=jnp.swapaxes(rew, 0, 1))
    if terminating:
        # the final step always terminates (fixed buffer end, no bootstrap)
        batch["dones"] = jnp.swapaxes(don, 0, 1).at[:, -1].set(1.0)
    return batch
