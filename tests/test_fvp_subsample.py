"""Bound the fvp_subsample estimator error (SURVEY.md section 4.8
spirit): c3-c5 run CG on a stride-8 subsample of the
batch (classic TRPO subsample_factor — the Fisher is an expectation, so
a strided subsample estimates it at 1/8 the CG cost). These tests pin
(a) the natural-gradient direction: cosine(x_sub, x_exact) at c3-like
scale, and (b) a short training A/B: subsampled convergence within a
band of exact-FVP convergence.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C2_REACHER3, C3_FRANKA7
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.trpo.train import init_state
from trpo_robot_control_tpu.trpo.update import trpo_update


def _cfg(sub, n_envs=192, horizon=25):
    return C3_FRANKA7.replace(
        n_envs=n_envs, horizon=horizon,
        trpo=dataclasses.replace(C3_FRANKA7.trpo, fvp_subsample=sub))


def test_subsampled_direction_cosine():
    """The stride-8 CG direction stays within cosine >= 0.99 of the
    exact-FVP direction on a real c3-small batch (bound chosen from the
    observed margin; fails if subsampling materially bends the natural
    gradient)."""
    cfg1, cfg8 = _cfg(1), _cfg(8)
    state = init_state(cfg1, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(cfg1, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(7))

    def direction(cfg):
        _, _, st = jax.jit(lambda p, w, b: trpo_update(
            cfg, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        return np.asarray(st["x"], np.float64)

    x1 = direction(cfg1)
    x8 = direction(cfg8)
    cos = x1 @ x8 / (np.linalg.norm(x1) * np.linalg.norm(x8))
    assert cos > 0.99, cos


def test_c2_stride4_direction_cosine():
    """c2 adopted fvp_subsample=4 in round 3 from a measured decision
    (scripts/measure_c2_stride.py: min cosine 0.99956 over 3 seeds at
    full scale, convergence A/B indistinguishable from exact). This pins
    the bound at reduced scale so a regression in the stride path or the
    c2 config is caught by CI."""
    def c2(sub):
        return C2_REACHER3.replace(
            n_envs=256, horizon=40,
            trpo=dataclasses.replace(C2_REACHER3.trpo, fvp_subsample=sub))

    assert C2_REACHER3.trpo.fvp_subsample == 4  # the adopted decision
    cfg1, cfg4 = c2(1), c2(4)
    state = init_state(cfg1, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(cfg1, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(3))

    def direction(cfg):
        _, _, st = jax.jit(lambda p, w, b: trpo_update(
            cfg, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        return np.asarray(st["x"], np.float64)

    x1, x4 = direction(cfg1), direction(cfg4)
    cos = x1 @ x4 / (np.linalg.norm(x1) * np.linalg.norm(x4))
    assert cos > 0.995, cos


@pytest.mark.slow
def test_subsampled_convergence_ab():
    """Training with fvp_subsample=8 must track exact-FVP training: same
    seed, 12 iterations, final-3-iteration mean return within a 15%
    band of the exact run's improvement."""
    from trpo_robot_control_tpu.trpo.train import train
    hist = {}
    for sub in (1, 8):
        _, h = train(_cfg(sub, n_envs=96, horizon=20), n_iters=12, seed=0)
        hist[sub] = [x["mean_return"] for x in h]
    r0 = np.mean(hist[1][:3])
    gain1 = np.mean(hist[1][-3:]) - r0
    gain8 = np.mean(hist[8][-3:]) - np.mean(hist[8][:3])
    assert gain1 > 0, hist[1]
    assert gain8 > 0.85 * gain1, (hist[1], hist[8])


def test_env_subsample_direction_cosine():
    """fvp_env_subsample strides the i.i.d. ENV axis on top of the time
    stride (round 5, scripts/measure_fvp_env_stride.py: the time
    stride's cosine cliff is time-bias, not sample count, so large-N
    configs shed surplus Fisher samples over envs). At c3-small scale
    the env-only stride (t=1, e=4) must stay close to the exact
    direction, and adding e=2 to the t=8 stride must not bend the
    direction beyond the t-stride's own estimate (bounds from observed
    margins; they catch a broken env-slice, not estimator noise)."""
    def cfg(t_sub, e_sub, n_envs=192, horizon=24):
        return C3_FRANKA7.replace(
            n_envs=n_envs, horizon=horizon,
            trpo=dataclasses.replace(C3_FRANKA7.trpo, fvp_subsample=t_sub,
                                     fvp_env_subsample=e_sub))

    base = cfg(1, 1)
    state = init_state(base, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(base, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(7))

    def direction(c):
        _, _, st = jax.jit(lambda p, w, b, c=c: trpo_update(
            c, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        return np.asarray(st["x"], np.float64)

    def cos(a, b):
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))

    x_exact = direction(base)
    assert cos(x_exact, direction(cfg(1, 4))) > 0.96  # observed 0.983
    x_t8 = direction(cfg(8, 1))
    x_t8e2 = direction(cfg(8, 2))
    assert cos(x_t8, x_t8e2) > 0.98  # observed 0.996


def test_env_subsample_ff_kernel_path():
    """The env stride composes with the feature-first batch and the
    ff-native FVP kernel resolver (interpret on CPU): forced-pallas
    rollout gives an (obs_ff, actions_ff) batch, and the env-strided
    update must stay close to the unstrided one."""
    def cfg(e_sub):
        return C3_FRANKA7.replace(
            n_envs=256, horizon=16, rollout_impl="pallas",
            trpo=dataclasses.replace(C3_FRANKA7.trpo, fvp_subsample=8,
                                     fvp_env_subsample=e_sub))

    base = cfg(1)
    state = init_state(base, seed=0)
    rollout_fn = arm.make_rollout_fn(base)
    batch = jax.jit(rollout_fn)(state.params, jax.random.PRNGKey(7))
    assert "obs_ff" in batch

    def direction(c):
        _, _, st = jax.jit(lambda p, w, b, c=c: trpo_update(
            c, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        return np.asarray(st["x"], np.float64)

    x1, x2 = direction(base), direction(cfg(2))
    cos = x1 @ x2 / (np.linalg.norm(x1) * np.linalg.norm(x2))
    assert cos > 0.99, cos  # observed 0.9977
