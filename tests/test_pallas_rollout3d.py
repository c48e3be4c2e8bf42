"""Fused rollout kernel on the 7-DoF arm vs its twins: component math ==
generic RNEA path (which is itself validated against the fp64 oracle and
MuJoCo), and the Pallas-Triton kernel == plain twin in interpret mode."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trpo_robot_control_tpu.configs import (C3_FRANKA7,
                                            C4_FRANKA7_OBSTACLE)
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import (
    pallas_rollout3d, rollout3d_reference)


def _setup(cfg, N, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    params = policy.init_params(k1, cfg.obs_dim, cfg.arm.n_joints,
                                cfg.trpo.hidden, cfg.trpo.logstd_init)
    state0 = arm.reset(cfg, k2, N)
    eps = jax.random.normal(k3, (cfg.horizon, N, cfg.arm.n_joints))
    return params, state0, eps


def _rnea_path_rollout(cfg, params, state0, eps):
    sigma = jnp.exp(params["logstd"])

    def body(state, eps_t):
        o = arm.observe(cfg, state)
        mu = policy.mean_net(params, o)
        a = mu + sigma * eps_t
        state2, r = arm.step(cfg, state, a)
        return state2, (o, a, r)

    _, (obs, act, rew) = jax.lax.scan(body, state0, eps)
    return dict(obs=jnp.swapaxes(obs, 0, 1),
                actions=jnp.swapaxes(act, 0, 1),
                rewards=jnp.swapaxes(rew, 0, 1))


@pytest.mark.parametrize("cfg", [
    C3_FRANKA7.replace(horizon=8),
    C4_FRANKA7_OBSTACLE.replace(horizon=8),     # exercises obstacle cost
])
def test_component_math_matches_rnea_path(cfg):
    N = 8
    params, state0, eps = _setup(cfg, N)
    ref = jax.jit(lambda: _rnea_path_rollout(cfg, params, state0, eps))()
    ff = jax.jit(lambda: rollout3d_reference(cfg, params, state0.q,
                                             state0.qd, state0.tgt,
                                             eps))()
    np.testing.assert_allclose(np.asarray(ff["obs"]),
                               np.asarray(ref["obs"]), atol=5e-4)
    np.testing.assert_allclose(np.asarray(ff["actions"]),
                               np.asarray(ref["actions"]), atol=5e-4)
    np.testing.assert_allclose(np.asarray(ff["rewards"]),
                               np.asarray(ref["rewards"]), atol=2e-3)


def _kernel_vs_reference(cfg, N, atol=1e-5, **kw):
    params, state0, eps = _setup(cfg, N)
    ref = jax.jit(lambda: rollout3d_reference(cfg, params, state0.q,
                                              state0.qd, state0.tgt, eps,
                                              task=state0.task))()
    pal = pallas_rollout3d(cfg, params, jax.random.PRNGKey(0), n_envs=N,
                           eps=eps, interpret=True, q0=state0.q,
                           qd0=state0.qd, tgt=state0.tgt,
                           task=state0.task, **kw)
    for k in ("obs", "actions", "rewards"):
        np.testing.assert_allclose(np.asarray(pal[k]),
                                   np.asarray(ref[k]), atol=atol,
                                   err_msg=k)
    return pal


def test_pallas3d_kernel_matches_reference_interpret():
    """7-DoF reach; 40 envs pad to two 32-env programs."""
    _kernel_vs_reference(C3_FRANKA7.replace(horizon=5), 40)


def test_pallas3d_kernel_obstacle_interpret():
    """c4's obstacle penalty inside the kernel."""
    _kernel_vs_reference(C4_FRANKA7_OBSTACLE.replace(horizon=4), 32)


def test_pallas3d_kernel_bf16_interpret():
    """The shipped c3-c5 mode: bf16 emission of obs_ff/actions_ff. The
    in-kernel trajectory stays fp32 and rounds once at the store, so it
    equals the fp32 run rounded to bf16; rewards stay fp32."""
    cfg = C3_FRANKA7.replace(horizon=4)
    N = 32
    pal = _kernel_vs_reference(cfg, N)
    params, state0, eps = _setup(cfg, N)
    pal16 = pallas_rollout3d(cfg, params, jax.random.PRNGKey(0), n_envs=N,
                             eps=eps, interpret=True, q0=state0.q,
                             qd0=state0.qd, tgt=state0.tgt,
                             store_dtype=jnp.bfloat16)
    for k in ("obs_ff", "actions_ff"):
        assert pal16[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(pal16[k]), np.asarray(pal[k].astype(jnp.bfloat16)))
    assert pal16["rewards_ff"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(pal16["rewards"]),
                                  np.asarray(pal["rewards"]))


def test_pallas3d_layouts_agree():
    """The feature-first views and the batch-major copies hold the same
    samples: obs_ff (T, do, N) vs obs (N, T, do), rewards_ff (T, N)."""
    cfg = C3_FRANKA7.replace(horizon=3)
    pal = _kernel_vs_reference(cfg, 20)
    np.testing.assert_array_equal(
        np.asarray(pal["obs"]),
        np.transpose(np.asarray(pal["obs_ff"]), (2, 0, 1)))
    np.testing.assert_array_equal(
        np.asarray(pal["actions"]),
        np.transpose(np.asarray(pal["actions_ff"]), (2, 0, 1)))
    np.testing.assert_array_equal(np.asarray(pal["rewards"]),
                                  np.asarray(pal["rewards_ff"]).T)


def test_multitask_component_math_matches_rnea_path():
    """c5: reach/track/push families + task one-hot through the 3-D
    feature-first math vs the generic path."""
    from trpo_robot_control_tpu.configs import C5_MULTITASK
    cfg = C5_MULTITASK.replace(horizon=6)
    N = 12
    params, state0, eps = _setup(cfg, N)
    assert len(set(np.asarray(state0.task))) == 3   # all families present
    ref = jax.jit(lambda: _rnea_path_rollout(cfg, params, state0, eps))()
    ff = jax.jit(lambda: rollout3d_reference(
        cfg, params, state0.q, state0.qd, state0.tgt, eps,
        task=state0.task))()
    np.testing.assert_allclose(np.asarray(ff["obs"]),
                               np.asarray(ref["obs"]), atol=5e-4)
    np.testing.assert_allclose(np.asarray(ff["rewards"]),
                               np.asarray(ref["rewards"]), atol=2e-3)


def test_multitask_pallas_kernel_interpret():
    from trpo_robot_control_tpu.configs import C5_MULTITASK
    _kernel_vs_reference(C5_MULTITASK.replace(horizon=4), 48)
