"""The fused rollout kernel on the planar arms (c1/c2) in interpret mode:
the component math against the generic RNEA path, the kernel against
its plain twin, the zero-padded in-kernel MLP against the plain MLP at
non-power-of-two widths, and env counts that need padding to the tile."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trpo_robot_control_tpu.configs import C1_REACHER2, C2_REACHER3
from trpo_robot_control_tpu.configs.base import TRPOSpec
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import (
    _mlp_rows, _padded_mlp, _policy_ff, pallas_rollout3d,
    rollout3d_reference, rollout_tile)


def _setup(cfg, N, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = policy.init_params(k1, cfg.obs_dim, cfg.arm.n_joints,
                                cfg.trpo.hidden, cfg.trpo.logstd_init)
    state0 = arm.reset(cfg, k2, N)
    eps = jax.random.normal(k3, (cfg.horizon, N, cfg.arm.n_joints))
    return params, state0, eps


def _rnea_path_rollout(cfg, params, state0, eps):
    sigma = jnp.exp(params["logstd"])

    def body(state, eps_t):
        o = arm.observe(cfg, state)
        a = policy.mean_net(params, o) + sigma * eps_t
        state2, r = arm.step(cfg, state, a)
        return state2, (o, a, r)

    _, (obs, act, rew) = jax.lax.scan(body, state0, eps)
    return dict(obs=jnp.swapaxes(obs, 0, 1),
                actions=jnp.swapaxes(act, 0, 1),
                rewards=jnp.swapaxes(rew, 0, 1))


def _kernel_vs_reference(cfg, N, atol=1e-5, **kw):
    params, state0, eps = _setup(cfg, N)
    ref = jax.jit(lambda: rollout3d_reference(cfg, params, state0.q,
                                              state0.qd, state0.tgt,
                                              eps))()
    pal = pallas_rollout3d(cfg, params, jax.random.PRNGKey(0), n_envs=N,
                           eps=eps, interpret=True, q0=state0.q,
                           qd0=state0.qd, tgt=state0.tgt, **kw)
    for k in ("obs", "actions", "rewards"):
        assert pal[k].shape == ref[k].shape, k
        np.testing.assert_allclose(np.asarray(pal[k]),
                                   np.asarray(ref[k]), atol=atol,
                                   err_msg=k)
    return pal


@pytest.mark.parametrize("cfg,N", [(C1_REACHER2.replace(horizon=20), 16),
                                   (C2_REACHER3.replace(horizon=15), 8)])
def test_feature_first_math_matches_rnea_path(cfg, N):
    params, state0, eps = _setup(cfg, N)
    ref = jax.jit(lambda: _rnea_path_rollout(cfg, params, state0, eps))()
    ff = jax.jit(lambda: rollout3d_reference(cfg, params, state0.q,
                                             state0.qd, state0.tgt,
                                             eps))()
    for k, atol in (("obs", 5e-5), ("actions", 5e-5), ("rewards", 2e-4)):
        np.testing.assert_allclose(np.asarray(ff[k]), np.asarray(ref[k]),
                                   atol=atol, err_msg=k)


def test_pallas_kernel_matches_reference_interpret():
    _kernel_vs_reference(C2_REACHER3.replace(horizon=10), 64)


@pytest.mark.parametrize("N", [5, 17, 33])
def test_kernel_pads_env_count_interpret(N):
    """Env counts that are not a multiple of the tile: padded envs run
    zero states and are dropped, so every real env matches the twin."""
    bb, _ = rollout_tile(N)
    assert N % bb or N < bb
    _kernel_vs_reference(C1_REACHER2.replace(horizon=6), N)


@pytest.mark.parametrize("hidden", [(48, 40), (33, 57)])
def test_kernel_non_pow2_hidden_interpret(hidden):
    cfg = C1_REACHER2.replace(horizon=6, trpo=TRPOSpec(hidden=hidden))
    _kernel_vs_reference(cfg, 24)


def test_pallas_kernel_bf16_interpret():
    """bf16 emission: the in-kernel trajectory stays fp32 and rounds once
    at the store, so it equals the fp32 run rounded to bf16."""
    cfg = C2_REACHER3.replace(horizon=6)
    pal = _kernel_vs_reference(cfg, 40)
    params, state0, eps = _setup(cfg, 40)
    pal16 = pallas_rollout3d(cfg, params, jax.random.PRNGKey(0),
                             n_envs=40, eps=eps, interpret=True,
                             q0=state0.q, qd0=state0.qd, tgt=state0.tgt,
                             store_dtype=jnp.bfloat16)
    for k in ("obs_ff", "actions_ff"):
        assert pal16[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(pal16[k]), np.asarray(pal[k].astype(jnp.bfloat16)))
    assert pal16["rewards"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(pal16["rewards"]),
                                  np.asarray(pal["rewards"]))


@pytest.mark.parametrize("do,hidden,da,B", [
    (9, (64, 64), 2, 32),        # c1 widths
    (12, (48, 40), 3, 16),       # non-power-of-two hidden
    (24, (33, 57), 7, 32),       # odd hidden, 7-DoF head
    (27, (64,), 7, 64),          # c5 obs, one hidden layer
])
def test_padded_mlp_equals_plain(do, hidden, da, B):
    """The kernel's MLP (one-hot scatter of obs rows, pl.dot on weights
    zero-padded to powers of two, masked row sums back out) equals the
    plain feature-first MLP: the padding contributes exact zeros."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(do + da))
    params = policy.init_params(k1, do, da, hidden, -0.5)
    params = {k: v + 0.1 for k, v in params.items()}   # nonzero biases
    obs = jax.random.normal(k2, (do, B))
    L = len(hidden) + 1
    ref = _policy_ff([params[f"W{i}"] for i in range(L)],
                     [params[f"b{i}"][:, None] for i in range(L)], obs)
    Ws, bs = _padded_mlp(params)
    for W in Ws:
        assert all(d >= 16 and d & (d - 1) == 0 for d in W.shape)
    out = _mlp_rows(Ws, bs, list(obs), da, jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.stack(out), np.asarray(ref), atol=1e-5)


def test_rollout_tile():
    """One env per thread in one-warp programs; small counts get the
    smallest power-of-two tile >= 16 that covers them."""
    assert rollout_tile(65536) == (32, 1)
    assert rollout_tile(64) == (32, 1)
    assert rollout_tile(20) == (32, 1)
    assert rollout_tile(5) == (16, 1)
    assert rollout_tile(16) == (16, 1)
