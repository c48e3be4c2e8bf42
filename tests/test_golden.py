"""Golden-run regression for the oracle (SURVEY.md section 6.1): the
oracle IS the parity contract, so its own seeded trajectory is pinned.
Any change to oracle math, env constants, or RNG consumption order shows
up here as a bit-level diff. Regenerate deliberately with
tests/golden/README instructions if the contract is intentionally
changed.
"""
import os

import numpy as np

from oracle.trpo import train
from trpo_robot_control_tpu.configs import C1_REACHER2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "oracle_c1_seed0.npz")
GOLDEN_ENGINE = os.path.join(os.path.dirname(__file__), "golden",
                             "engine_c1_seed0.npz")
GOLDEN_PROD = os.path.join(os.path.dirname(__file__), "golden",
                           "engine_c3small_fused_seed0.npz")


def test_oracle_matches_golden_run():
    cfg = C1_REACHER2.replace(n_envs=24, horizon=30)
    params, hist = train(cfg, n_iters=8, seed=0)
    g = np.load(GOLDEN)
    np.testing.assert_allclose([h["beta"] for h in hist], g["beta"],
                               rtol=1e-12)
    np.testing.assert_array_equal([h["accepted"] for h in hist],
                                  g["accepted"])
    np.testing.assert_allclose([h["kl"] for h in hist], g["kl"],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose([h["mean_return"] for h in hist],
                               g["mean_return"], rtol=1e-12)
    np.testing.assert_allclose(params["logstd"], g["logstd"], rtol=1e-12)


def test_engine_matches_golden_run():
    """Seeded JAX-engine training curve pinned the same way (the loose
    improvement-ratio convergence test would pass a materially worse
    engine; this would not). fp32 + XLA-version
    tolerance instead of the oracle's fp64 bit tolerance; regenerate via
    tests/golden/README.md when the engine contract changes on purpose."""
    from trpo_robot_control_tpu.trpo.train import train as engine_train
    cfg = C1_REACHER2.replace(n_envs=24, horizon=30)
    state, hist = engine_train(cfg, n_iters=8, seed=0)
    g = np.load(GOLDEN_ENGINE)
    np.testing.assert_array_equal([h["accepted"] for h in hist],
                                  g["accepted"])
    np.testing.assert_allclose([h["beta"] for h in hist], g["beta"],
                               rtol=1e-4)
    np.testing.assert_allclose([h["kl"] for h in hist], g["kl"],
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose([h["mean_return"] for h in hist],
                               g["mean_return"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(state.params["logstd"]),
                               g["logstd"], rtol=1e-4)


def run_production_stack(n_iters=5):
    """c3-small through the PRODUCTION c3-c5 stack on the CPU backend:
    the fused rollout kernel in interpret mode with host-drawn action
    noise and bf16 emission, the feature-first bf16 update path,
    stride-8 FVP subsampling and the 1/8-env line search. Deterministic
    per seed; shared by the golden test and the regeneration recipe
    (tests/golden/README.md)."""
    import jax
    import jax.numpy as jnp

    from trpo_robot_control_tpu.configs import C3_FRANKA7
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import (
        pallas_rollout3d)
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.trpo.update import trpo_update

    # horizon 16: divisible by fvp_subsample=8 (ff-path stride
    # precondition)
    cfg = C3_FRANKA7.replace(n_envs=256, horizon=16)
    assert cfg.trpo.ff_store_dtype == "bf16"      # the shipped c3 mode
    assert cfg.trpo.ls_subsample == 8             # the shipped line search
    state = init_state(cfg, seed=0)

    @jax.jit
    def step(params, w, key):
        key, k_reset, k_eps = jax.random.split(key, 3)
        st0 = arm.reset(cfg, k_reset, cfg.n_envs)
        eps = jax.random.normal(
            k_eps, (cfg.horizon, cfg.n_envs, cfg.arm.n_joints))
        batch = pallas_rollout3d(
            cfg, params, k_eps, eps=eps, interpret=True,
            q0=st0.q, qd0=st0.qd, tgt=st0.tgt,
            store_dtype=jnp.bfloat16)
        params2, w2, stats = trpo_update(cfg, params, w, batch)
        return params2, w2, key, stats

    params, w, key = state.params, state.w, state.key
    hist = []
    for _ in range(n_iters):
        params, w, key, stats = step(params, w, key)
        hist.append({k: float(v) for k, v in stats.items()})
    return params, hist


def test_production_stack_matches_golden_run():
    """Pins the fused c3-c5 stack's math end to end: the c1 engine
    golden covers only the XLA path, so a subtle drift in the rollout
    kernel / ff layout / bf16 storage / stride-8 FVP composition would
    pass every twin test. Any reassociation in that stack fails here on
    plain CPU."""
    params, hist = run_production_stack()
    g = np.load(GOLDEN_PROD)
    np.testing.assert_array_equal([h["accepted"] for h in hist],
                                  g["accepted"])
    np.testing.assert_allclose([h["beta"] for h in hist], g["beta"],
                               rtol=1e-4)
    np.testing.assert_allclose([h["kl"] for h in hist], g["kl"],
                               rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose([h["mean_return"] for h in hist],
                               g["mean_return"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(params["logstd"]),
                               g["logstd"], rtol=1e-4)
