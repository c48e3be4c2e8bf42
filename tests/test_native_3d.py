"""Native C++ backend, 3-D RNEA path (SURVEY.md section 3 "CPU compute
implementation" row): the general world-frame RNEA
integrator must match oracle/dynamics.py step-for-step at fp64
tolerance, the c3-small native update must match the oracle update, and
the 3-D rollout (7-DoF + gravity + obstacle) must be sane/deterministic.
"""
import shutil

import numpy as np
import pytest

if shutil.which("g++") is None:
    pytest.skip("no C++ toolchain", allow_module_level=True)

import native
from oracle import net as onet
from oracle.dynamics import ArmModel
from oracle.trpo import OracleEnv, collect_rollouts, trpo_update
from trpo_robot_control_tpu.configs import (C3_FRANKA7,
                                            C4_FRANKA7_OBSTACLE,
                                            C5_MULTITASK)

CFG = C3_FRANKA7.replace(n_envs=12, horizon=20)


def test_native_step_matches_oracle_3d():
    model = ArmModel(CFG.arm)
    rng = np.random.RandomState(0)
    n = CFG.arm.n_joints
    for trial in range(5):
        q = rng.uniform(-1.0, 1.0, n)
        qd = rng.uniform(-2.0, 2.0, n)
        tau = rng.uniform(-3.0, 3.0, n)
        q_o, qd_o = model.step(q.copy(), qd.copy(), tau)
        q_n, qd_n, ee_n, _, _ = native.step(CFG, q, qd, tau)
        np.testing.assert_allclose(q_n, q_o, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(qd_n, qd_o, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ee_n, model.ee_pos(q_o),
                                   rtol=1e-10, atol=1e-12)


def test_native_update_matches_oracle_c3():
    rng = np.random.RandomState(0)
    params = onet.init_params(rng, CFG.arm.obs_dim, CFG.arm.n_joints,
                              CFG.trpo.hidden, CFG.trpo.logstd_init)
    env = OracleEnv(CFG)
    batch = collect_rollouts(CFG, env, params, rng)
    w0 = np.zeros(2 * CFG.arm.obs_dim + 4)

    new_o, w_o, st_o = trpo_update(CFG, params, w0.copy(), batch)
    flat = onet.flatten(params)
    flat_n, w_n, st_n = native.update(CFG, flat.copy(), w0.copy(), batch)

    np.testing.assert_allclose(st_n["beta"], st_o["beta"], rtol=1e-9)
    assert st_n["accepted"] == st_o["accepted"]
    np.testing.assert_allclose(st_n["kl"], st_o["kl"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(flat_n, onet.flatten(new_o), rtol=1e-8,
                               atol=1e-10)


def test_native_rollout_3d_obstacle():
    cfg = C4_FRANKA7_OBSTACLE.replace(n_envs=8, horizon=15)
    rng = np.random.RandomState(1)
    params = onet.init_params(rng, cfg.arm.obs_dim, cfg.arm.n_joints,
                              cfg.trpo.hidden, cfg.trpo.logstd_init)
    flat = onet.flatten(params)
    batch = native.rollout(cfg, flat, seed=7)
    assert np.isfinite(batch["obs"]).all()
    assert np.isfinite(batch["rewards"]).all()
    assert (batch["rewards"] <= 0).all()
    n = cfg.arm.n_joints
    assert np.abs(batch["obs"][..., :2 * n]).max() <= 1.0 + 1e-12
    batch2 = native.rollout(cfg, flat, seed=7)
    np.testing.assert_array_equal(batch["obs"], batch2["obs"])
    # obstacle penalty active: c4 rewards must dip below the pure
    # reach+ctrl cost recomputed from obs/actions (penalty adds cost)
    d2 = np.sum(batch["obs"][..., 3 * n:] ** 2, axis=-1)
    # obs holds the PRE-step delta; just check reward never exceeds the
    # control-only bound
    tau = np.clip(batch["actions"], -cfg.arm.torque_limit,
                  cfg.arm.torque_limit)
    bound = -cfg.cost.ctrl_weight * np.sum(tau ** 2, axis=-1)
    assert (batch["rewards"] <= bound + 1e-12).all()


def test_native_training_3d_stable():
    """All-native training loop at c3-small: rollout + update in C++
    only. A 7-DoF gravity arm shows no measurable return improvement at
    unit-test horizons (25 steps; the real c3 runs horizon 200 for 300
    iterations — the JAX engine is equally flat here, verified), so this
    asserts the training CONTRACT instead: finite stats, KL within the
    trust region, steps accepted, and returns staying in band across 12
    updates. Exactness is pinned by the oracle-parity tests above."""
    cfg = CFG.replace(n_envs=64, horizon=25)
    rng = np.random.RandomState(0)
    params = onet.init_params(rng, cfg.arm.obs_dim, cfg.arm.n_joints,
                              cfg.trpo.hidden, cfg.trpo.logstd_init)
    flat = onet.flatten(params)
    w = np.zeros(2 * cfg.arm.obs_dim + 4)
    rets = []
    for it in range(12):
        batch = native.rollout(cfg, flat, seed=100 + it)
        flat, w, st = native.update(cfg, flat, w, batch)
        assert np.isfinite(st["mean_return"]) and np.isfinite(st["kl"])
        assert st["kl"] <= cfg.trpo.delta + 1e-9, st
        assert st["accepted"] < cfg.trpo.ls_steps
        rets.append(st["mean_return"])
    assert np.all(np.isfinite(flat))
    # returns stay in a sane band (no divergence/blow-up)
    assert max(rets) - min(rets) < 5.0, rets


def test_native_step_reward_matches_oracle_all_variants():
    """The native step's REWARD (obstacle + track/push families) must
    reproduce oracle/trpo.py:OracleEnv.step in fp64: replay shared
    states/actions through both for c4 (obstacle) and c5 (multitask)."""
    for cfg in (C4_FRANKA7_OBSTACLE.replace(n_envs=6, horizon=8),
                C5_MULTITASK.replace(n_envs=9, horizon=8)):
        rng = np.random.RandomState(3)
        env = OracleEnv(cfg)
        n = cfg.arm.n_joints
        N, T = cfg.n_envs, cfg.horizon
        q, qd, tgt = env.reset(rng, N)
        tasks = env.task if cfg.n_tasks > 1 else np.zeros(N, int)
        for t in range(T):
            a = 2.0 * rng.standard_normal((N, n))
            tau = np.clip(a, -cfg.arm.torque_limit, cfg.arm.torque_limit)
            q2o, qd2o, tgt2o, rew_o = env.step(q, qd, tgt, a)
            for e in range(N):
                q2n, qd2n, ee_n, tgt2n, rew_n = native.step(
                    cfg, q[e], qd[e], tau[e], tgt=tgt[e],
                    task=int(tasks[e]))
                np.testing.assert_allclose(q2n, q2o[e], rtol=1e-10,
                                           atol=1e-12)
                np.testing.assert_allclose(tgt2n, tgt2o[e], rtol=1e-12,
                                           atol=1e-15)
                np.testing.assert_allclose(rew_n, rew_o[e], rtol=1e-9,
                                           atol=1e-11)
            q, qd, tgt = q2o, qd2o, tgt2o


def test_native_rollout_multitask():
    """Native c5-small rollout: one-hot task channels present and
    consistent, rewards finite/deterministic."""
    cfg = C5_MULTITASK.replace(n_envs=12, horizon=10)
    rng = np.random.RandomState(2)
    params = onet.init_params(rng, cfg.obs_dim, cfg.arm.n_joints,
                              cfg.trpo.hidden, cfg.trpo.logstd_init)
    flat = onet.flatten(params)
    batch = native.rollout(cfg, flat, seed=5)
    assert batch["obs"].shape[-1] == cfg.obs_dim
    oh = batch["obs"][..., -cfg.n_tasks:]
    # exactly one active task channel per sample, constant over time
    np.testing.assert_allclose(oh.sum(-1), 1.0)
    assert (oh == oh[:, :1, :]).all()
    assert set(np.argmax(oh[:, 0], -1)) >= {0, 1}   # multiple families
    assert np.isfinite(batch["rewards"]).all()
    batch2 = native.rollout(cfg, flat, seed=5)
    np.testing.assert_array_equal(batch["obs"], batch2["obs"])
