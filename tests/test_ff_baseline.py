"""Feature-first baseline pipeline (models/baseline.py:features_ff +
the obs_ff path in trpo/update.py): identical results to the standard
layout up to fp32 reassociation. The fused rollout kernels emit obs_ff
natively; here it is synthesised by transposing a scan-path batch."""
import numpy as np

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import baseline, policy
from trpo_robot_control_tpu.trpo.train import init_state
from trpo_robot_control_tpu.trpo.update import trpo_update

CFG = C1_REACHER2.replace(n_envs=32, horizon=20)


def test_features_ff_matches_features():
    obs = jax.random.normal(jax.random.PRNGKey(0), (8, 20, 9))
    phi = baseline.features(obs, CFG.horizon)            # (N, T, F)
    phi_ff = baseline.features_ff(jnp.transpose(obs, (1, 2, 0)),
                                  CFG.horizon)           # (T, F, N)
    np.testing.assert_allclose(np.asarray(jnp.transpose(phi_ff,
                                                        (2, 0, 1))),
                               np.asarray(phi), rtol=1e-6, atol=1e-7)


def test_normal_eq_ff_matches_phi_moments():
    """The block-decomposed normal equations (phi never materialised)
    equal phi^T phi / phi^T y up to fp32 reassociation."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    obs = jax.random.normal(k1, (8, 20, 9))
    y = jax.random.normal(k2, (8, 20))
    phi = np.asarray(baseline.features(obs, CFG.horizon))
    F = phi.shape[-1]
    phi_f = phi.reshape(-1, F).astype(np.float64)
    A_ref = phi_f.T @ phi_f
    b_ref = phi_f.T @ np.asarray(y, np.float64).reshape(-1)
    A, b = baseline.normal_eq_ff(jnp.transpose(obs, (1, 2, 0)), y.T,
                                 CFG.horizon)
    np.testing.assert_allclose(np.asarray(A), A_ref, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-5,
                               atol=1e-4)


def test_values_ff_matches_predict():
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    obs = jax.random.normal(k1, (8, 20, 9))
    w = jax.random.normal(k2, (baseline.n_features(9),))
    v_ref = baseline.predict(w, baseline.features(obs, CFG.horizon))
    v = baseline.values_ff(w, jnp.transpose(obs, (1, 2, 0)), CFG.horizon)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref),
                               rtol=1e-5, atol=1e-6)


def test_surrogate_grad_ff_bf16_close():
    """bf16-stored activations/cotangents (trpo.ff_store_dtype="bf16")
    bound: the surrogate gradient stays within 0.999 cosine and ~1%
    relative norm of the fp32-exact gradient."""
    state = init_state(CFG, seed=0)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    T, N, do, da = 20, 64, CFG.obs_dim, CFG.arm.n_joints
    obs_ff = jax.random.normal(k1, (T, do, N))
    act_ff = 0.3 * jax.random.normal(k2, (T, da, N))
    adv_ff = jax.random.normal(k3, (T, N))
    g32, mu32, lp32 = policy.surrogate_grad_ff(state.params, obs_ff,
                                               act_ff, adv_ff)
    g16, mu16, lp16 = policy.surrogate_grad_ff(
        state.params, obs_ff, act_ff, adv_ff, store_dtype=jnp.bfloat16)
    v32, _ = ravel_pytree(g32)
    v16, _ = ravel_pytree(g16)
    v32, v16 = np.asarray(v32), np.asarray(v16)
    cos = v32 @ v16 / (np.linalg.norm(v32) * np.linalg.norm(v16))
    assert cos > 0.999, cos
    assert np.linalg.norm(v16 - v32) / np.linalg.norm(v32) < 0.02
    # mu/logp_old feed the line search: same bound applies
    assert jnp.max(jnp.abs(mu16 - mu32)) < 5e-3
    assert jnp.max(jnp.abs(lp16 - lp32)) < 5e-2


def test_normal_eq_ff_bf16_close():
    """bf16 kernel-emitted obs_ff: the normal-equation moments stay
    fp32-accumulated and close to the exact fp32 ones (the ridge +
    eigh-floor fit absorbs ~0.3% moment noise)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    obs = jax.random.normal(k1, (8, 20, 9))
    y = jax.random.normal(k2, (8, 20))
    obs_ff = jnp.transpose(obs, (1, 2, 0))
    A32, b32 = baseline.normal_eq_ff(obs_ff, y.T, CFG.horizon)
    A16, b16 = baseline.normal_eq_ff(obs_ff.astype(jnp.bfloat16), y.T,
                                     CFG.horizon)
    assert A16.dtype == jnp.float32 and b16.dtype == jnp.float32
    scale = float(jnp.max(jnp.abs(A32)))
    assert float(jnp.max(jnp.abs(A16 - A32))) / scale < 2e-2
    scale_b = float(jnp.max(jnp.abs(b32))) + 1e-6
    assert float(jnp.max(jnp.abs(b16 - b32))) / scale_b < 2e-2
    v32 = baseline.values_ff(jnp.ones(baseline.n_features(9)), obs_ff,
                             CFG.horizon)
    v16 = baseline.values_ff(jnp.ones(baseline.n_features(9)),
                             obs_ff.astype(jnp.bfloat16), CFG.horizon)
    assert v16.dtype == jnp.float32
    assert float(jnp.max(jnp.abs(v16 - v32))) \
        / (float(jnp.max(jnp.abs(v32))) + 1e-6) < 2e-2


def test_values_ff_bf16_weight_cast_bounded():
    """values_ff on the bf16 path rounds the baseline WEIGHTS to bf16
    too (models/baseline.py:values_ff: w_o.astype(obs_ff.dtype)), the
    one bf16 rounding site without its own bound until round 4.
    Isolate that term: fp64 reference on the SAME
    bf16-quantised obs with EXACT weights — the residual is pure weight
    rounding + fp32 accumulation, <= a few bf16 ulps relative."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    obs = jax.random.normal(k1, (8, 20, 9))
    w = jax.random.normal(k2, (baseline.n_features(9),))
    obs16 = jnp.transpose(obs, (1, 2, 0)).astype(jnp.bfloat16)
    v16 = np.asarray(baseline.values_ff(w, obs16, CFG.horizon))  # (N, T)
    # fp64 reference with exact weights on the quantised obs
    o64 = np.asarray(obs16, np.float64)                 # (T, do, N)
    T, do, N = o64.shape
    w64 = np.asarray(w, np.float64)
    t = np.arange(T, dtype=np.float64) / CFG.horizon
    tau = np.stack([t, t ** 2, t ** 3, np.ones_like(t)], axis=1)
    v_ref = (np.einsum("tdn,d->tn", o64, w64[:do])
             + np.einsum("tdn,d->tn", o64 * o64, w64[do:2 * do])
             + (tau @ w64[2 * do:])[:, None]).T         # (N, T)
    scale = np.abs(v_ref).max() + 1e-6
    assert np.abs(v16 - v_ref).max() / scale < 1e-2


def test_update_with_bf16_ff_batch_close():
    """A fully bf16-stored ff batch (kernel-emitted obs_ff/actions_ff +
    bf16 hidden storage, i.e. trpo.ff_store_dtype="bf16") yields a step
    direction within 0.99 cosine and a beta within 2% of the fp32 one."""
    import dataclasses
    state = init_state(CFG, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(CFG, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(11))
    batch_ff = dict(batch)
    batch_ff["obs_ff"] = jnp.transpose(batch["obs"], (1, 2, 0))
    batch_ff["actions_ff"] = jnp.transpose(batch["actions"], (1, 2, 0))
    cfg16 = CFG.replace(trpo=dataclasses.replace(CFG.trpo,
                                                 ff_store_dtype="bf16"))
    _, _, st32 = jax.jit(lambda p, w, b: trpo_update(
        CFG, p, w, b, return_directions=True))(state.params, state.w,
                                               batch_ff)
    batch16 = dict(batch_ff)
    batch16["obs_ff"] = batch_ff["obs_ff"].astype(jnp.bfloat16)
    batch16["actions_ff"] = batch_ff["actions_ff"].astype(jnp.bfloat16)
    _, _, st16 = jax.jit(lambda p, w, b: trpo_update(
        cfg16, p, w, b, return_directions=True))(state.params, state.w,
                                                 batch16)
    x32 = np.asarray(st32["x"], np.float64)
    x16 = np.asarray(st16["x"], np.float64)
    cos = x32 @ x16 / (np.linalg.norm(x32) * np.linalg.norm(x16))
    assert cos > 0.99, cos
    np.testing.assert_allclose(float(st16["beta"]), float(st32["beta"]),
                               rtol=2e-2)
    assert int(st16["accepted"]) == int(st32["accepted"])


def test_update_with_obs_ff_matches_standard():
    state = init_state(CFG, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(CFG, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(42))
    p1, w1, st1 = jax.jit(lambda p, w, b: trpo_update(CFG, p, w, b))(
        state.params, state.w, batch)

    batch_ff = dict(batch)
    batch_ff["obs_ff"] = jnp.transpose(batch["obs"], (1, 2, 0))
    batch_ff["actions_ff"] = jnp.transpose(batch["actions"], (1, 2, 0))
    p2, w2, st2 = jax.jit(lambda p, w, b: trpo_update(CFG, p, w, b))(
        state.params, state.w, batch_ff)

    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=2e-3, atol=2e-4)
    assert int(st1["accepted"]) == int(st2["accepted"])
    np.testing.assert_allclose(float(st1["beta"]), float(st2["beta"]),
                               rtol=2e-3)
    # baseline weights in prediction space (same freedom as test_parity)
    phi = np.asarray(baseline.features(batch["obs"], CFG.horizon))
    v1 = phi @ np.asarray(w1)
    v2 = phi @ np.asarray(w2)
    scale = np.abs(v1).mean() + 1e-6
    assert np.abs(v1 - v2).max() / scale < 2e-2
