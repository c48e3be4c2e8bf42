"""The Gauss-Newton Fisher-vector product the update runs inside CG
(ops/fvp.py:make_gn_fvp): against an explicit Fisher built from the
per-sample Jacobians, against the KL-Hessian form, inside jit + CG, and
on the feature-first strided subsample that trpo/update.py gathers
from the rollout kernel's (T, do, N) layout."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.ops.cg import conjugate_gradient
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp, make_kl_fvp
from trpo_robot_control_tpu.trpo.update import trpo_update


def _setup(B, do, da, hidden, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = policy.init_params(k1, do, da, hidden, -0.3)
    # non-trivial last layer so the Fisher is not dominated by damping
    params["W%d" % len(hidden)] = params["W%d" % len(hidden)] * 30.0
    obs = jax.random.normal(k2, (B, do))
    theta, unravel = ravel_pytree(params)
    v = jax.random.normal(k3, theta.shape)
    return params, unravel, obs, theta, v


def _jacobian(params, unravel, obs):
    """Per-sample Jacobians J_b of (mu_b, logstd) w.r.t. the flat
    parameters, (B, 2 da, P) in fp64, and the Fisher metric weights
    diag(1/sigma^2, 2)."""
    theta, _ = ravel_pytree(params)

    def out(th, o):
        mu, logstd = policy.dist(unravel(th), o[None])
        return jnp.concatenate([mu[0], logstd])

    J = np.asarray(jax.vmap(jax.jacfwd(out), (None, 0))(theta, obs),
                   np.float64)
    da = params["logstd"].shape[0]
    w = np.concatenate([np.exp(-2.0 * np.asarray(params["logstd"],
                                                 np.float64)),
                        2.0 * np.ones(da)])
    return J, w


def _explicit_fvp(params, unravel, obs, v):
    """F v = (1/B) sum_b J_b^T W J_b v, on the host in fp64."""
    J, w = _jacobian(params, unravel, obs)
    Jv = np.einsum("bkp,p->bk", J, np.asarray(v, np.float64))
    return np.einsum("bkp,bk->p", J, Jv * w) / obs.shape[0]


def _explicit_fisher(params, unravel, obs):
    J, w = _jacobian(params, unravel, obs)
    Jw = (J * np.sqrt(w)[None, :, None]).reshape(-1, J.shape[-1])
    return Jw.T @ Jw / obs.shape[0]


SHAPES = [dict(B=300, do=9, da=2, hidden=(64, 64)),     # c1 widths
          dict(B=512, do=24, da=7, hidden=(64, 64)),    # c3 widths
          dict(B=100, do=5, da=3, hidden=(32,))]        # one hidden layer


@pytest.mark.parametrize("shape", SHAPES)
def test_gn_fvp_matches_explicit_fisher(shape):
    params, unravel, obs, theta, v = _setup(**shape)
    fv = np.asarray(jax.jit(make_gn_fvp(params, unravel, obs, 0.1))(v))
    ref = _explicit_fvp(params, unravel, obs, v) \
        + 0.1 * np.asarray(v, np.float64)
    np.testing.assert_allclose(fv, ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [
    dict(B=300, do=9, da=2, hidden=(64, 64)),
    dict(B=200, do=9, da=2, hidden=(96, 96)),          # > 64 wide
    dict(B=257, do=12, da=3, hidden=(48, 40)),         # odd B and widths
])
def test_gn_fvp_matches_kl_fvp(shape):
    params, unravel, obs, theta, v = _setup(**shape)
    f_gn = jax.jit(make_gn_fvp(params, unravel, obs, 0.0))
    f_kl = jax.jit(make_kl_fvp(params, unravel, obs, 0.0))
    a, b = np.asarray(f_gn(v)), np.asarray(f_kl(v))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * np.abs(b).max())


@pytest.mark.parametrize("damping", [0.1, 0.01])
def test_gn_fvp_linear_and_damped(damping):
    params, unravel, obs, theta, v = _setup(B=64, do=9, da=2,
                                            hidden=(16, 16))
    f = jax.jit(make_gn_fvp(params, unravel, obs, damping))
    f0 = jax.jit(make_gn_fvp(params, unravel, obs, 0.0))
    u = jnp.flip(v)
    np.testing.assert_allclose(np.asarray(f(2.0 * u - 3.0 * v)),
                               np.asarray(2.0 * f(u) - 3.0 * f(v)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(f(v) - f0(v)),
                               np.asarray(damping * v), rtol=1e-4,
                               atol=1e-5)


def test_gn_fvp_symmetric_psd():
    params, unravel, obs, theta, v = _setup(B=128, do=9, da=2,
                                            hidden=(16, 16))
    f = jax.jit(make_gn_fvp(params, unravel, obs, 0.0))
    u = jax.random.normal(jax.random.PRNGKey(9), v.shape)
    assert abs(float(u @ f(v)) - float(v @ f(u))) \
        <= 1e-4 * abs(float(u @ f(v))) + 1e-6
    assert float(v @ f(v)) > 0.0 and float(u @ f(u)) > 0.0


@pytest.mark.parametrize("damping,iters,min_cos", [(0.1, 10, 0.99999),
                                                   (1.0, 5, 0.9999)])
def test_gn_fvp_inside_jit_cg(damping, iters, min_cos):
    """CG on the jitted FVP reaches the direction of the exact solve
    (F + damping I)^-1 g (fp64 on the host)."""
    params, unravel, obs, theta, g = _setup(B=256, do=9, da=2,
                                            hidden=(8, 8))
    F = _explicit_fisher(params, unravel, obs) \
        + damping * np.eye(theta.shape[0])
    x = jax.jit(lambda g: conjugate_gradient(
        make_gn_fvp(params, unravel, obs, damping), g, iters)[0])(g)
    x_ref = np.linalg.solve(F, np.asarray(g, np.float64))
    x = np.asarray(x, np.float64)
    cos = x @ x_ref / (np.linalg.norm(x) * np.linalg.norm(x_ref))
    assert cos >= min_cos, cos


@pytest.mark.parametrize("T,do,N,k,e", [
    (8, 27, 512, 8, 1),      # c5 obs width, time stride only
    (16, 24, 256, 4, 2),     # c3 obs width, both strides
    (24, 24, 64, 8, 4),      # c4's env stride
    (12, 9, 32, 4, 8),       # planar obs, env stride > time stride
])
def test_ff_subsample_matches_batch_major_strides(T, do, N, k, e):
    """obs_ff[::k][..., ::e] (the gather on the kernel's (T, do, N)
    layout) holds exactly the samples of the batch-major path's
    obs[::e].reshape(-1, do)[::k] (env stride, then time stride on the
    n-major flattening), so both FVPs are the same Fisher."""
    obs = jax.random.normal(jax.random.PRNGKey(T + N), (N, T, do))
    obs_ff = jnp.transpose(obs, (1, 2, 0))
    ff = jnp.transpose(obs_ff[::k][..., ::e], (0, 2, 1)).reshape(-1, do)
    bm = obs[::e].reshape(-1, do)[::k]
    assert ff.shape == bm.shape
    key = lambda a: np.lexsort(np.asarray(a).T[::-1])
    np.testing.assert_array_equal(np.asarray(ff)[key(ff)],
                                  np.asarray(bm)[key(bm)])
    params = policy.init_params(jax.random.PRNGKey(1), do, 7, (16, 16),
                                -0.5)
    theta, unravel = ravel_pytree(params)
    v = jax.random.normal(jax.random.PRNGKey(2), theta.shape)
    np.testing.assert_allclose(
        np.asarray(make_gn_fvp(params, unravel, ff, 0.1)(v)),
        np.asarray(make_gn_fvp(params, unravel, bm, 0.1)(v)),
        rtol=1e-4, atol=1e-6)


def _ff_batch(batch):
    """Add the rollout kernel's feature-first views to a batch-major
    batch (same samples)."""
    out = dict(batch)
    out["obs_ff"] = jnp.transpose(batch["obs"], (1, 2, 0))
    out["actions_ff"] = jnp.transpose(batch["actions"], (1, 2, 0))
    out["rewards_ff"] = batch["rewards"].T
    return out


def _c1_batch(N=32, T=16, seed=0, **trpo):
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import init_state
    cfg = C1_REACHER2.replace(
        n_envs=N, horizon=T,
        trpo=dataclasses.replace(C1_REACHER2.trpo, **trpo))
    state = init_state(cfg, seed=seed)
    batch = jax.jit(lambda p, k: arm.rollout(cfg, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(seed + 7))
    return cfg, state, batch


def test_ff_update_matches_batch_major_update():
    """trpo_update on the feature-first views (the kernel's batch) and
    on the batch-major batch: same Fisher subsample, gradient, baseline
    and accepted exponent; near-identical parameters."""
    cfg, state, batch = _c1_batch(fvp_subsample=4, fvp_env_subsample=2)
    upd = jax.jit(lambda b: trpo_update(cfg, state.params, state.w, b,
                                        return_directions=True))
    p_bm, w_bm, st_bm = upd(batch)
    p_ff, w_ff, st_ff = upd(_ff_batch(batch))
    assert int(st_bm["accepted"]) == int(st_ff["accepted"])
    np.testing.assert_allclose(np.asarray(st_ff["g"]),
                               np.asarray(st_bm["g"]), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(float(st_ff["beta"]), float(st_bm["beta"]),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(ravel_pytree(p_ff)[0]),
                               np.asarray(ravel_pytree(p_bm)[0]),
                               rtol=1e-3, atol=1e-5)


def test_ff_fvp_bf16_storage_bounded():
    """bf16-stored obs (the c3-c5 kernel emission) changes the Fisher
    only by storage rounding: the Fv direction stays within cosine
    0.9999 of the fp32 one."""
    obs = jax.random.normal(jax.random.PRNGKey(3), (512, 27))
    params = policy.init_params(jax.random.PRNGKey(4), 27, 7, (64, 64),
                                -0.5)
    theta, unravel = ravel_pytree(params)
    v = jax.random.normal(jax.random.PRNGKey(5), theta.shape)
    a = make_gn_fvp(params, unravel, obs, 0.1)(v)
    b = make_gn_fvp(params, unravel,
                    obs.astype(jnp.bfloat16).astype(jnp.float32), 0.1)(v)
    cos = float(a @ b / (jnp.linalg.norm(a) * jnp.linalg.norm(b)))
    assert cos >= 0.9999, cos


def test_ff_fvp_under_shard_map_equals_unsharded():
    """Per shard, make_gn_fvp on the LOCAL strided subsample plus one
    pmean equals the FVP on the global strided subsample: with local
    N % e == 0 the strided env sets union to the global set."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    n_dev, T, do, N, k, e = 4, 8, 9, 64, 4, 2
    obs_ff = jax.random.normal(jax.random.PRNGKey(6), (T, do, N))
    params = policy.init_params(jax.random.PRNGKey(7), do, 2, (16, 16),
                                -0.5)
    theta, unravel = ravel_pytree(params)
    v = jax.random.normal(jax.random.PRNGKey(8), theta.shape)

    def sub(o):
        return jnp.transpose(o[::k][..., ::e], (0, 2, 1)).reshape(-1, do)

    ref = make_gn_fvp(params, unravel, sub(obs_ff), 0.1)(v)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    sharded = jax.jit(jax.shard_map(
        lambda o, v: make_gn_fvp(params, unravel, sub(o), 0.1,
                                 axis_name="data")(v),
        mesh=mesh, in_specs=(P(None, None, "data"), P()), out_specs=P(),
        check_vma=False))
    np.testing.assert_allclose(np.asarray(sharded(obs_ff, v)),
                               np.asarray(ref), rtol=1e-4, atol=1e-6)


def test_fvp_env_stride_needs_divisible_envs():
    cfg, state, batch = _c1_batch(N=30, T=8, fvp_env_subsample=4)
    with pytest.raises(AssertionError, match="fvp_env_subsample"):
        trpo_update(cfg, state.params, state.w, batch)
