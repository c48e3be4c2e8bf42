"""Fused rollout kernel for fixed-base serial arms, through Pallas-Triton.

One program owns a tile of envs and runs the WHOLE horizon: the joint
state stays in registers across all T steps, and only the per-step
observation, action and reward rows reach device memory. The plain
path (envs/arm.py:rollout) is an XLA while loop of T x n_substeps
iterations, each a chain of kernel launches plus a batched 7x7
Cholesky, with the carry round-tripping through device memory.

Layout: every per-env quantity is a 1-D vector over the env tile, so
the dynamics are elementwise math on vectors of envs. Per step:
  FK -> observation -> policy MLP (pl.dot on zero-padded weights) ->
  action = mu + sigma * eps -> per substep: FK, the mass matrix by the
  composite rigid body algorithm, the bias by one RNEA pass, an
  unrolled Cholesky solve and a semi-implicit Euler step -> reward
  (+ track/push task terms and the obstacle penalty when enabled).

The component math below is shared by the kernel and by its plain
twin `rollout3d_reference` (lax.scan over the same math). Scalars in it
are either traced arrays or Python floats; the helpers fold the float
zeros and ones at trace time, so the constant parts of the fixed joint
transforms cost nothing.

Action noise `eps` (T, N, n) is drawn by jax.random outside the kernel
and read per step, so the kernel is bit-comparable with the twin.
Early termination (cfg.done_dist > 0) would need in-kernel episode
resampling; envs/arm.py:resolve_rollout_impl routes those configs to the
XLA scan.

Correctness: kernel == rollout3d_reference in interpret mode, and
rollout3d_reference == the generic RNEA path (itself checked against
the fp64 oracle and MuJoCo) — tests/test_pallas_rollout3d.py.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...configs.base import ExperimentConfig
from ...envs.rigid_body import ArmConstants


# ------------------------------------------- scalars with folded constants
def _is0(x):
    return isinstance(x, float) and x == 0.0


def _add(a, b):
    if _is0(a):
        return b
    if _is0(b):
        return a
    return a + b


def _sub(a, b):
    if _is0(b):
        return a
    if _is0(a):
        return -b
    return a - b


def _mul(a, b):
    if _is0(a) or _is0(b):
        return 0.0
    for x, y in ((a, b), (b, a)):
        if isinstance(x, float) and x == 1.0:
            return y
        if isinstance(x, float) and x == -1.0:
            return -y
    return a * b


def v_add(a, b):
    return tuple(_add(x, y) for x, y in zip(a, b))


def v_sub(a, b):
    return tuple(_sub(x, y) for x, y in zip(a, b))


def v_scale(s, a):
    return tuple(_mul(s, x) for x in a)


def v_cross(a, b):
    return (_sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
            _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
            _sub(_mul(a[0], b[1]), _mul(a[1], b[0])))


def v_dot(a, b):
    return _add(_add(_mul(a[0], b[0]), _mul(a[1], b[1])), _mul(a[2], b[2]))


def m_vec(R, v):
    """R (row-major 9-tuple) @ v (3-tuple)."""
    return tuple(v_dot(R[3 * r:3 * r + 3], v) for r in range(3))


def m_mul(R, S):
    """R @ S for row-major 9-tuples."""
    return tuple(v_dot(R[3 * r:3 * r + 3], (S[c], S[3 + c], S[6 + c]))
                 for r in range(3) for c in range(3))


def m_rotz(A, cq, sq):
    """A @ Rz(q): columns 0,1 mix by cos/sin; column 2 unchanged."""
    out = []
    for r in range(3):
        a0, a1, a2 = A[3 * r:3 * r + 3]
        out += [_add(_mul(a0, cq), _mul(a1, sq)),
                _sub(_mul(a1, cq), _mul(a0, sq)), a2]
    return tuple(out)


def _flat(m):
    return tuple(float(x) for x in np.asarray(m, np.float64).ravel())


class Arm3DConsts(NamedTuple):
    n: int
    n_tasks: int
    T_rot: tuple      # n x row-major 9-tuples
    T_pos: tuple      # n x 3-tuples
    mass: tuple
    com: tuple        # n x 3-tuples
    inertia: tuple    # n x row-major 9-tuples (link frame)
    ee_offset: tuple
    gravity: float
    damping: float
    dt: float
    n_substeps: int
    torque_limit: float
    qd_limit: float
    qd_obs_scale: float
    ctrl_weight: float
    obstacle_weight: float
    obstacle_radius: float
    obstacle_center: tuple
    track_omega: float
    push_speed: float
    push_weight: float
    chol_reg: float


def arm3d_consts(cfg: ExperimentConfig, chol_reg: float = 1e-6):
    spec = cfg.arm
    c = ArmConstants(spec)
    return Arm3DConsts(
        n=c.n,
        n_tasks=int(cfg.n_tasks),
        T_rot=tuple(_flat(t) for t in c.T_rot),
        T_pos=tuple(_flat(t) for t in c.T_pos),
        mass=tuple(c.mass),
        com=tuple(_flat(x) for x in c.com),
        inertia=tuple(_flat(i) for i in c.inertia),
        ee_offset=_flat(c.ee_offset),
        gravity=float(spec.gravity),
        damping=float(spec.joint_damping), dt=float(spec.dt),
        n_substeps=int(spec.n_substeps),
        torque_limit=float(spec.torque_limit),
        qd_limit=float(spec.qd_limit),
        qd_obs_scale=float(spec.qd_obs_scale),
        ctrl_weight=float(cfg.cost.ctrl_weight),
        obstacle_weight=float(cfg.cost.obstacle_weight),
        obstacle_radius=float(cfg.cost.obstacle_radius),
        obstacle_center=tuple(float(x) for x in cfg.cost.obstacle_center),
        track_omega=float(cfg.cost.track_omega),
        push_speed=float(cfg.cost.push_speed),
        push_weight=float(cfg.cost.push_weight),
        chol_reg=chol_reg,
    )


# ------------------------------------------------------------ dynamics
def _fk3(c: Arm3DConsts, cq, sq):
    """FK from per-joint cos/sin lists. Returns (R[i] 9-tuples,
    p[i] joint origins, axis[i] joint axes, ee), all in the world frame."""
    R_par = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    p_par = (0.0, 0.0, 0.0)
    R, p, axis = [], [], []
    for i in range(c.n):
        A = m_mul(R_par, c.T_rot[i])
        p_i = v_add(p_par, m_vec(R_par, c.T_pos[i]))
        R_i = m_rotz(A, cq[i], sq[i])
        axis.append((A[2], A[5], A[8]))       # z column of R_par @ T_rot
        R.append(R_i)
        p.append(p_i)
        R_par, p_par = R_i, p_i
    ee = v_add(p[-1], m_vec(R[-1], c.ee_offset))
    return R, p, axis, ee


def _bias(c: Arm3DConsts, R, p, axis, qd):
    """Bias torques C(q, qd) qd + g(q): the world-frame RNEA of
    envs/rigid_body.py:rnea with qdd = 0."""
    n = c.n
    zero3 = (0.0, 0.0, 0.0)
    w_par, wd_par, a_par, p_par = zero3, zero3, (0.0, 0.0, c.gravity), zero3
    ws, wds, acs, cws = [], [], [], []
    for i in range(n):
        r = v_sub(p[i], p_par)
        a_i = v_add(a_par, v_add(v_cross(wd_par, r),
                                 v_cross(w_par, v_cross(w_par, r))))
        s = axis[i]
        w_i = v_add(w_par, v_scale(qd[i], s))
        wd_i = v_add(wd_par, v_cross(w_par, v_scale(qd[i], s)))
        d = m_vec(R[i], c.com[i])
        ac_i = v_add(a_i, v_add(v_cross(wd_i, d),
                                v_cross(w_i, v_cross(w_i, d))))
        ws.append(w_i)
        wds.append(wd_i)
        acs.append(ac_i)
        cws.append(v_add(p[i], d))
        w_par, wd_par, a_par, p_par = w_i, wd_i, a_i, p[i]

    taus = [None] * n
    f_child, n_child, p_child = zero3, zero3, zero3
    for i in range(n - 1, -1, -1):
        Ri = R[i]
        Rt = (Ri[0], Ri[3], Ri[6], Ri[1], Ri[4], Ri[7], Ri[2], Ri[5], Ri[8])

        def I_w_vec(v, Ri=Ri, Rt=Rt, Ic=c.inertia[i]):
            return m_vec(Ri, m_vec(Ic, m_vec(Rt, v)))

        F = v_scale(c.mass[i], acs[i])
        N = v_add(I_w_vec(wds[i]), v_cross(ws[i], I_w_vec(ws[i])))
        f = v_add(F, f_child)
        nn = v_add(v_add(N, n_child),
                   v_add(v_cross(v_sub(cws[i], p[i]), F),
                         v_cross(v_sub(p_child, p[i]), f_child)))
        taus[i] = v_dot(axis[i], nn)
        f_child, n_child, p_child = f, nn, p[i]
    return taus


def _sym_vec(I, v):
    """Symmetric 3x3 (xx, xy, xz, yy, yz, zz) @ v."""
    xx, xy, xz, yy, yz, zz = I
    return (_add(_add(_mul(xx, v[0]), _mul(xy, v[1])), _mul(xz, v[2])),
            _add(_add(_mul(xy, v[0]), _mul(yy, v[1])), _mul(yz, v[2])),
            _add(_add(_mul(xz, v[0]), _mul(yz, v[1])), _mul(zz, v[2])))


def _mass_matrix(c: Arm3DConsts, R, p, axis):
    """Joint-space mass matrix M (dict (i, j), i <= j) by the composite
    rigid body algorithm in world coordinates: M_ij = xi_i . (I_j xi_j),
    with xi_j = (s_j, p_j x s_j) joint j's unit twist and I_j the
    spatial inertia of links j..n-1 about the world origin (mass m,
    first moment h, rotational inertia J). Equal to the n unit-
    acceleration RNEA columns of envs/rigid_body.py:mass_matrix."""
    n = c.n
    v0 = [v_cross(p[j], axis[j]) for j in range(n)]
    m, h = 0.0, (0.0, 0.0, 0.0)
    J = (0.0,) * 6
    M = {}
    for j in range(n - 1, -1, -1):
        mj = c.mass[j]
        cj = v_add(p[j], m_vec(R[j], c.com[j]))        # world COM
        A, Rj = m_mul(R[j], c.inertia[j]), R[j]         # R Ic R^T rows
        Iw = [v_dot(A[3 * a:3 * a + 3], Rj[3 * b:3 * b + 3])
              for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
        x, y, z = cj
        xx, yy, zz = _mul(x, x), _mul(y, y), _mul(z, z)
        par = (_add(yy, zz), -_mul(x, y), -_mul(x, z), _add(xx, zz),
               -_mul(y, z), _add(xx, yy))              # |c|^2 I - c c^T
        J = tuple(_add(Jk, _add(Ik, _mul(mj, pk)))
                  for Jk, Ik, pk in zip(J, Iw, par))
        m = m + mj
        h = v_add(h, v_scale(mj, cj))
        s = axis[j]
        f = v_add(v_scale(m, v0[j]), v_cross(s, h))      # linear part
        nO = v_add(_sym_vec(J, s), v_cross(h, v0[j]))   # moment about 0
        for i in range(j + 1):
            M[(i, j)] = _add(v_dot(axis[i], nO), v_dot(v0[i], f))
    return M


def _chol_solve3(c: Arm3DConsts, M, rhs):
    """(M + chol_reg I) x = rhs by an unrolled Cholesky: one rsqrt per
    pivot and reciprocal multiplies."""
    n = c.n
    L = {}
    inv_d = [None] * n
    for j in range(n):
        s = _add(M[(j, j)], c.chol_reg)
        for k in range(j):
            s = _sub(s, _mul(L[(j, k)], L[(j, k)]))
        inv = jax.lax.rsqrt(s)
        inv_d[j] = inv
        L[(j, j)] = s * inv                    # = sqrt(s)
        for i in range(j + 1, n):
            t = M[(j, i)]
            for k in range(j):
                t = _sub(t, _mul(L[(i, k)], L[(j, k)]))
            L[(i, j)] = _mul(t, inv)
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = _sub(s, _mul(L[(i, k)], y[k]))
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = _sub(s, _mul(L[(k, i)], x[k]))
        x[i] = s * inv_d[i]
    return x


def _score_step(c: Arm3DConsts, qd, tgt, tau, cq2, sq2, task_oh):
    """Track-target rotation, post-step FK, reach cost, push and obstacle
    terms (mirrors envs/arm.py:step). Returns (tgt2, rew)."""
    n = c.n
    if task_oh is not None:
        co = float(np.cos(c.track_omega * c.dt))
        so = float(np.sin(c.track_omega * c.dt))
        track = task_oh[1] > 0.5
        tgt = (jnp.where(track, co * tgt[0] - so * tgt[1], tgt[0]),
               jnp.where(track, so * tgt[0] + co * tgt[1], tgt[1]),
               tgt[2])

    R2, p2, axis2, ee2 = _fk3(c, cq2, sq2)
    d = v_sub(ee2, tgt)
    ctrl = tau[0] * tau[0]
    for i in range(1, n):
        ctrl = ctrl + tau[i] * tau[i]
    rew = -(v_dot(d, d) + c.ctrl_weight * ctrl)

    if task_oh is not None and c.n_tasks > 2:
        # push task (family 2): EE velocity should match
        # push_speed * dir(to target); v_ee = sum qd_i axis_i x (ee - p_i)
        v_ee = (0.0, 0.0, 0.0)
        for i in range(n):
            v_ee = v_add(v_ee, v_scale(
                qd[i], v_cross(axis2[i], v_sub(ee2, p2[i]))))
        dn = jnp.sqrt(v_dot(d, d)) + 1e-6
        verr = tuple(_add(v, c.push_speed * dk / dn)
                     for v, dk in zip(v_ee, d))
        rew = rew - jnp.where(task_oh[2] > 0.5,
                              c.push_weight * v_dot(verr, verr), 0.0)

    if c.obstacle_weight > 0.0:
        pen = None
        for pt in p2[1:] + [ee2]:
            dx, dy, dz = v_sub(pt, c.obstacle_center)
            dist = jnp.sqrt(_add(_add(_mul(dx, dx), _mul(dy, dy)),
                                 _mul(dz, dz)))
            term = jnp.maximum(c.obstacle_radius - dist, 0.0) ** 2
            pen = term if pen is None else pen + term
        rew = rew - c.obstacle_weight * pen
    return tgt, rew


def _step3(c: Arm3DConsts, mlp, sigma, q, qd, tgt, eps, task_oh=None):
    """One env step on per-env vectors. q, qd, eps, sigma: lists of n;
    tgt: 3-tuple; task_oh: n_tasks one-hot rows or None; mlp maps the
    list of obs rows to the list of n mean rows. Returns (q2, qd2, tgt2,
    obs rows, act rows, rew).

    Mirrors envs/arm.py:step: clip -> dynamics -> (track target
    rotation) -> score at the post-step state."""
    n = c.n
    cq = [jnp.cos(x) for x in q]
    sq = [jnp.sin(x) for x in q]
    R, p, axis, ee = _fk3(c, cq, sq)

    obs = (cq + sq + [c.qd_obs_scale * x for x in qd]
           + [_sub(tgt[k], ee[k]) for k in range(3)])
    if task_oh is not None:
        obs = obs + list(task_oh)
    mu = mlp(obs)
    act = [mu[i] + sigma[i] * eps[i] for i in range(n)]
    tau = [jnp.clip(a, -c.torque_limit, c.torque_limit) for a in act]

    h = c.dt / c.n_substeps

    def substep(q, qd):
        R, p, axis, _ = _fk3(c, [jnp.cos(x) for x in q],
                             [jnp.sin(x) for x in q])
        M = _mass_matrix(c, R, p, axis)
        bias = _bias(c, R, p, axis, qd)
        rhs = [_sub(tau[i], _add(bias[i], c.damping * qd[i]))
               for i in range(n)]
        qdd = _chol_solve3(c, M, rhs)
        qd = [jnp.clip(qd[i] + h * qdd[i], -c.qd_limit, c.qd_limit)
              for i in range(n)]
        return [q[i] + h * qd[i] for i in range(n)], qd

    # a loop rather than an unrolled sequence: it keeps the kernel body,
    # and with it the Triton compile time, to one substep's code
    q, qd = jax.lax.fori_loop(0, c.n_substeps,
                              lambda _, st: substep(*st), (q, qd))

    cq2 = [jnp.cos(x) for x in q]
    sq2 = [jnp.sin(x) for x in q]
    tgt, rew = _score_step(c, qd, tgt, tau, cq2, sq2, task_oh)
    return q, qd, tgt, obs, act, rew


# ----------------------------------------------------------------- MLP
def _pow2(x: int, floor: int = 16) -> int:
    """Smallest power of two >= max(x, floor) (pl.dot's shape rule)."""
    return max(floor, 1 << (int(x) - 1).bit_length())


def _padded_mlp(params):
    """Policy weights zero-padded to power-of-two widths >= 16. Padded
    hidden units see zero weights and bias, so tanh(0) = 0 feeds zero
    rows of the next layer: the padded MLP is exact."""
    L = sum(1 for k in params if k.startswith("W"))
    Ws, bs = [], []
    for i in range(L):
        W, b = params[f"W{i}"], params[f"b{i}"]
        din, dout = W.shape
        Ws.append(jnp.pad(W, ((0, _pow2(din) - din),
                              (0, _pow2(dout) - dout))))
        bs.append(jnp.pad(b, (0, _pow2(dout) - dout)))
    return Ws, bs


def _mlp_rows(Ws, bs, rows, n_out, precision):
    """In-kernel policy mean: scatter the obs rows into a (bb, do_pad)
    tile by one-hot selects, run the padded tanh MLP with pl.dot, and
    read the n_out mean rows back by masked row sums (Triton cannot
    concatenate vectors or slice columns out of a register tile)."""
    bb = rows[0].shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (bb, Ws[0].shape[0]), 1)
    x = jnp.zeros((bb, Ws[0].shape[0]), jnp.float32)
    for i, r in enumerate(rows):
        x = jnp.where(col == i, r[:, None], x)
    for W, b in zip(Ws[:-1], bs[:-1]):
        x = jnp.tanh(pl.dot(x, W, precision=precision) + b[None, :])
    y = pl.dot(x, Ws[-1], precision=precision) + bs[-1][None, :]
    col = jax.lax.broadcasted_iota(jnp.int32, y.shape, 1)
    return [jnp.sum(jnp.where(col == i, y, 0.0), axis=1)
            for i in range(n_out)]


def _policy_ff(Ws, bs, obs):
    """Feature-first tanh MLP: obs (do, B) -> mu (da, B); Ws[i] (d_in,
    d_out) as stored in the param dict, bs[i] (d_out, 1)."""
    h = obs
    for i in range(len(Ws) - 1):
        h = jnp.tanh(jax.lax.dot_general(Ws[i], h, (((0,), (0,)), ((), ())),
                                         preferred_element_type=jnp.float32)
                     + bs[i])
    return jax.lax.dot_general(Ws[-1], h, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32) + bs[-1]


# -------------------------------------------------------------- kernel
def rollout_tile(n_envs: int):
    """(envs per program, warps per program). One env per thread in a
    one-warp program: the step is long dependent elementwise math, so
    the work parallelises over envs, and small programs let many
    co-reside on an SM while filling all of them from a few thousand
    envs up. Below 32 envs the tile is the smallest power of two
    >= 16 (pl.dot's minimum row count) that covers them."""
    return min(32, _pow2(n_envs)), 1


def _rollout_kernel(c: Arm3DConsts, T, bb, n_layers, precision, *refs):
    """refs: q0 (n, Np), qd0 (n, Np), tgt (3, Np), [task one-hot
    (n_tasks, Np)], padded W0..W_{L-1}, b0..b_{L-1}, logstd (n,),
    eps (T, n, Np) -> obs (T, do, Np), act (T, n, Np), rew (T, Np)."""
    it = iter(refs)
    q0_ref, qd0_ref, tgt_ref = next(it), next(it), next(it)
    task_ref = next(it) if c.n_tasks > 1 else None
    W_refs = [next(it) for _ in range(n_layers)]
    b_refs = [next(it) for _ in range(n_layers)]
    logstd_ref, eps_ref = next(it), next(it)
    obs_ref, act_ref, rew_ref = next(it), next(it), next(it)

    n = c.n
    env = pl.ds(pl.program_id(0) * bb, bb)
    Ws = [w[...] for w in W_refs]
    bs = [b[...] for b in b_refs]
    sigma = [jnp.exp(logstd_ref[i]) for i in range(n)]
    q = [q0_ref[i, env] for i in range(n)]
    qd = [qd0_ref[i, env] for i in range(n)]
    tgt = tuple(tgt_ref[k, env] for k in range(3))
    task_oh = None if task_ref is None else tuple(
        task_ref[k, env] for k in range(c.n_tasks))

    def mlp(rows):
        return _mlp_rows(Ws, bs, rows, n, precision)

    def body(t, carry):
        q, qd, tgt = carry
        eps = [eps_ref[t, i, env] for i in range(n)]
        q, qd, tgt, obs, act, rew = _step3(c, mlp, sigma, q, qd, tgt, eps,
                                           task_oh)
        for i, o in enumerate(obs):
            obs_ref[t, i, env] = o.astype(obs_ref.dtype)
        for i, a in enumerate(act):
            act_ref[t, i, env] = a.astype(act_ref.dtype)
        rew_ref[t, env] = rew
        return q, qd, tgt

    jax.lax.fori_loop(0, T, body, (q, qd, tgt))


def pallas_rollout3d(cfg: ExperimentConfig, params, key, n_envs=None,
                     eps=None, interpret: bool = False, q0=None, qd0=None,
                     tgt=None, task=None, store_dtype=None, precision=None):
    """Fused rollout; same contract as envs/arm.py:rollout for
    non-terminating configs, plus the kernel-native feature-first views
    obs_ff (T, do, N), actions_ff (T, n, N) and rewards_ff (T, N).

    eps (T, N, n): action noise (drawn from `key` when None). The env
    count is padded up to the tile with zero states, and the padded
    envs are dropped from the outputs. store_dtype=bf16 emits
    obs_ff/actions_ff in bf16 (rewards stay fp32). precision: pl.dot
    precision of the in-kernel MLP (None: the backend default, TF32 on
    the GPU; HIGHEST: full fp32)."""
    from ...envs import arm as arm_mod

    assert cfg.done_dist == 0.0, \
        "the fused rollout has no in-kernel episode resampling"
    c = arm3d_consts(cfg)
    n, T, do = c.n, cfg.horizon, cfg.obs_dim
    N = cfg.n_envs if n_envs is None else n_envs
    k_reset, k_eps = jax.random.split(key)
    if q0 is None:
        state0 = arm_mod.reset(cfg, k_reset, N)
        q0, qd0, tgt, task = state0.q, state0.qd, state0.tgt, state0.task
    elif task is None:
        task = jnp.zeros(N, jnp.int32)
    if eps is None:
        eps_ff = jax.random.normal(k_eps, (T, n, N))
    else:
        eps_ff = jnp.swapaxes(eps, 1, 2)               # (T, n, N)

    bb, num_warps = rollout_tile(N)
    Np = -(-N // bb) * bb

    def pad(x):                                        # envs on last axis
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, Np - N)])

    inputs = [pad(q0.T), pad(qd0.T), pad(tgt.T)]
    if cfg.n_tasks > 1:
        inputs.append(pad(jax.nn.one_hot(task, cfg.n_tasks,
                                         dtype=jnp.float32).T))
    Ws, bs = _padded_mlp(params)
    inputs += Ws + bs + [params["logstd"], pad(eps_ff)]

    st_dt = store_dtype or jnp.float32
    out_shape = [jax.ShapeDtypeStruct((T, do, Np), st_dt),
                 jax.ShapeDtypeStruct((T, n, Np), st_dt),
                 jax.ShapeDtypeStruct((T, Np), jnp.float32)]
    kernel = functools.partial(_rollout_kernel, c, T, bb, len(Ws),
                               precision)
    obs_ff, act_ff, rew_ff = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(Np // bb,), backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret, name="fused_rollout")(*inputs)
    obs_ff, act_ff, rew_ff = (obs_ff[..., :N], act_ff[..., :N],
                              rew_ff[:, :N])

    f32 = jnp.float32
    return dict(obs=jnp.transpose(obs_ff, (2, 0, 1)).astype(f32),
                actions=jnp.transpose(act_ff, (2, 0, 1)).astype(f32),
                rewards=rew_ff.T,
                obs_ff=obs_ff, actions_ff=act_ff, rewards_ff=rew_ff)


def rollout3d_reference(cfg: ExperimentConfig, params, q0, qd0, tgt, eps,
                        task=None):
    """Plain twin of the kernel: lax.scan over the same component math
    on (N,) vectors, with the MLP as XLA dots. eps: (T, N, n)."""
    c = arm3d_consts(cfg)
    n = c.n
    L = sum(1 for k in params if k.startswith("W"))
    Ws = [params[f"W{i}"] for i in range(L)]
    bs = [params[f"b{i}"][:, None] for i in range(L)]
    sigma = list(jnp.exp(params["logstd"]))
    task_oh = None
    if cfg.n_tasks > 1:
        oh = jax.nn.one_hot(task, cfg.n_tasks, dtype=jnp.float32).T
        task_oh = tuple(oh)

    def mlp(rows):
        return list(_policy_ff(Ws, bs, jnp.stack(rows)))

    def body(carry, eps_t):
        q, qd, tgt_c = carry
        q2, qd2, tgt2, obs, act, rew = _step3(c, mlp, sigma, q, qd, tgt_c,
                                              list(eps_t.T), task_oh)
        return (q2, qd2, tgt2), (jnp.stack(obs), jnp.stack(act), rew)

    carry0 = (list(q0.T), list(qd0.T), tuple(tgt.T))
    _, (obs, act, rew) = jax.lax.scan(body, carry0, eps)
    return dict(obs=jnp.transpose(obs, (2, 0, 1)),
                actions=jnp.transpose(act, (2, 0, 1)),
                rewards=rew.T)
