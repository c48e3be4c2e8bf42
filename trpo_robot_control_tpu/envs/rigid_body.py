"""Pure-JAX rigid-body dynamics for fixed-base serial arms.

World-frame recursive Newton-Euler (same recursion as oracle/dynamics.py,
the fp64 fixture), written for XLA:

- link count is STATIC (from the frozen ArmSpec) so the per-link loops are
  plain Python and unroll at trace time — no dynamic control flow;
- everything is expressed on batched arrays and is `vmap`-able over
  thousands of envs (SURVEY.md section 2: "pure-JAX batched arm rollouts");
- forward dynamics solves M qdd = tau - bias with a batched Cholesky
  (+ lambda*I regularisation for fp32 robustness near singular configs,
  SURVEY.md section 9 hard-part 4).

Fixed per-arm constants (rotations, offsets, inertias) are precomputed in
NumPy at trace time and closed over as literals.
"""
from __future__ import annotations

import math
from functools import partial, wraps

import jax
import jax.numpy as jnp
import numpy as np

from ..configs.base import ArmSpec


def _full_precision(fn):
    """All dynamics contractions are tiny (3x3); force full fp32 precision
    so results match the fp64 oracle (TF32 or bf16 matmul passes would
    not)."""
    @wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapper


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


class ArmConstants:
    """Static (trace-time) constants derived from an ArmSpec."""

    _cache: dict = {}

    def __new__(cls, spec: ArmSpec):
        if spec not in cls._cache:
            obj = super().__new__(cls)
            obj._init(spec)
            cls._cache[spec] = obj
        return cls._cache[spec]

    def _init(self, spec: ArmSpec):
        self.spec = spec
        self.n = spec.n_joints
        self.T_rot = [_rpy_matrix(j.rpy) for j in spec.joints]
        self.T_pos = [np.asarray(j.pos, np.float32) for j in spec.joints]
        self.mass = [float(l.mass) for l in spec.links]
        self.com = [np.asarray(l.com, np.float32) for l in spec.links]
        self.inertia = [np.diag(l.inertia_diag).astype(np.float32)
                        for l in spec.links]
        self.ee_offset = np.asarray(spec.ee_offset, np.float32)
        self.planar = all(np.allclose(j.rpy, 0.0) for j in spec.joints)


def _rot_z(q):
    """Batched (...,) -> (..., 3, 3) rotation about z."""
    c, s = jnp.cos(q), jnp.sin(q)
    z = jnp.zeros_like(q)
    o = jnp.ones_like(q)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


@_full_precision
def fk(spec: ArmSpec, q):
    """Forward kinematics. q (..., n) -> (R list, p list, ee (..., 3)).

    R[i]: (..., 3, 3) world rotation of link i; p[i]: (..., 3) joint origin.
    """
    c = ArmConstants(spec)
    batch = q.shape[:-1]
    R_par = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), batch + (3, 3))
    p_par = jnp.zeros(batch + (3,), q.dtype)
    R, p = [], []
    for i in range(c.n):
        p_i = p_par + jnp.einsum("...ij,j->...i", R_par, c.T_pos[i])
        R_fix = R_par @ c.T_rot[i]
        R_i = R_fix @ _rot_z(q[..., i])
        R.append(R_i)
        p.append(p_i)
        R_par, p_par = R_i, p_i
    ee = p[-1] + jnp.einsum("...ij,j->...i", R[-1], c.ee_offset)
    return R, p, ee


def ee_pos(spec: ArmSpec, q):
    return fk(spec, q)[2]


@_full_precision
def rnea(spec: ArmSpec, q, qd, qdd, gravity=None, fk_cache=None):
    """Inverse dynamics tau = ID(q, qd, qdd); batched over leading dims.
    Mirrors oracle/dynamics.py:ArmModel.rnea exactly (the parity fixture).
    `fk_cache=(R, p)` lets callers share one FK across several RNEA calls
    (mass_matrix + bias per dynamics step)."""
    c = ArmConstants(spec)
    g = spec.gravity if gravity is None else gravity
    if fk_cache is None:
        R, p, _ = fk(spec, q)
    else:
        R, p = fk_cache
    batch = q.shape[:-1]
    dtype = q.dtype

    z_hat = jnp.asarray([0.0, 0.0, 1.0], dtype)
    w_par = jnp.zeros(batch + (3,), dtype)
    wd_par = jnp.zeros(batch + (3,), dtype)
    a_par = jnp.broadcast_to(jnp.asarray([0.0, 0.0, g], dtype), batch + (3,))
    R_par = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))

    axis, w, wd, ac, cw, pj = [], [], [], [], [], []
    for i in range(c.n):
        R_fix = R_par @ c.T_rot[i]
        s = jnp.einsum("...ij,j->...i", R_fix, z_hat)
        r = jnp.einsum("...ij,j->...i", R_par, c.T_pos[i])
        a_i = (a_par + jnp.cross(wd_par, r)
               + jnp.cross(w_par, jnp.cross(w_par, r)))
        w_i = w_par + s * qd[..., i:i + 1]
        wd_i = (wd_par + s * qdd[..., i:i + 1]
                + jnp.cross(w_par, s * qd[..., i:i + 1]))
        d = jnp.einsum("...ij,j->...i", R[i], c.com[i])
        ac_i = a_i + jnp.cross(wd_i, d) + jnp.cross(w_i, jnp.cross(w_i, d))
        axis.append(s); w.append(w_i); wd.append(wd_i)
        ac.append(ac_i); cw.append(p[i] + d); pj.append(p[i])
        w_par, wd_par, a_par, R_par = w_i, wd_i, a_i, R[i]

    taus = [None] * c.n
    f_child = jnp.zeros(batch + (3,), dtype)
    n_child = jnp.zeros(batch + (3,), dtype)
    p_child = jnp.zeros(batch + (3,), dtype)
    for i in range(c.n - 1, -1, -1):
        I_w = R[i] @ jnp.asarray(c.inertia[i]) @ jnp.swapaxes(R[i], -1, -2)
        F = c.mass[i] * ac[i]
        N = (jnp.einsum("...ij,...j->...i", I_w, wd[i])
             + jnp.cross(w[i], jnp.einsum("...ij,...j->...i", I_w, w[i])))
        f = F + f_child
        nn = (N + n_child + jnp.cross(cw[i] - pj[i], F)
              + jnp.cross(p_child - pj[i], f_child))
        taus[i] = jnp.sum(axis[i] * nn, axis=-1)
        f_child, n_child, p_child = f, nn, pj[i]
    return jnp.stack(taus, axis=-1)


@_full_precision
def mass_matrix(spec: ArmSpec, q, fk_cache=None):
    """M(q) by CRBA-via-RNEA: column j = ID(q, 0, e_j, g=0). Batched."""
    n = ArmConstants(spec).n
    zero = jnp.zeros_like(q)
    eye = jnp.eye(n, dtype=q.dtype)
    if fk_cache is None:
        R, p, _ = fk(spec, q)
        fk_cache = (R, p)

    def col(e):
        e_b = jnp.broadcast_to(e, q.shape)
        return rnea(spec, q, zero, e_b, gravity=0.0, fk_cache=fk_cache)

    M = jnp.stack([col(eye[j]) for j in range(n)], axis=-1)
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


@_full_precision
def bias(spec: ArmSpec, q, qd, fk_cache=None):
    """C(q, qd) qd + g(q) (no joint damping)."""
    return rnea(spec, q, qd, jnp.zeros_like(q), fk_cache=fk_cache)


@_full_precision
def forward_dynamics(spec: ArmSpec, q, qd, tau, chol_reg: float = 1e-6):
    """qdd = M^{-1}(tau - bias - damping qd), batched Cholesky solve.
    FK is computed once and shared across the n+1 RNEA passes."""
    n = ArmConstants(spec).n
    R, p, _ = fk(spec, q)
    M = mass_matrix(spec, q, fk_cache=(R, p)) \
        + chol_reg * jnp.eye(n, dtype=q.dtype)
    b = bias(spec, q, qd, fk_cache=(R, p)) + spec.joint_damping * qd
    L = jnp.linalg.cholesky(M)
    return jax.scipy.linalg.cho_solve((L, True), (tau - b)[..., None])[..., 0]


@partial(jax.jit, static_argnums=0)
@_full_precision
def dynamics_step(spec: ArmSpec, q, qd, tau):
    """Semi-implicit Euler, n_substeps, velocity clip — mirrors
    oracle/dynamics.py:ArmModel.step."""
    h = spec.dt / spec.n_substeps
    for _ in range(spec.n_substeps):
        qdd = forward_dynamics(spec, q, qd, tau)
        qd = jnp.clip(qd + h * qdd, -spec.qd_limit, spec.qd_limit)
        q = q + h * qd
    return q, qd
