"""M0: fp64 NumPy TRPO oracle — the parity fixture (SURVEY.md sections 4, 9).

Dead-simple, loop-based, zero JAX. Implements, per iteration:
  rollout -> GAE (old baseline) -> whiten -> refit baseline ->
  policy gradient g -> CG(10) on damped Gauss-Newton FVP -> step size
  beta = sqrt(2 delta / x^T H x) -> backtracking KL line search.

The JAX engine must match this oracle's step direction (cosine >=
0.999), step size (rel err <= 1e-3) and accepted line-search exponent on
the same data (tests/test_parity.py).
"""
from __future__ import annotations

import numpy as np

from trpo_robot_control_tpu.configs.base import ArmSpec, ExperimentConfig

from . import net
from .dynamics import ArmModel


def is_planar(spec: ArmSpec) -> bool:
    return all(all(abs(v) < 1e-12 for v in j.rpy) for j in spec.joints)


# ----------------------------------------------------------------- env
class OracleEnv:
    """Batched (loop-based) arm environment: reach cost, plus the c4/c5
    variants (smooth obstacle penalty; track / push goal families with
    task one-hot observations) mirroring envs/arm.py:step exactly in
    fp64. Existing single-task zero-obstacle configs consume the SAME
    RNG stream and arithmetic as before (golden-pinned)."""

    def __init__(self, cfg: ExperimentConfig):
        self.cfg = cfg
        self.model = ArmModel(cfg.arm)
        self.planar = is_planar(cfg.arm)
        self.n = cfg.arm.n_joints
        self.task = None                    # (n_envs,) when n_tasks > 1

    def reset(self, rng: np.random.RandomState, n_envs: int):
        spec = self.cfg.arm
        q = spec.q0_noise * rng.uniform(-1.0, 1.0, (n_envs, self.n))
        qd = spec.qd0_noise * rng.uniform(-1.0, 1.0, (n_envs, self.n))
        reach = spec.reach
        r = rng.uniform(spec.target_rmin_frac, spec.target_rmax_frac,
                        n_envs) * reach
        if self.planar:
            th = rng.uniform(0.0, 2.0 * np.pi, n_envs)
            tgt = np.stack([r * np.cos(th), r * np.sin(th),
                            np.zeros(n_envs)], axis=-1)
        else:
            u = rng.standard_normal((n_envs, 3))
            u /= np.linalg.norm(u, axis=-1, keepdims=True) + 1e-12
            u[:, 2] = np.abs(u[:, 2])
            tgt = r[:, None] * u
        if self.cfg.n_tasks > 1:
            self.task = rng.randint(0, self.cfg.n_tasks, n_envs)
        return q, qd, tgt

    def obs(self, q, qd, tgt):
        spec = self.cfg.arm
        ee = np.stack([self.model.ee_pos(q[i]) for i in range(q.shape[0])])
        parts = [np.cos(q), np.sin(q), spec.qd_obs_scale * qd, tgt - ee]
        if self.cfg.n_tasks > 1:
            oh = np.zeros((q.shape[0], self.cfg.n_tasks))
            oh[np.arange(q.shape[0]), self.task] = 1.0
            parts.append(oh)
        return np.concatenate(parts, axis=-1)

    def _ee_velocity(self, q, qd):
        """v_ee = sum_i qd_i axis_i x (p_ee - p_i); axis_i = R_i z_hat."""
        R, p, ee = self.model.fk(q)
        z = np.array([0.0, 0.0, 1.0])
        v = np.zeros(3)
        for i in range(self.n):
            v = v + qd[i] * np.cross(R[i] @ z, ee - p[i])
        return v, R, p, ee

    def step(self, q, qd, tgt, actions):
        """Applies clipped torques; reward evaluated at the POST-step
        state (mirrors envs/arm.py:step): reach cost, track target
        rotation before scoring (family 1), push velocity penalty
        (family 2), smooth obstacle penalty when enabled. Returns
        (q2, qd2, tgt2, reward) — tgt2 differs from tgt only for the
        track family."""
        spec, cost = self.cfg.arm, self.cfg.cost
        n_envs = q.shape[0]
        tau = np.clip(actions, -spec.torque_limit, spec.torque_limit)
        q2 = np.empty_like(q)
        qd2 = np.empty_like(qd)
        for i in range(n_envs):
            q2[i], qd2[i] = self.model.step(q[i], qd[i], tau[i])

        tgt2 = tgt
        if self.cfg.n_tasks > 1:
            c, s = np.cos(cost.track_omega * spec.dt),                 np.sin(cost.track_omega * spec.dt)
            rot = np.stack([c * tgt[:, 0] - s * tgt[:, 1],
                            s * tgt[:, 0] + c * tgt[:, 1],
                            tgt[:, 2]], axis=-1)
            tgt2 = np.where((self.task == 1)[:, None], rot, tgt)

        reward = np.empty(n_envs)
        for i in range(n_envs):
            if self.cfg.n_tasks > 1 or cost.obstacle_weight > 0.0:
                v_ee, R, p, ee = self._ee_velocity(q2[i], qd2[i])
            else:
                ee = self.model.ee_pos(q2[i])
            delta = ee - tgt2[i]
            r = -(np.sum(delta ** 2)
                  + cost.ctrl_weight * np.sum(tau[i] ** 2))
            if self.cfg.n_tasks > 1 and self.task[i] == 2:
                dirn = -delta / (np.linalg.norm(delta) + 1e-6)
                v_err = v_ee - cost.push_speed * dirn
                r -= cost.push_weight * np.sum(v_err ** 2)
            if cost.obstacle_weight > 0.0:
                center = np.asarray(cost.obstacle_center)
                pen = 0.0
                for pt in list(p[1:]) + [ee]:
                    d = np.linalg.norm(pt - center)
                    pen += max(cost.obstacle_radius - d, 0.0) ** 2
                r -= cost.obstacle_weight * pen
            reward[i] = r
        return q2, qd2, tgt2, reward


# ------------------------------------------------------------ baseline
def baseline_features(obs, T):
    """phi(s, t) = [obs, obs^2, t/T, (t/T)^2, (t/T)^3, 1]; obs (N,T,do)."""
    N, T_, do = obs.shape
    t = (np.arange(T_, dtype=np.float64) / T)[None, :, None] * np.ones((N, 1, 1))
    return np.concatenate(
        [obs, obs ** 2, t, t ** 2, t ** 3, np.ones_like(t)], axis=-1)


def fit_baseline(phi_flat, targets_flat, reg):
    A = phi_flat.T @ phi_flat + reg * np.eye(phi_flat.shape[1])
    b = phi_flat.T @ targets_flat
    return np.linalg.solve(A, b)


# ----------------------------------------------------------------- gae
def gae(rewards, values, gamma, lam, dones=None):
    """rewards/values (N,T); episodes end where dones == 1 (post-step
    flag; always at t = T-1 — no bootstrap). dones=None means fixed
    horizon. Returns raw advantages (N,T)."""
    N, T = rewards.shape
    adv = np.zeros((N, T))
    next_v = np.zeros(N)
    next_a = np.zeros(N)
    for t in range(T - 1, -1, -1):
        if dones is None:
            nonterm = 0.0 if t == T - 1 else 1.0
        else:
            nonterm = 1.0 - dones[:, t]
        delta = rewards[:, t] + gamma * next_v * nonterm - values[:, t]
        next_a = delta + gamma * lam * nonterm * next_a
        adv[:, t] = next_a
        next_v = values[:, t]
    return adv


# -------------------------------------------------------------- update
def surrogate_grad(params, cache, mu, actions, adv):
    """g = grad of L = mean(ratio * adv) at theta_old (ratio == 1)."""
    B = actions.shape[0]
    sigma = np.exp(params["logstd"])
    z = (actions - mu) / sigma
    dmu = (adv[:, None] * z / sigma) / B
    dlogstd = np.sum(adv[:, None] * (z ** 2 - 1.0), axis=0) / B
    return net.flatten(net.vjp(params, cache, dmu, dlogstd))


def make_fvp(params, cache, mu, damping):
    """Damped Gauss-Newton Fisher-vector product on the rollout batch.

    Fv = (1/B) sum_b J_b^T M J_b v + damping * v, with outputs (mu, logstd),
    M = diag(1/sigma^2, 2 I) — the diagonal-Gaussian Fisher.
    """
    B = mu.shape[0]
    inv_var = np.exp(-2.0 * params["logstd"])

    def fvp(v):
        tangents = net.unflatten_like(params, v)
        dmu, dlogstd = net.jvp(params, cache, tangents)
        u_mu = dmu * inv_var / B
        u_logstd = 2.0 * dlogstd          # batch-summed /B cancels (shared param)
        Fv = net.flatten(net.vjp(params, cache, u_mu, u_logstd))
        return Fv + damping * v

    return fvp


def conjugate_gradient(fvp, g, iters):
    x = np.zeros_like(g)
    r = g.copy()
    p = g.copy()
    rdotr = r @ r
    for _ in range(iters):
        z = fvp(p)
        alpha = rdotr / (p @ z)
        x += alpha * p
        r -= alpha * z
        new_rdotr = r @ r
        p = r + (new_rdotr / rdotr) * p
        rdotr = new_rdotr
    return x


def trpo_update(cfg: ExperimentConfig, params, w_baseline, batch):
    """One TRPO update on collected data.

    batch: dict(obs (N,T,do), actions (N,T,da), rewards (N,T)).
    Returns (new_params, new_w_baseline, stats) where stats carries the
    parity quantities (g, x, beta, accepted k, kl).
    """
    tr = cfg.trpo
    obs, actions, rewards = batch["obs"], batch["actions"], batch["rewards"]
    N, T, do = obs.shape
    da = actions.shape[-1]
    B = N * T

    # 1) values from OLD baseline; GAE; whiten; targets; refit (order fixed)
    phi = baseline_features(obs, T)
    values = phi @ w_baseline
    adv_raw = gae(rewards, values, tr.gamma, tr.lam,
                  dones=batch.get("dones"))
    adv = (adv_raw - adv_raw.mean()) / (adv_raw.std() + 1e-8)
    targets = adv_raw + values
    w_new = fit_baseline(phi.reshape(B, -1), targets.reshape(B),
                         tr.baseline_reg)

    # 2) flatten batch
    obs_f = obs.reshape(B, do)
    act_f = actions.reshape(B, da)
    adv_f = adv.reshape(B)

    # 3) policy gradient
    mu, logstd, cache = net.forward(params, obs_f)
    logp_old = net.log_prob(mu, logstd, act_f)
    g = surrogate_grad(params, cache, mu, act_f, adv_f)

    # 4) CG on damped FVP
    fvp = make_fvp(params, cache, mu, tr.cg_damping)
    x = conjugate_gradient(fvp, g, tr.cg_iters)

    # 5) step size from DAMPED curvature: beta = sqrt(2 delta / x^T H x)
    xhx = x @ fvp(x)
    beta = np.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # 6) backtracking line search
    theta = net.flatten(params)
    surr_old = float(np.mean(adv_f))          # ratio == 1 at theta_old
    accepted = -1
    new_params = params
    kl_final = 0.0
    for k in range(tr.ls_steps):
        step = (tr.ls_backtrack ** k) * beta * x
        cand = net.unflatten_like(params, theta + step)
        mu_c, logstd_c, _ = net.forward(cand, obs_f)
        logp_c = net.log_prob(mu_c, logstd_c, act_f)
        surr = float(np.mean(np.exp(logp_c - logp_old) * adv_f))
        kl_c = net.kl(mu, logstd, mu_c, logstd_c)
        if surr > surr_old and kl_c <= tr.delta:
            accepted, new_params, kl_final = k, cand, kl_c
            break

    stats = dict(g=g, x=x, beta=float(beta), accepted=accepted,
                 kl=kl_final, surr_old=surr_old,
                 mean_return=float(rewards.sum(axis=1).mean()))
    return new_params, w_new, stats


# --------------------------------------------------------------- train
def collect_rollouts(cfg: ExperimentConfig, env: OracleEnv, params,
                     rng: np.random.RandomState):
    """Fixed-shape batch collection. With cfg.done_dist > 0 an env whose
    post-step end-effector reaches within done_dist of the target is
    flagged done and auto-reset to a fresh episode before the next step
    (mirrors trpo_robot_control_tpu/envs/arm.py:rollout); the final step
    always terminates."""
    N, T = cfg.n_envs, cfg.horizon
    terminating = cfg.done_dist > 0.0
    q, qd, tgt = env.reset(rng, N)
    obs_buf = np.zeros((N, T, cfg.obs_dim))
    act_buf = np.zeros((N, T, env.n))
    rew_buf = np.zeros((N, T))
    done_buf = np.zeros((N, T))
    sigma = np.exp(params["logstd"])
    for t in range(T):
        o = env.obs(q, qd, tgt)
        mu, _, _ = net.forward(params, o)
        a = mu + sigma * rng.standard_normal(mu.shape)
        q, qd, tgt, r = env.step(q, qd, tgt, a)
        obs_buf[:, t] = o
        act_buf[:, t] = a
        rew_buf[:, t] = r
        if terminating:
            ee = np.stack([env.model.ee_pos(q[i]) for i in range(N)])
            done = np.sum((ee - tgt) ** 2, axis=-1) < cfg.done_dist ** 2
            done_buf[:, t] = done
            if done.any():
                task_old = None if env.task is None else env.task.copy()
                q2, qd2, tgt2 = env.reset(rng, N)
                q[done], qd[done], tgt[done] = \
                    q2[done], qd2[done], tgt2[done]
                if task_old is not None:
                    # only done envs take the freshly sampled task
                    env.task = np.where(done, env.task, task_old)
    batch = dict(obs=obs_buf, actions=act_buf, rewards=rew_buf)
    if terminating:
        done_buf[:, T - 1] = 1.0
        batch["dones"] = done_buf
    return batch


def train(cfg: ExperimentConfig, n_iters=None, seed=None, verbose=False):
    """Full oracle training run; returns (params, history)."""
    n_iters = cfg.n_iters if n_iters is None else n_iters
    seed = cfg.seed if seed is None else seed
    rng = np.random.RandomState(seed)
    env = OracleEnv(cfg)
    params = net.init_params(rng, cfg.obs_dim, cfg.arm.n_joints,
                             cfg.trpo.hidden, cfg.trpo.logstd_init)
    w = np.zeros(2 * cfg.obs_dim + 4)
    history = []
    for it in range(n_iters):
        batch = collect_rollouts(cfg, env, params, rng)
        params, w, stats = trpo_update(cfg, params, w, batch)
        history.append({k: stats[k] for k in
                        ("beta", "accepted", "kl", "mean_return")})
        if verbose:
            print(f"iter {it:3d} return {stats['mean_return']:9.3f} "
                  f"kl {stats['kl']:.4f} k {stats['accepted']}")
    return params, history
