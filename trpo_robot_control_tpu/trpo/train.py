"""Training loop: one `jit`-compiled `train_step` per iteration (rollout +
update entirely on-device; SURVEY.md section 5.1: the host<->device
boundary is crossed once per iteration). The host only pulls scalar metrics and checkpoints.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..configs.base import ExperimentConfig
from ..envs import arm
from ..models import baseline, policy
from .update import trpo_update


class TrainState(NamedTuple):
    params: dict
    w: jax.Array          # baseline weights
    key: jax.Array
    iteration: jax.Array  # int32


def init_state(cfg: ExperimentConfig, seed: Optional[int] = None) -> TrainState:
    seed = cfg.seed if seed is None else seed
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    params = policy.init_params(k_init, cfg.obs_dim, cfg.arm.n_joints,
                                cfg.trpo.hidden, cfg.trpo.logstd_init)
    if cfg.trpo.baseline == "mlp":
        k_base, key = jax.random.split(key)
        w = baseline.init_mlp(k_base, baseline.n_features(cfg.obs_dim),
                              cfg.trpo.baseline_hidden)
    else:
        w = jnp.zeros(baseline.n_features(cfg.obs_dim), jnp.float32)
    return TrainState(params=params, w=w, key=key,
                      iteration=jnp.asarray(0, jnp.int32))


def make_train_step(cfg: ExperimentConfig, donate: bool = True):
    """Returns jitted `train_step(state) -> (state, stats)`."""
    rollout_fn = arm.make_rollout_fn(cfg)

    def train_step(state: TrainState):
        key, k_roll = jax.random.split(state.key)
        batch = rollout_fn(state.params, k_roll)
        params, w, stats = trpo_update(cfg, state.params, state.w, batch)
        new_state = TrainState(params=params, w=w, key=key,
                               iteration=state.iteration + 1)
        return new_state, stats

    kw = dict(donate_argnums=0) if donate else {}
    return jax.jit(train_step, **kw)


def make_train_many(cfg: ExperimentConfig, n_steps: int, mesh=None):
    """jit of `lax.scan` over n_steps train steps: zero host involvement
    between updates (one dispatch, one fetch). This is what bench.py times
    — per-update numbers exclude the host<->device latency that a
    per-iteration fetch would add.

    Returns fn(state) -> (state, stacked_stats).
    """
    if mesh is not None:
        from ..parallel.mesh import make_sharded_train_step
        step = make_sharded_train_step(cfg, mesh, donate=False)

        def body(state, _):
            return step(state)
    else:
        rollout_fn = arm.make_rollout_fn(cfg)

        def body(state, _):
            key, k_roll = jax.random.split(state.key)
            batch = rollout_fn(state.params, k_roll)
            params, w, stats = trpo_update(cfg, state.params, state.w,
                                           batch)
            return TrainState(params=params, w=w, key=key,
                              iteration=state.iteration + 1), stats

    def many(state):
        return jax.lax.scan(body, state, None, length=n_steps)

    return jax.jit(many, donate_argnums=0)


def train(cfg: ExperimentConfig, n_iters: Optional[int] = None,
          seed: Optional[int] = None, log_fn=None, state: Optional[TrainState] = None,
          checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
    """Run training; returns (final_state, history list of stat dicts)."""
    n_iters = cfg.n_iters if n_iters is None else n_iters
    state = init_state(cfg, seed) if state is None else state
    step = make_train_step(cfg)
    history = []
    for it in range(n_iters):
        t0 = time.perf_counter()
        state, stats = step(state)
        stats = {k: float(v) for k, v in stats.items()}
        stats["iter"] = int(state.iteration)
        stats["wall_s"] = time.perf_counter() - t0
        history.append(stats)
        if log_fn is not None:
            log_fn(stats)
        if checkpoint_every and checkpoint_dir and \
                (it + 1) % checkpoint_every == 0:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_dir, cfg, state)
    return state, history
