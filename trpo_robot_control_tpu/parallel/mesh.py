"""Device mesh + sharded training step (SURVEY.md sections 3, 7: the
"Distributed communication backend" the reference never had).

Design: SPMD data parallelism over a `jax.sharding.Mesh` axis 'data' —
envs sharded, parameters replicated. Inside one `shard_map`-wrapped
`train_step`, the only cross-device traffic is:

- `psum`/`pmean` of the policy gradient, the FVP result (once per CG
  iteration — the reference's accelerator DMA boundary, SURVEY.md 5.2),
  the baseline normal equations, and the line-search statistics;

all over NVLink between the cards of a host (and the network across
hosts via `jax.distributed.initialize`, see `init_distributed`). A
'model' axis joins the mesh when tensor parallelism is enabled for
larger policies (parallel/tensor.py).

The update math is IDENTICAL to the single-device path — trpo/update.py
takes `axis_name` and inserts collectives only where a batch reduction
already existed. tests/test_sharding.py asserts sharded == unsharded.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..configs.base import ExperimentConfig
from ..envs import arm
from ..models import policy
from ..trpo.train import TrainState, init_state
from ..trpo.update import trpo_update

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Mesh over the available devices: a flat ('data',) axis, or
    ('data', 'model') when the policy is tensor-parallel (n_model > 1).
    Every card reaches every other at the same rate over NVLink, so the
    mesh follows the algorithm alone."""
    devices = jax.devices() if devices is None else devices
    n_data = len(devices) // n_model if n_data is None else n_data
    if n_model == 1:
        return Mesh(np.asarray(devices[:n_data]), (DATA_AXIS,))
    dev_array = np.asarray(devices[: n_data * n_model]).reshape(
        n_data, n_model)
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def init_distributed(timeout_s: Optional[int] = None):
    """Multi-host entry: call before any jax op on multi-host slices.
    No-op when single-process (SURVEY.md section 5.4).

    The coordinator/process layout comes from JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID (as in the 2-process CPU test,
    tests/test_distributed.py).

    Failure surfacing (SURVEY.md section 7 failure-detection row): the
    startup barrier waits `timeout_s` seconds (JAX_DIST_INIT_TIMEOUT env
    var, default 120 — jax's own default is a 5-minute silent hang),
    then raises a one-line actionable RuntimeError naming the layout
    instead of hanging until the scheduler kills the job."""
    import os
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") \
        or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return
    if timeout_s is None:
        timeout_s = int(os.environ.get("JAX_DIST_INIT_TIMEOUT", "120"))
    # jax's own deadline is pushed PAST ours: on a missed barrier its
    # C++ coordination client LOG(FATAL)s the process with a cryptic
    # "another task died" before any Python except fires, so a watchdog
    # thread surfaces the actionable error first and exits cleanly.
    kw = {"coordinator_address": addr,
          "initialization_timeout": timeout_s + 60}
    if "JAX_NUM_PROCESSES" in os.environ:
        if "JAX_PROCESS_ID" not in os.environ:
            raise RuntimeError(
                "JAX_NUM_PROCESSES is set but JAX_PROCESS_ID is not — "
                "both are required for an explicit process layout")
        kw["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
        kw["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    n = kw.get("num_processes", "?")
    pid = kw.get("process_id", "?")
    msg = (f"multi-host barrier failed after {timeout_s}s: process "
           f"{pid}/{n} could not sync at coordinator {addr} — a peer "
           "process is missing, unreachable, or died before the barrier")

    import sys
    import threading
    barrier_done = threading.Event()

    def _watchdog():
        if not barrier_done.wait(timeout_s):
            print("ERROR: " + msg, file=sys.stderr, flush=True)
            os._exit(1)

    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        jax.distributed.initialize(**kw)
    except Exception as e:
        raise RuntimeError(f"{msg} ({type(e).__name__}: {e})") from e
    finally:
        barrier_done.set()


def make_sharded_train_step(cfg: ExperimentConfig, mesh: Mesh,
                            donate: bool = True):
    """jitted sharded `train_step(state) -> (state, stats)`.

    State is replicated; each shard rolls out cfg.n_envs / n_data envs
    with a key folded by its axis index (deterministic for a fixed mesh
    shape — SURVEY.md section 9 hard-part 5).
    """
    n_data = mesh.shape[DATA_AXIS]
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    if cfg.n_envs % n_data:
        raise ValueError(f"n_envs={cfg.n_envs} not divisible by "
                         f"data-axis size {n_data}")
    local_envs = cfg.n_envs // n_data
    replicated = P()

    kw = dict(donate_argnums=0) if donate else {}

    if n_model > 1:
        # tensor parallelism (parallel/tensor.py): policy hidden dim
        # sharded over 'model', composed with DP over 'data'. TrainState
        # carries FULL replicated params, so the rollout runs the same
        # resolver as the DP path — fused Pallas kernels included
        # (weights are replicated at collection time; only the UPDATE
        # math is TP-sharded). The step is TWO shard_map regions inside
        # one jit: collection under check_vma=False (the kernels'
        # fori_loop bodies don't thread vma tags), then the TP update
        # under check_vma=True (REQUIRED for correct psum transposes —
        # see tensor.py). The batch stays device-resident and
        # 'data'-sharded between the regions.
        rollout_fn_tp = arm.make_rollout_fn(cfg)
        batch_keys = ("obs", "actions", "rewards") \
            + (("dones",) if cfg.done_dist > 0.0 else ())

        def local_rollout(params, k_roll):
            idx_d = jax.lax.axis_index(DATA_AXIS)
            k_local = jax.random.fold_in(k_roll, idx_d)
            batch = rollout_fn_tp(params, k_local, n_envs=local_envs)
            # the TP update consumes the batch-major layout; the ff
            # keys feed the DP fast path only
            return {k: batch[k] for k in batch_keys}

        sharded_rollout = jax.shard_map(
            local_rollout, mesh=mesh, in_specs=(P(), P()),
            out_specs={k: P(DATA_AXIS) for k in batch_keys},
            check_vma=False)
        tp_update = make_sharded_update_tp(cfg, mesh,
                                           batch_keys=batch_keys)

        def step(state: TrainState):
            key, k_roll = jax.random.split(state.key)
            batch = sharded_rollout(state.params, k_roll)
            params, w, stats = tp_update(state.params, state.w, batch)
            return TrainState(params=params, w=w, key=key,
                              iteration=state.iteration + 1), stats

        return jax.jit(step, **kw)

    rollout_fn = arm.make_rollout_fn(cfg)

    def local_step(state: TrainState):
        idx = jax.lax.axis_index(DATA_AXIS)
        key, k_roll = jax.random.split(state.key)
        k_local = jax.random.fold_in(k_roll, idx)
        batch = rollout_fn(state.params, k_local, n_envs=local_envs)
        params, w, stats = trpo_update(cfg, state.params, state.w,
                                       batch, axis_name=DATA_AXIS)
        new_state = TrainState(params=params, w=w, key=key,
                               iteration=state.iteration + 1)
        return new_state, stats

    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=replicated,
                            out_specs=replicated, check_vma=False)
    return jax.jit(sharded, **kw)


def _key_spec(k):
    """Batch-dict sharding: envs on axis 0, except the fused kernels'
    feature-first views — (T, d, N) obs/actions and (T, N)
    rewards/dones — with envs on the LAST axis."""
    if k in ("obs_ff", "actions_ff"):
        return P(None, None, DATA_AXIS)
    if k in ("rewards_ff", "dones_ff"):
        return P(None, DATA_AXIS)
    return P(DATA_AXIS)


def make_sharded_update(cfg: ExperimentConfig, mesh: Mesh,
                        batch_keys=None):
    """Sharded update on a PRE-COLLECTED batch (envs axis sharded over
    'data'). Used by the equivalence tests and external data pipelines.
    The in_specs are derived from the batch's keys at call time (one
    jitted instance per key set), so batches with extra keys ("dones",
    "obs_ff", "actions_ff") just work; pass batch_keys to pin one."""

    def local_update(params, w, batch):
        return trpo_update(cfg, params, w, batch, axis_name=DATA_AXIS)

    def build(keys):
        batch_spec = {k: _key_spec(k) for k in keys}
        return jax.jit(jax.shard_map(
            local_update, mesh=mesh,
            in_specs=(P(), P(), batch_spec),
            out_specs=(P(), P(), P()),
            check_vma=False))

    if batch_keys is not None:
        return build(batch_keys)
    cache = {}

    def call(params, w, batch):
        keys = tuple(sorted(batch))
        if keys not in cache:
            cache[keys] = build(keys)
        return cache[keys](params, w, batch)

    return call


def make_sharded_update_tp(cfg: ExperimentConfig, mesh: Mesh,
                           batch_keys=("obs", "actions", "rewards")):
    """Tensor+data-parallel update on a PRE-COLLECTED batch: envs axis
    sharded over 'data', policy hidden dim sharded over 'model'
    (parallel/tensor.py). Takes/returns FULL replicated params."""
    from .tensor import (shard_policy_params, trpo_update_tp,
                         unshard_policy_params)
    n_model = mesh.shape[MODEL_AXIS]
    batch_spec = {k: P(DATA_AXIS) for k in batch_keys}

    def local_update(params, w, batch):
        idx_m = jax.lax.axis_index(MODEL_AXIS)
        local = shard_policy_params(params, n_model, idx_m)
        new_local, w_new, stats = trpo_update_tp(
            cfg, local, w, batch, DATA_AXIS, MODEL_AXIS)
        full = unshard_policy_params(new_local, n_model, idx_m, MODEL_AXIS)
        return full, w_new, stats

    # check_vma=True is REQUIRED on TP paths: without replication
    # tracking the forward psum transposes to another psum and sharded
    # -leaf gradients come out n_model x too large (see tensor.py)
    sharded = jax.shard_map(
        local_update, mesh=mesh,
        in_specs=(P(), P(), batch_spec),
        out_specs=(P(), P(), P()),
        check_vma=True)
    return jax.jit(sharded)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """Place a host batch with the env axis sharded over 'data'."""
    return {k: jax.device_put(jnp.asarray(v),
                              NamedSharding(mesh, _key_spec(k)))
            for k, v in batch.items()}


def train_sharded(cfg: ExperimentConfig, mesh: Mesh, n_iters=None,
                  seed=None, log_fn=None, state=None,
                  checkpoint_every: int = 0, checkpoint_dir=None):
    """Training loop over the sharded step (host pulls metrics only).
    Periodic checkpointing mirrors trpo/train.py:train."""
    import time
    n_iters = cfg.n_iters if n_iters is None else n_iters
    state = init_state(cfg, seed) if state is None else state
    # replicated on the mesh from the start, as the step returns it, so
    # the second step does not compile again for a new input sharding
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = make_sharded_train_step(cfg, mesh)
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
