#!/usr/bin/env python
"""Fused rollout kernel vs the XLA scan, on the GPU, per config.

For each config: the rollout alone and `make_train_many` (rollout +
update, a few updates per call), once with rollout_impl="pallas" and
once with "xla", in turns (kernel, xla, xla, kernel) inside one
process. Times are host clock around calls that end in
block_until_ready, after a compiling warm-up call; each number is the
median of --reps calls. Prints one JSON line per measurement.

  python scripts/rollout_kernel_vs_xla.py [--configs c1_reacher2,...]
      [--train-steps 3] [--reps 5] [--what rollout,train_many]

Exits non-zero without a GPU.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _timed(fn, arg_fn, reps):
    """(compile + first call s, median s of reps calls)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(arg_fn()))
    first = time.perf_counter() - t0
    ts = [first]
    for _ in range(reps):
        a = arg_fn()
        jax.block_until_ready(a)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(a))
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts[1:] or ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="c1_reacher2,c2_reacher3,"
                    "c3_franka7,c4_franka7_obstacle,c5_multitask")
    ap.add_argument("--what", default="rollout,train_many",
                    help="which of rollout,train_many to time")
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import (init_state,
                                                   make_train_many)
    from trpo_robot_control_tpu.utils.compile_cache import \
        enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: platform {dev.platform}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; jax: {dev.device_kind} x {len(jax.devices())}",
          flush=True)

    def record(**kw):
        print(json.dumps(dict(kw, card=card)), flush=True)

    for name in args.configs.split(","):
        cfg0 = CONFIGS[name]
        state = init_state(cfg0, seed=0)
        keys = iter(jax.random.split(jax.random.PRNGKey(1), 10_000))
        fns = {}
        for impl in ("pallas", "xla"):
            cfg = cfg0.replace(rollout_impl=impl)
            if "rollout" in args.what:
                fns[impl, "rollout"] = jax.jit(
                    lambda k, f=arm.make_rollout_fn(cfg):
                    f(state.params, k)["rewards"]), lambda: next(keys)
            if "train_many" in args.what:
                many = make_train_many(cfg, args.train_steps)
                fns[impl, "train_many"] = (
                    lambda s, m=many: m(s)[1]["mean_return"],
                    lambda: jax.tree.map(jnp.copy, state))
        first = {}
        for k, (fn, arg_fn) in fns.items():          # compile + warm up
            first[k] = _timed(fn, arg_fn, 0)[0]
        for impl in ("pallas", "xla", "xla", "pallas"):
            for what in ("rollout", "train_many"):
                if (impl, what) not in fns:
                    continue
                fn, arg_fn = fns[impl, what]
                med = _timed(fn, arg_fn, args.reps)[1]
                extra = {} if what == "rollout" else dict(
                    updates_per_call=args.train_steps,
                    per_update_ms=1e3 * med / args.train_steps)
                record(config=name, impl=impl, what=what,
                       first_call_s=first[impl, what], median_s=med,
                       **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
