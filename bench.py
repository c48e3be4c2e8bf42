#!/usr/bin/env python
"""Benchmark harness (SURVEY.md section 8 metrics contract).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Headline metric: FVP-CG natural-gradient updates/s on config 2 (3-link
arm, 1024 envs, horizon 100, 10 CG iterations) — one full TRPO iteration
(rollout + GAE + baseline refit + CG natural gradient + KL line search)
entirely on-device per update.

Timing method: every number is a SLOPE between two on-device `lax.scan`
chain lengths (one dispatch + one host fetch each), so the fixed
dispatch and fetch cost cancels in the difference; the headline is the
MEDIAN rep slope, and the reported band is the full spread of that slope
across repetitions. Chain lengths scale with config size.

Runs on a GPU only: without one it exits non-zero. Every block names
the platform, device kind and device count. `--all` benches every
config c1-c5 in this process and prints one JSON block per config on
stderr; the default benches the headline config only.

`vs_baseline`: speedup over the reference TRPO implementation's
per-update latency at the same config. The reference mount was empty
(SURVEY.md section 0), so the stand-in is this repo's fp64 NumPy oracle —
the "pure-NumPy/CPU reference TRPO update" of BASELINE.json config 1 —
measured on this machine: 615.5 s/update at config 2 (rollout 543.9 s +
update 71.6 s; reproduce with `python bench.py --measure-oracle`).
"""
import argparse
import json
import os
import sys
import time

# fp64 NumPy oracle on this machine's CPU, config 2 (1024 envs x horizon
# 100): one full TRPO update. Measured 2026-08-17; reproduce with
# --measure-oracle.
ORACLE_C2_SECONDS_PER_UPDATE = 615.5


def measure_oracle():
    import numpy as np

    from oracle import net
    from oracle.trpo import OracleEnv, collect_rollouts, trpo_update
    from trpo_robot_control_tpu.configs import C2_REACHER3
    cfg = C2_REACHER3
    rng = np.random.RandomState(0)
    env = OracleEnv(cfg)
    params = net.init_params(rng, cfg.arm.obs_dim, cfg.arm.n_joints,
                             cfg.trpo.hidden, cfg.trpo.logstd_init)
    w = np.zeros(2 * cfg.arm.obs_dim + 4)
    t0 = time.perf_counter()
    batch = collect_rollouts(cfg, env, params, rng)
    t1 = time.perf_counter()
    trpo_update(cfg, params, w, batch)
    t2 = time.perf_counter()
    print(f"rollout_s={t1 - t0:.3f} update_s={t2 - t1:.3f} "
          f"total_s={t2 - t0:.3f}")
    return t2 - t0


def _fetch(x):
    """Force completion: pull one scalar to host."""
    import numpy as np
    return float(np.asarray(x).ravel()[-1])


def _provenance():
    """Commit + timestamp stamps for every bench block (staleness
    guard: a carried-forward table is identifiable as such)."""
    import subprocess
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10).stdout.strip()
    except Exception:
        commit = "unknown"
    return dict(commit=commit or "unknown",
                timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime()))


def bench_config(cfg, mesh, n_dev, n_lo=None, n_hi=None, reps=3,
                 ab=False):
    """Slope-timed updates/s + rollout steps/s for one config."""
    import jax

    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import (init_state,
                                                   make_train_many)

    samples = cfg.n_envs * cfg.horizon
    if n_lo is None:
        # long chains for tiny configs, so the slope is well above the
        # dispatch jitter; short ones for the big configs
        if samples >= 2_000_000:
            n_lo, n_hi = 8, 40
        elif samples < 50_000:
            n_lo, n_hi = 64, 1024
        else:
            n_lo, n_hi = 16, 144

    state = init_state(cfg, seed=0)
    many_lo = make_train_many(cfg, n_lo, mesh=mesh)
    many_hi = make_train_many(cfg, n_hi, mesh=mesh)
    # --ab: a second, separately-jitted but mathematically identical
    # chain; alternating A/B reps shows whether the variance band is
    # device state (A and B span the same band) or code.
    chains = [many_hi]
    if ab:
        chains.append(make_train_many(cfg, n_hi, mesh=mesh))

    t0 = time.perf_counter()
    state, stats = many_lo(state)           # train steps donate state;
    _fetch(stats["mean_return"])            # chain it through every call
    for c in chains:
        state, stats = c(state)
        _fetch(stats["mean_return"])
    compile_s = time.perf_counter() - t0

    slopes = [[] for _ in chains]
    last_return = None
    for _ in range(reps):
        for ci, chain in enumerate(chains):
            t0 = time.perf_counter()
            state, stats = many_lo(state)
            _fetch(stats["mean_return"])
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            state, stats = chain(state)
            last_return = _fetch(stats["mean_return"])
            t_hi = time.perf_counter() - t0
            slopes[ci].append((t_hi - t_lo) / (n_hi - n_lo))
    flat = [s for series in slopes for s in series]
    # headline = MEDIAN of the rep slopes (best-of-reps would quote the
    # luckiest window); the band reports the full spread.
    s_med = sorted(flat)[len(flat) // 2] if len(flat) % 2 else \
        sum(sorted(flat)[len(flat) // 2 - 1:len(flat) // 2 + 1]) / 2.0
    s_best, s_worst = min(flat), max(flat)

    # --- rollout-only steps/s/chip, same slope method
    rollout_fn = arm.make_rollout_fn(cfg)

    def roll_chain(n):
        def body(k, _):
            k, k2 = jax.random.split(k)
            batch = rollout_fn(state.params, k2)
            return k, batch["rewards"].sum()
        return jax.jit(lambda k: jax.lax.scan(body, k, None, length=n))

    def timed(n, reps=2):
        r = roll_chain(n)
        _fetch(r(jax.random.PRNGKey(0))[1])          # compile + warm
        best = float("inf")
        for i in range(reps):
            t0 = time.perf_counter()
            _fetch(r(jax.random.PRNGKey(1 + i))[1])
            best = min(best, time.perf_counter() - t0)
        return best

    k_lo, k_hi = (32, 1024) if samples < 50_000 else (8, 104)
    roll_s = max((timed(k_hi) - timed(k_lo)) / (k_hi - k_lo), 1e-6)
    env_steps = samples

    out = dict(
        updates_per_s=1.0 / s_med,
        updates_per_s_band=[1.0 / s_worst, 1.0 / s_best],
        per_update_ms=1e3 * s_med,
        # raw per-rep slopes (s/update) — the evidence behind the band
        slopes_raw_s=[round(s, 6) for s in slopes[0]],
        rollout_steps_per_s_per_chip=env_steps / roll_s / max(n_dev, 1),
        env_steps_per_update=env_steps,
        compile_s=compile_s,
        final_return=last_return,
        **_provenance(),
    )
    if ab:
        out["slopes_raw_s_ab"] = [round(s, 6) for s in slopes[1]]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="c2_reacher3")
    ap.add_argument("--all", action="store_true",
                    help="bench every config c1-c5")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ab", action="store_true",
                    help="interleave a second identical-code jitted "
                         "chain to document device-state variance")
    ap.add_argument("--measure-oracle", action="store_true")
    args = ap.parse_args()

    if args.measure_oracle:
        measure_oracle()
        return 0

    import jax

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.parallel.mesh import make_mesh
    from trpo_robot_control_tpu.utils.compile_cache import \
        enable_compile_cache

    devs = jax.devices()
    meta = dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                n_devices=len(devs))
    if meta["platform"] != "gpu":
        print(f"ERROR: no GPU ({meta}); bench.py measures the GPU only",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    mesh = make_mesh() if len(devs) > 1 else None
    names = list(CONFIGS) if args.all else [args.config]
    per_config = {}
    for name in names:
        per_config[name] = dict(meta, **bench_config(
            CONFIGS[name], mesh, len(devs), reps=args.reps, ab=args.ab))
        print(json.dumps({name: per_config[name]}), file=sys.stderr,
              flush=True)
    head_name = "c2_reacher3" if "c2_reacher3" in per_config else names[0]
    head = per_config[head_name]
    vs_baseline = head["updates_per_s"] * ORACLE_C2_SECONDS_PER_UPDATE \
        if head_name == "c2_reacher3" else None
    print(json.dumps({
        "metric": "fvp_cg_natural_gradient_updates_per_s",
        "value": round(head["updates_per_s"], 4),
        "unit": "updates/s",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        **meta,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
