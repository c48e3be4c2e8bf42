#!/usr/bin/env python
"""Smoke test of the TRPO trainer on one GPU, through its normal entry
points, at the full width of the largest config (c5: 65,536 envs x
horizon 200).

  python chip_smoke.py               # phases 1-5 on one card
  python chip_smoke.py --four-cards  # only the 4-card data-parallel phase

Phases, all in this one process (one JAX client holds the card):
  1 device      — a GPU is present; card name and power limit.
  2 rollout     — the fused rollout kernel, compiled for the card, vs
                  rollout3d_reference at c1, c3 and c5 widths and the
                  full horizon.
  3 oracle      — the c1 update vs the fp64 NumPy oracle on one batch.
  4 precision   — the c5 update at default matmul precision vs "highest".
  5 main path   — make_train_many at c5 (with its memory_analysis), the
                  CLI at c3, __graft_entry__.entry().
  6 four cards  — (--four-cards) sharded c5 train steps and the c4
                  sharded-vs-single-card update check.

The tolerances of phases 3 and 4 are the parity contract of SURVEY.md
section 4.8: direction cosine >= 0.999, |beta| relative error <= 1e-3,
the same accepted line-search exponent. Times printed here include
compilation and are not benchmark metrics. The last line is one JSON
object {"ok": true, "device": {...}}; it is printed only when every
phase passed. Exits 2 when there is no GPU (or the repo is missing)
and 1 when a phase fails.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback

COS_MIN = 0.999          # SURVEY.md 4.8
BETA_RTOL = 1e-3         # SURVEY.md 4.8

# Kernel vs reference, both in full fp32 (pl.dot and XLA dots at
# HIGHEST). The two run the same math; they differ only in how Triton
# and XLA order and fuse (FMA-contract) the fp32 operations and in their
# cos/sin, ~1e-7 relative per step. Over 200 steps (4 s of simulated
# time) the dynamics amplify such differences, by an amount the check
# measures: the reference is run again from initial joint angles moved
# by one fp32 ulp, and the kernel may differ from the reference by at
# most 10x that divergence. The tolerance never drops below 1e-3
# absolute for obs and actions (O(1) features and torques) and 1e-3 of
# the largest reward for rewards. The arms with gravity are chaotic
# enough that over the full horizon this bound is loose (on an H100 a
# 1-ulp move of q0 shifts c5's obs by ~1), so the same rule is applied
# to the first PREFIX_STEPS steps with a 10x tighter floor, where the
# divergence is still small and the check is tight.
ROLL_ATOL = 1e-3
REW_RTOL = 1e-3
ULP_FACTOR = 10.0
PREFIX_STEPS = 20


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _cosine(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _check_parity(label, x_a, x_b, beta_a, beta_b, k_a, k_b):
    cos = _cosine(x_a, x_b)
    beta_rel = abs(float(beta_a) - float(beta_b)) / abs(float(beta_b))
    print(f"  {label}: cos(x) {cos:.7f} (>= {COS_MIN}), |beta| rel err "
          f"{beta_rel:.3e} (<= {BETA_RTOL}), accepted k {int(k_a)} vs "
          f"{int(k_b)}", flush=True)
    assert cos >= COS_MIN and beta_rel <= BETA_RTOL \
        and int(k_a) == int(k_b), label


def _finite(tree):
    import jax
    import numpy as np
    return all(bool(np.all(np.isfinite(np.asarray(x, np.float64))))
               for x in jax.tree.leaves(tree))


def _peak(dev=None):
    import jax
    dev = dev or jax.devices()[0]
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


_STATE = {}        # the c5 batch from phase 2, reused by phase 4


def phase_rollout():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from trpo_robot_control_tpu.configs import (C1_REACHER2, C3_FRANKA7,
                                                C5_MULTITASK)
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import (
        pallas_rollout3d, rollout3d_reference)
    from trpo_robot_control_tpu.trpo.train import init_state

    hi = jax.lax.Precision.HIGHEST
    for cfg in (C1_REACHER2, C3_FRANKA7, C5_MULTITASK):
        N, T, n = cfg.n_envs, cfg.horizon, cfg.arm.n_joints
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        params = init_state(cfg, seed=0).params    # phase 4's policy too
        s0 = arm.reset(cfg, k2, N)
        eps = jax.random.normal(k3, (T, N, n))
        args = (params, s0.q, s0.qd, s0.tgt, s0.task, eps)

        def kern(p, q0, qd0, tgt, task, e, precision=None, store=None):
            return pallas_rollout3d(cfg, p, k1, eps=e, q0=q0, qd0=qd0,
                                    tgt=tgt, task=task, store_dtype=store,
                                    precision=precision)

        with jax.default_matmul_precision("highest"):
            ref_fn = jax.jit(lambda p, q0, qd0, tgt, task, e:
                             rollout3d_reference(cfg, p, q0, qd0, tgt, e,
                                                 task=task))
            ref = ref_fn(*args)
            q0_ulp = jnp.nextafter(s0.q, jnp.full_like(s0.q, jnp.inf))
            ref_ulp = ref_fn(params, q0_ulp, *args[2:])
        t0 = time.perf_counter()
        out = jax.jit(lambda *a: kern(*a, precision=hi))(*args)
        jax.block_until_ready(out)
        print(f"  {cfg.name} ({N} x {T}): kernel compile + run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        # the shipped variant (TF32 MLP, the config's storage dtype) at
        # the smallest and the largest width only: each is one more
        # Triton compile
        ship = None
        store = jnp.bfloat16 if cfg.trpo.ff_store_dtype == "bf16" else None
        if cfg is not C3_FRANKA7:
            ship = jax.jit(lambda *a: kern(*a, store=store))(*args)
        if cfg is C5_MULTITASK:
            _STATE["c5_batch"] = ship
        for k in ("obs", "actions", "rewards"):
            line, ok = f"    {k}:", np.all(np.isfinite(np.asarray(out[k])))
            for steps, floor in ((min(PREFIX_STEPS, T), 0.1), (T, 1.0)):
                r = np.asarray(ref[k][:, :steps], np.float64)
                err = float(np.abs(np.asarray(out[k][:, :steps], np.float64)
                                   - r).max())
                sens = float(np.abs(np.asarray(ref_ulp[k][:, :steps],
                                               np.float64) - r).max())
                base = REW_RTOL * float(np.abs(r).max()) if k == "rewards" \
                    else ROLL_ATOL
                tol = max(floor * base, ULP_FACTOR * sens)
                line += (f" first {steps} steps: max |kernel - reference| "
                         f"fp32 {err:.3e} (tol {tol:.3e}; reference moved "
                         f"by 1 ulp of q0: {sens:.3e});")
                ok = ok and err <= tol
            if ship is not None:
                err_ship = float(np.abs(np.asarray(ship[k], np.float64)
                                        - np.asarray(ref[k], np.float64)
                                        ).max())
                line += (f" shipped precision (TF32 MLP, "
                         f"{np.dtype(store or np.float32).name} "
                         f"obs/actions) {err_ship:.3e}")
            print(line, flush=True)
            assert ok, (cfg.name, k)


def phase_oracle():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oracle import net as onet
    from oracle.trpo import OracleEnv, collect_rollouts
    from oracle.trpo import trpo_update as oracle_update
    from trpo_robot_control_tpu.configs import C1_REACHER2
    from trpo_robot_control_tpu.trpo.update import trpo_update

    cfg = C1_REACHER2
    rng = np.random.RandomState(0)
    params = onet.init_params(rng, cfg.arm.obs_dim, cfg.arm.n_joints,
                              cfg.trpo.hidden, cfg.trpo.logstd_init)
    batch = collect_rollouts(cfg, OracleEnv(cfg), params, rng)
    w0 = np.zeros(2 * cfg.arm.obs_dim + 4)
    _, _, st_o = oracle_update(cfg, params, w0, batch)
    f32 = lambda d: {k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
    _, _, st_j = jax.jit(lambda p, w, b: trpo_update(
        cfg, p, w, b, return_directions=True))(
        f32(params), jnp.asarray(w0, jnp.float32), f32(batch))
    _check_parity(f"c1 ({cfg.n_envs} x {cfg.horizon}) card vs fp64 oracle",
                  st_j["x"], st_o["x"], st_j["beta"], st_o["beta"],
                  st_j["accepted"], st_o["accepted"])


def phase_precision():
    import jax

    from trpo_robot_control_tpu.configs import C5_MULTITASK
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.trpo.update import trpo_update

    cfg = C5_MULTITASK
    state = init_state(cfg, seed=0)
    batch = _STATE.get("c5_batch")      # the kernel's c5 batch (phase 2)
    if batch is None:
        batch = jax.jit(arm.make_rollout_fn(cfg))(state.params,
                                                  jax.random.PRNGKey(3))

    def update(p, w, b):
        return trpo_update(cfg, p, w, b, return_directions=True)

    _, w_d, st_d = jax.jit(update)(state.params, state.w, batch)
    with jax.default_matmul_precision("highest"):
        _, w_h, st_h = jax.jit(update)(state.params, state.w, batch)
    print(f"  c5 ({cfg.n_envs} x {cfg.horizon}): cos(g) "
          f"{_cosine(st_d['g'], st_h['g']):.7f}, cos(w) "
          f"{_cosine(w_d, w_h):.7f}", flush=True)
    _check_parity("c5 default vs highest precision", st_d["x"], st_h["x"],
                  st_d["beta"], st_h["beta"], st_d["accepted"],
                  st_h["accepted"])


def phase_main_path():
    import jax

    import __graft_entry__
    from trpo_robot_control_tpu.cli import train as cli
    from trpo_robot_control_tpu.configs import C5_MULTITASK
    from trpo_robot_control_tpu.trpo.train import init_state, make_train_many

    t0 = time.perf_counter()
    state = init_state(C5_MULTITASK, seed=0)
    many = make_train_many(C5_MULTITASK, 3).lower(state).compile()
    print(f"  c5 make_train_many memory_analysis: "
          f"{many.memory_analysis()}", flush=True)
    state, stats = many(state)
    jax.block_until_ready(state)
    assert _finite((state, stats)), "make_train_many c5"
    print(f"  make_train_many c5 x 3 updates: "
          f"{time.perf_counter() - t0:.1f} s (compile included), mean "
          f"return {[round(float(r), 3) for r in stats['mean_return']]}",
          flush=True)
    t0 = time.perf_counter()
    state, stats = many(state)
    jax.block_until_ready(state)
    assert _finite((state, stats)), "make_train_many c5, second call"
    print(f"  make_train_many c5 x 3 updates, second call: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    history = cli.main(["--config", "c3_franka7", "--iters", "3"])
    assert len(history) == 3 and _finite(history), "cli c3"
    print(f"  cli c3_franka7 --iters 3: {time.perf_counter() - t0:.1f} s, "
          f"mean return {[round(h['mean_return'], 3) for h in history]}",
          flush=True)

    t0 = time.perf_counter()
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert _finite(out), "entry()"
    print(f"  __graft_entry__.entry(): {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_four_cards():
    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import __graft_entry__
    from trpo_robot_control_tpu.configs import (C4_FRANKA7_OBSTACLE,
                                                C5_MULTITASK)
    from trpo_robot_control_tpu.parallel.mesh import (make_mesh,
                                                      make_sharded_train_step,
                                                      shard_batch)
    from trpo_robot_control_tpu.trpo.train import init_state

    devs = jax.devices()
    assert len(devs) >= 4, f"{len(devs)} devices"
    mesh = make_mesh(n_data=4, devices=devs[:4])
    print(f"  mesh {dict(mesh.shape)}", flush=True)
    t0 = time.perf_counter()
    step = make_sharded_train_step(C5_MULTITASK, mesh)
    state = jax.device_put(init_state(C5_MULTITASK, seed=0),
                           NamedSharding(mesh, P()))
    returns = []
    for _ in range(3):
        state, stats = step(state)
        returns.append(float(stats["mean_return"]))
    assert _finite((state, returns)), "sharded c5 steps"
    print(f"  sharded c5 x 3 steps: {time.perf_counter() - t0:.1f} s, "
          f"mean return {[round(r, 3) for r in returns]}", flush=True)

    cfg = C4_FRANKA7_OBSTACLE
    probe = shard_batch(mesh, {"obs": np.zeros((cfg.n_envs, 1, 1),
                                               np.float32)})["obs"]
    print(f"  c4 batch sharding {probe.sharding}; shards on "
          f"{sorted(d.id for d in probe.devices())}", flush=True)
    t0 = time.perf_counter()
    __graft_entry__._assert_sharded_update_matches(cfg, mesh)
    print(f"  c4 ({cfg.n_envs} x {cfg.horizon}) sharded update == "
          f"single-card update: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for d in devs[:4]:
        print(f"  device {d.id} peak_bytes_in_use {_peak(d)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phase")
    ap.add_argument("--only", default="",
                    help="comma-separated phase numbers to run (2-5); "
                         "default all")
    args = ap.parse_args(argv)
    try:
        import jax
        dev = jax.devices()[0]
        from trpo_robot_control_tpu.utils.compile_cache import \
            enable_compile_cache
    except Exception as e:                       # noqa: BLE001
        print(f"FAIL: cannot start: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if dev.platform != "gpu":
        print(f"FAIL: no GPU (platform {dev.platform})", file=sys.stderr)
        return 2
    print(f"cache: {enable_compile_cache()}", flush=True)
    print(_card(), flush=True)
    print(f"jax {jax.__version__}: {dev.device_kind} x {len(jax.devices())}",
          flush=True)

    if args.four_cards:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [("rollout kernel vs reference", phase_rollout),
                  ("c1 update vs oracle", phase_oracle),
                  ("c5 precision", phase_precision),
                  ("main path", phase_main_path)]
        if args.only:
            keep = {int(x) - 2 for x in args.only.split(",")}
            phases = [p for i, p in enumerate(phases) if i in keep]
    failed = []
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                        # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s; peak_bytes_in_use "
              f"{_peak()}", flush=True)
    if failed:
        print(f"FAIL: {failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
