#!/usr/bin/env python
"""Measure the c3/c4/c5 fvp_subsample decision (round-3: push c4/c5
past the verdict targets with a MEASURED stride, like the c2 decision).

c3-c5 run stride-8 FVP (horizon 200). Their batches are 16-64x c2's, so
the Fisher subsample estimator should tolerate a much larger stride,
and a larger stride makes CG proportionally cheaper. This measures, at
REAL config scale:

  (a) cosine(x_sub, x_exact) of the CG natural-gradient direction for
      stride in {8, 10, 20, 25, 40} (divisors of T=200 only — the ff
      path asserts T %% k == 0) on real rollout batches, several seeds;
  (b) a convergence A/B at c4 (40 iters, full scale): stride 8 vs the
      candidate vs an over-large stride, same seed.

Orchestration: one subprocess per measurement, so each measurement
starts from a fresh process and compiled programs do not accumulate.

  python scripts/measure_c45_stride.py            # orchestrate all
  python scripts/measure_c45_stride.py cos CONFIG SEED
  python scripts/measure_c45_stride.py ab CONFIG STRIDE ITERS
"""
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

STRIDES = (8, 10, 20, 25, 40)


def cfg_sub(base, sub):
    return base.replace(trpo=dataclasses.replace(base.trpo,
                                                 fvp_subsample=sub))


def run_cos(name, seed):
    import numpy as np

    import jax

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.trpo.update import trpo_update

    base = CONFIGS[name]
    rollout_fn = arm.make_rollout_fn(base)
    state = init_state(base, seed=seed)
    batch = jax.jit(rollout_fn)(state.params,
                                jax.random.PRNGKey(100 + seed))
    xs = {}
    for sub in (1,) + STRIDES:
        cfg = cfg_sub(base, sub)
        _, _, st = jax.jit(lambda p, w, b, c=cfg: trpo_update(
            c, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        xs[sub] = np.asarray(st["x"], np.float64)
    x1 = xs[1]
    out = {}
    for sub in STRIDES:
        out[sub] = float(x1 @ xs[sub]
                         / (np.linalg.norm(x1) * np.linalg.norm(xs[sub])))
    print("RESULT " + json.dumps(out))


def run_ab(name, stride, n_iters):
    import numpy as np

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.trpo.train import train

    base = CONFIGS[name]
    _, hist = train(cfg_sub(base, stride), n_iters=n_iters, seed=0)
    rets = [float(h["mean_return"]) for h in hist]
    print("RESULT " + json.dumps(dict(
        first3=float(np.mean(rets[:3])), last5=float(np.mean(rets[-5:])),
        final=rets[-1])))


def child(args, timeout):
    r = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                       capture_output=True, text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"child {args} failed rc={r.returncode}:\n"
                       + r.stderr[-1500:])


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "cos":
        return run_cos(sys.argv[2], int(sys.argv[3]))
    if len(sys.argv) > 1 and sys.argv[1] == "ab":
        return run_ab(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

    results = {"cos": {}, "ab_c4": {}}
    for name, seeds in (("c4_franka7_obstacle", (0, 1)),
                        ("c5_multitask", (0,)),
                        ("c3_franka7", (0, 1))):
        for seed in seeds:
            cos = child(["cos", name, str(seed)], timeout=2400)
            for sub, v in cos.items():
                results["cos"].setdefault(name, {}).setdefault(
                    sub, []).append(v)
            print(f"# {name} seed {seed}: " + json.dumps(cos), flush=True)
    for stride in (8, 20, 40):
        ab = child(["ab", "c4_franka7_obstacle", str(stride), "40"],
                   timeout=2400)
        results["ab_c4"][stride] = ab
        print(f"# c4 A/B stride {stride}: " + json.dumps(ab), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
