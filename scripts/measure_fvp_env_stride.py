#!/usr/bin/env python
"""Measure the fvp_env_subsample decision (round 5).

The time-stride cliff above fvp_subsample=8 is a TIME-BIAS effect, not
a sample-count effect: at full scale c4's t-stride 20 keeps 164k
samples yet degrades to cosine 0.986, while c3's t-stride 8 is clean at
102k samples (scripts/measure_c45_stride.py, round 3). So large-N
configs whose t-8 subsample is still millions of samples (c4: 410k,
c5: 1.64M) should be able to shed the surplus over the i.i.d. ENV axis
— any fixed env subset is an unbiased Fisher estimator (the
ls_subsample argument) — and cut the CG block proportionally.

This measures, at REAL config scale:

  (a) cosine(x, x_exact) of the CG direction for env stride
      e in {1, 2, 4, 8, 16} at fixed t-stride 8, plus the exact
      (t=1, e=1) comparator, on real rollout batches;
  (b) convergence A/Bs at full scale: c4 with the candidate env
      stride vs shipped (e=1), same seed; likewise c5.

Acceptance rule: an env stride is adoptable while its cosine-vs-exact
stays at the shipped t-8 level (c4 ~0.9996) rather than the cliff
(0.9987 at t-10 was already rejected in round 3), and the A/B is
indistinguishable.

Orchestration: one subprocess per measurement, so compiled programs do
not accumulate in one process.

  python scripts/measure_fvp_env_stride.py            # orchestrate all
  python scripts/measure_fvp_env_stride.py cos CONFIG SEED
  python scripts/measure_fvp_env_stride.py ab CONFIG ENVSTRIDE ITERS
"""
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ENV_STRIDES = (2, 4, 8, 16)


def cfg_sub(base, t_sub, e_sub):
    return base.replace(trpo=dataclasses.replace(
        base.trpo, fvp_subsample=t_sub, fvp_env_subsample=e_sub))


def run_cos(name, seed, marginal=False):
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
    # marginal mode: c5's exact (t=1) comparator OOMs on one chip (the
    # 13.1M-sample FVP's fp32 activation buffers alone are ~7 GB), so
    # there the comparator is the SHIPPED (t8, e1) estimator — c4
    # establishes env-stride-vs-exact; c5 measures the marginal
    # env-stride effect on top of the validated t8 baseline.
    ref = (8, 1) if marginal else (1, 1)
    variants = ([] if marginal else [(1, 1)]) + [(8, 1)] \
        + [(8, e) for e in ENV_STRIDES]
    xs = {}
    for t_sub, e_sub in variants:
        cfg = cfg_sub(base, t_sub, e_sub)
        _, _, st = jax.jit(lambda p, w, b, c=cfg: trpo_update(
            c, p, w, b, return_directions=True))(
                state.params, state.w, batch)
        xs[(t_sub, e_sub)] = np.asarray(st["x"], np.float64)
    x1 = xs[ref]
    out = {}
    for key, xv in xs.items():
        if key == ref:
            continue
        out["t%d_e%d" % key] = float(
            x1 @ xv / (np.linalg.norm(x1) * np.linalg.norm(xv)))
    print("RESULT " + json.dumps(out))


def run_ab(name, env_stride, n_iters):
    import numpy as np

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.trpo.train import train

    base = CONFIGS[name]
    _, hist = train(cfg_sub(base, base.trpo.fvp_subsample, env_stride),
                    n_iters=n_iters, seed=0)
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
        return run_cos(sys.argv[2], int(sys.argv[3]),
                       marginal="marginal" in sys.argv[4:])
    if len(sys.argv) > 1 and sys.argv[1] == "ab":
        return run_ab(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

    results = {"cos": {}, "ab": {}}
    for name, seeds, extra in (("c4_franka7_obstacle", (0, 1), []),
                               ("c5_multitask", (0,), ["marginal"])):
        for seed in seeds:
            cos = child(["cos", name, str(seed)] + extra, timeout=3000)
            for k, v in cos.items():
                results["cos"].setdefault(name, {}).setdefault(
                    k, []).append(v)
            print(f"# {name} seed {seed}: " + json.dumps(cos), flush=True)
    for name, stride in (("c4_franka7_obstacle", 1),
                         ("c4_franka7_obstacle", 4),
                         ("c5_multitask", 1),
                         ("c5_multitask", 8)):
        ab = child(["ab", name, str(stride), "40"], timeout=3000)
        results["ab"]["%s_e%d" % (name, stride)] = ab
        print(f"# {name} A/B env-stride {stride}: " + json.dumps(ab),
              flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
