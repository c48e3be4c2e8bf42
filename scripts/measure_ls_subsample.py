#!/usr/bin/env python
"""Measure the ls_subsample adoption decision at REAL config scale
(round 4): the line-search acceptance statistics are estimated on a 1/k
env-strided subsample (trpo/update.py), saving one full forward pass
over the batch per candidate eval. Decision evidence:

  (a) AGREEMENT: seeded training advanced on the EXACT line search; at
      every iteration the stride-k update is computed from the same
      (params, batch) and its accepted exponent / KL estimate compared.
      Reported: accepted-k agreement rate, max KL relative error.
  (b) convergence A/B at full c4 scale, 40 iters, same seed: k=8 vs
      exact (the estimator feeds back into training through acceptance
      only, so agreement ~1 already implies indistinguishable curves).

Orchestration: one subprocess per measurement, so compiled programs do
not accumulate in one process.

  python scripts/measure_ls_subsample.py              # orchestrate all
  python scripts/measure_ls_subsample.py agree CONFIG SEED K ITERS
  python scripts/measure_ls_subsample.py ab CONFIG K ITERS
"""
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def cfg_ls(base, k):
    return base.replace(trpo=dataclasses.replace(base.trpo,
                                                 ls_subsample=k))


def run_agree(name, seed, k, n_iters):
    import jax

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.trpo.update import trpo_update

    base = cfg_ls(CONFIGS[name], 1)
    sub = cfg_ls(CONFIGS[name], k)
    rollout_fn = arm.make_rollout_fn(base)
    state = init_state(base, seed=seed)

    upd_exact = jax.jit(lambda p, w, b: trpo_update(base, p, w, b))
    upd_sub = jax.jit(lambda p, w, b: trpo_update(sub, p, w, b))
    roll = jax.jit(rollout_fn)

    params, w, key = state.params, state.w, jax.random.PRNGKey(200 + seed)
    agree, kl_err, kls = 0, 0.0, []
    for _ in range(n_iters):
        key, kr = jax.random.split(key)
        batch = roll(params, kr)
        p1, w1, s1 = upd_exact(params, w, batch)
        _, _, s8 = upd_sub(params, w, batch)
        a1, a8 = int(s1["accepted"]), int(s8["accepted"])
        agree += int(a1 == a8)
        kl1, kl8 = float(s1["kl"]), float(s8["kl"])
        if a1 == a8 and kl1 > 1e-9:
            kl_err = max(kl_err, abs(kl8 - kl1) / kl1)
        kls.append((a1, a8, round(kl1, 6), round(kl8, 6)))
        params, w = p1, w1
    print("RESULT " + json.dumps(dict(
        agree=agree, iters=n_iters, max_kl_relerr=kl_err, detail=kls)))


def run_ab(name, k, n_iters):
    import numpy as np

    from trpo_robot_control_tpu.configs import CONFIGS
    from trpo_robot_control_tpu.trpo.train import train

    _, hist = train(cfg_ls(CONFIGS[name], k), n_iters=n_iters, seed=0)
    rets = [float(h["mean_return"]) for h in hist]
    print("RESULT " + json.dumps(dict(
        first3=float(np.mean(rets[:3])), last5=float(np.mean(rets[-5:])),
        final=rets[-1],
        accepted=[int(h["accepted"]) for h in hist])))


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
    if len(sys.argv) > 1 and sys.argv[1] == "agree":
        return run_agree(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                         int(sys.argv[5]))
    if len(sys.argv) > 1 and sys.argv[1] == "ab":
        return run_ab(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

    results = {"agree": {}, "ab_c4": {}}
    for name, seeds, iters in (("c3_franka7", (0, 1), 30),
                               ("c4_franka7_obstacle", (0, 1), 30),
                               ("c5_multitask", (0,), 20)):
        for seed in seeds:
            out = child(["agree", name, str(seed), "8", str(iters)],
                        timeout=2400)
            results["agree"].setdefault(name, []).append(
                {k: v for k, v in out.items() if k != "detail"})
            print(f"# {name} seed {seed}: agree {out['agree']}/"
                  f"{out['iters']} max_kl_relerr {out['max_kl_relerr']:.4f}",
                  flush=True)
    for k in (1, 8):
        ab = child(["ab", "c4_franka7_obstacle", str(k), "40"],
                   timeout=2400)
        results["ab_c4"][k] = ab
        print(f"# c4 A/B ls_subsample {k}: " + json.dumps(ab), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
