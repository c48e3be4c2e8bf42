#!/usr/bin/env python
"""Measure the c2 fvp_subsample decision (round-2 verdict item 3).

c2 ran stride-1 FVP while c3-c5 run stride-8. This script measures, at
the REAL c2 config (3-link, 1024 envs, horizon 100):

  (a) cosine(x_sub, x_exact) of the CG natural-gradient direction for
      stride in {2, 4, 8, 16} on a real rollout batch (several seeds);
  (b) a convergence A/B: seeded short training runs, exact vs strided,
      comparing return improvement.

Runs on any backend (the estimator statistics do not depend on the
chip). Writes results to stdout; the decision and its numbers are in
configs/__init__.py.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

from trpo_robot_control_tpu.configs import C2_REACHER3
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.trpo.train import init_state, train
from trpo_robot_control_tpu.trpo.update import trpo_update


def cfg_sub(sub):
    return C2_REACHER3.replace(
        trpo=dataclasses.replace(C2_REACHER3.trpo, fvp_subsample=sub))


def direction_cosines(seeds=(0, 1, 2)):
    out = {}
    cfgs = {s: cfg_sub(s) for s in (1, 2, 4, 5, 10, 20)}
    for seed in seeds:
        state = init_state(C2_REACHER3, seed=seed)
        batch = jax.jit(
            lambda p, k: arm.rollout(C2_REACHER3, p, policy.sample, k))(
                state.params, jax.random.PRNGKey(100 + seed))
        xs = {}
        for sub, cfg in cfgs.items():
            _, _, st = jax.jit(lambda p, w, b, c=cfg: trpo_update(
                c, p, w, b, return_directions=True))(
                    state.params, state.w, batch)
            xs[sub] = np.asarray(st["x"], np.float64)
        x1 = xs[1]
        for sub in (2, 4, 5, 10, 20):
            cos = float(x1 @ xs[sub]
                        / (np.linalg.norm(x1) * np.linalg.norm(xs[sub])))
            out.setdefault(sub, []).append(cos)
    return out


def convergence_ab(n_iters=40, subs=(1, 4, 10)):
    """Full-scale c2 training, exact vs strided, same seed."""
    res = {}
    for sub in subs:
        _, hist = train(cfg_sub(sub), n_iters=n_iters, seed=0)
        rets = [float(h["mean_return"]) for h in hist]
        res[sub] = dict(first3=float(np.mean(rets[:3])),
                        last5=float(np.mean(rets[-5:])),
                        final=rets[-1])
    return res


def main():
    print("# direction cosines vs exact (stride 1), 3 seeds:")
    cos = direction_cosines()
    for sub, vals in sorted(cos.items()):
        print(f"  stride {sub:2d}: min {min(vals):.5f}  "
              f"vals {[round(v, 5) for v in vals]}")
    print("# convergence A/B (40 iters, full c2 scale, seed 0):")
    ab = convergence_ab()
    for sub, r in sorted(ab.items()):
        print(f"  stride {sub}: first3 {r['first3']:.3f} -> "
              f"last5 {r['last5']:.3f} (final {r['final']:.3f})")
    print(json.dumps(dict(cosines=cos, ab=ab)))


if __name__ == "__main__":
    main()
