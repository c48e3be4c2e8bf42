"""Training CLI (SURVEY.md section 2 L5): pick a config, backend, mesh;
run TRPO with JSONL metrics + periodic checkpoints.

  python -m trpo_robot_control_tpu.cli.train --config c1_reacher2 --iters 50
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="c1_reacher2",
                    help="one of the five driver configs (c1..c5 names)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="force jax platform (cpu/gpu); default: auto")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default=None,
                    help="path to a checkpoint .npz to resume from")
    ap.add_argument("--jsonl", default=None, help="metrics JSONL path")
    ap.add_argument("--sharded", action="store_true",
                    help="force the mesh/shard_map path even on 1 device")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel 'model' axis size (policy "
                         "hidden dim sharded; parallel/tensor.py)")
    ap.add_argument("--done-dist", type=float, default=None,
                    help="early episode termination distance (0 = fixed "
                         "horizon; >0 = end + auto-reset on reaching "
                         "the target; runs the XLA scan rollout)")
    ap.add_argument("--baseline", choices=("linear", "mlp"), default=None,
                    help="value baseline: linear ridge fit (default, "
                         "oracle parity) or small-MLP Adam refit")
    ap.add_argument("--trpo", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override any TRPOSpec field, e.g. "
                         "--trpo fvp_subsample=4 --trpo cg_iters=20 "
                         "--trpo delta=0.005 (repeatable; values are "
                         "cast to the field's current type)")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ..configs import CONFIGS
    from ..parallel.mesh import init_distributed, make_mesh, train_sharded
    from ..trpo.train import train
    from ..utils.checkpoint import load_checkpoint
    from ..utils.metrics import JsonlLogger

    init_distributed()

    cfg = CONFIGS[args.config]
    if args.n_envs:
        cfg = cfg.replace(n_envs=args.n_envs)
    if args.horizon:
        cfg = cfg.replace(horizon=args.horizon)
    if args.done_dist is not None:
        cfg = cfg.replace(done_dist=args.done_dist)
    if args.baseline is not None:
        import dataclasses
        cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                   baseline=args.baseline))
    if args.trpo:
        import dataclasses
        over = {}
        for kv in args.trpo:
            key, _, raw = kv.partition("=")
            if not _ or not hasattr(cfg.trpo, key):
                sys.exit(f"--trpo: unknown TRPOSpec field {kv!r} "
                         f"(fields: {[f.name for f in dataclasses.fields(cfg.trpo)]})")
            cur = getattr(cfg.trpo, key)
            over[key] = type(cur)(raw) if not isinstance(cur, str) \
                else raw
        cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo, **over))

    log = JsonlLogger(args.jsonl)
    from ..utils.checkpoint import config_hash
    if log._fh:
        import json as _json
        log._fh.write(_json.dumps({"config": cfg.name,
                                   "config_hash": config_hash(cfg),
                                   "n_envs": cfg.n_envs,
                                   "horizon": cfg.horizon}) + "\n")
        log._fh.flush()
    state = load_checkpoint(args.resume, cfg) if args.resume else None

    n_dev = len(jax.devices())
    if args.sharded or n_dev > 1 or args.n_model > 1:
        mesh = make_mesh(n_model=args.n_model)
        print(f"mesh: {dict(mesh.shape)} on {n_dev} x "
              f"{jax.devices()[0].device_kind}", file=sys.stderr)
        state, history = train_sharded(cfg, mesh, n_iters=args.iters,
                                       seed=args.seed, log_fn=log,
                                       state=state,
                                       checkpoint_every=args.ckpt_every,
                                       checkpoint_dir=args.ckpt_dir)
    else:
        print(f"single device: {jax.devices()[0].device_kind}",
              file=sys.stderr)
        state, history = train(cfg, n_iters=args.iters, seed=args.seed,
                               log_fn=log, state=state,
                               checkpoint_every=args.ckpt_every,
                               checkpoint_dir=args.ckpt_dir)
    if args.ckpt_dir:
        from ..utils.checkpoint import save_checkpoint
        path = save_checkpoint(args.ckpt_dir, cfg, state)
        print(f"checkpoint: {path}", file=sys.stderr)
    log.close()
    final = history[-1]["mean_return"] if history else float("nan")
    print(f"final mean return: {final:.3f}", file=sys.stderr)
    return history


if __name__ == "__main__":
    main()
