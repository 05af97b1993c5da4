"""End-to-end run of the paper's workload: CP decomposition of a
billion-scale-profile tensor (scaled down) through the staged
``repro_torch.api`` pipeline, with plan caching and checkpoint/restart
fault tolerance. The port's twin of the reference's
``examples/decompose_billion_profile.py``.

    PYTHONPATH=src python -m repro_torch.launch.decompose_billion_profile \\
        [--profile amazon] [--scale 2e-4] [--iters 8] [--preset optimized]

Simulate a failure with --crash-after N, then rerun with the same
--checkpoint-dir to resume from the last completed sweep. The plan cache
(--plan-cache) makes the rerun skip repartitioning entirely — preprocessing
is paid once, as in the paper's reporting.

With --out-of-core the tensor is generated straight into a chunked binary
store (``repro_torch.store``, never holding a COO) and the whole pipeline
runs from it: planning reads manifest stats only, shards stream per device.
Everything runs on ``--device`` (default ``cuda``); the default
directories lie under the system's temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    import repro_torch.api as api
    from repro_torch.sparse.io import make_profile_tensor

    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="amazon",
                    choices=["amazon", "patents", "reddit", "twitch"])
    ap.add_argument("--scale", type=float, default=2e-4)
    ap.add_argument("--out-of-core", action="store_true",
                    help="generate into a tensor store and run the "
                         "pipeline out-of-core (repro_torch.store)")
    ap.add_argument("--store-dir", default=os.path.join(tmp, "amped_store"),
                    help="store directory root for --out-of-core")
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--preset", default="paper",
                    choices=["paper", "optimized", "fused", "sorted"])
    ap.add_argument("--set", dest="set_args", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--plan-cache", default=os.path.join(tmp, "amped_plans"))
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tmp, "amped_ckpt"))
    ap.add_argument("--crash-after", type=int, default=0,
                    help="simulate a node failure after N sweeps")
    ap.add_argument("--device", default="cuda",
                    help="torch device to decompose on (default cuda)")
    args = ap.parse_args(argv)

    if args.out_of_core:
        from repro_torch.store import TensorStore, write_profile_store
        path = os.path.join(args.store_dir,
                            f"{args.profile}_{args.scale}_s0.store")
        if not os.path.exists(os.path.join(path, "manifest.json")):
            write_profile_store(args.profile, path, scale=args.scale,
                                seed=0)
        t = TensorStore(path)
        print(f"{args.profile} @ scale {args.scale} (out-of-core {path}): "
              f"shape={t.shape} nnz={t.nnz}")
    else:
        t = make_profile_tensor(args.profile, scale=args.scale, seed=0)
        print(f"{args.profile} @ scale {args.scale}: shape={t.shape} "
              f"nnz={t.nnz}")

    cfg = api.preset(args.preset, {
        "rank": args.rank,
        "runtime.checkpoint_dir": args.checkpoint_dir,
    })
    cfg = api.apply_set_args(cfg, args.set_args)

    t0 = time.time()
    hits0 = api.CACHE_STATS["hits"]   # process-wide: count this plan's own
    plan = api.plan(t, cfg, cache_dir=args.plan_cache, device=args.device)
    hit = api.CACHE_STATS["hits"] > hits0
    print(f"plan: {time.time() - t0:.1f}s "
          f"({'cache hit' if hit else 'built'})")

    solver = api.compile(plan, cfg, device=args.device)
    solver.restore()  # no-op (False) when no checkpoint exists yet

    iters = args.crash_after or args.iters
    t1 = time.time()
    res = solver.run(iters, verbose=True)
    solver.close()
    if args.crash_after:
        print(f"\n-- simulated crash after sweep {res.sweeps} --")
        print(f"rerun without --crash-after to resume from "
              f"{args.checkpoint_dir}")
        return res
    dt = time.time() - t1
    print(f"\ndone: {res.sweeps} sweeps in {dt:.1f}s, "
          f"final fit {res.fits[-1]:.5f}")
    return res


if __name__ == "__main__":
    main()
