"""CP decomposition launcher for the port: runs the paper's workload.

    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \\
        --set kernel.autotune=false --profile amazon --scale 1e-3
    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \\
        --set kernel.autotune=false --scale 2e-5 --device cpu   # no card

Runs the staged repro_torch.api pipeline on one device — the card unless
``--device cpu`` — and reports preprocessing (plan) time separately from
compile (shard placement) and execution time, as the reference launcher
does. The ``fused`` and ``sorted`` presets turn the autotuner on, which the
port does not have yet: pass ``--set kernel.autotune=false``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    from repro_torch.api.config import PRESETS

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="paper", choices=sorted(PRESETS),
                    help="named repro_torch.api configuration preset")
    ap.add_argument("--set", dest="set_args", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted config override, e.g. kernel.variant=fused "
                         "or runtime.tol=0 (repeatable)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--profile", default="amazon",
                     help="synthetic paper-dataset profile (default)")
    src.add_argument("--tns", default=None, metavar="PATH",
                     help="read the tensor from a .tns/.tns.gz file instead "
                          "of a synthetic profile")
    ap.add_argument("--scale", type=float, default=2e-4)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--devices", type=int, default=None, choices=(1,),
                    help="device count (the port runs one device)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the solve runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    import repro_torch.api as api
    from repro_torch.sparse.io import make_profile_tensor, read_tns

    cfg = api.preset(args.preset, {"rank": args.rank})
    if args.devices:
        cfg = cfg.with_overrides({"runtime.num_devices": args.devices})
    cfg = api.apply_set_args(cfg, args.set_args)

    if args.tns is not None:
        t = read_tns(args.tns)
        source = args.tns
    else:
        t = make_profile_tensor(args.profile, scale=args.scale, seed=0)
        source = f"{args.profile} @ {args.scale}"
    print(f"{source}: shape={t.shape} nnz={t.nnz} "
          f"preset={args.preset} rank={cfg.rank} "
          f"variant={cfg.kernel.resolved_variant()} "
          f"policy={cfg.resolved_policy()} device={args.device}")

    t0 = time.perf_counter()
    plan = api.plan(t, cfg)
    t_plan = time.perf_counter() - t0
    part = plan.modes[0]
    print(f"geometry: tile={part.tile} block_p={part.block_p} "
          f"layout={part.block_layout}")
    solver = api.compile(plan, cfg, device=args.device)
    t_compile = time.perf_counter() - t0 - t_plan
    t1 = time.perf_counter()
    res = solver.run(args.iters, verbose=True)
    t_exec = time.perf_counter() - t1

    print(f"plan {t_plan:.1f}s | compile {t_compile:.1f}s | "
          f"execute {t_exec:.1f}s")
    print(f"{res.sweeps} sweeps; final fit {res.fits[-1]:.5f}")


if __name__ == "__main__":
    main()
