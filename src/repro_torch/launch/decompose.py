"""CP decomposition launcher for the port: runs the paper's workload.

    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \\
        --set kernel.autotune=false --profile amazon --scale 1e-3
    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \\
        --set kernel.autotune=false --scale 2e-5 --device cpu   # no card
    PYTHONPATH=src python -m repro_torch.launch.decompose --profile twitch \\
        --scale 2e-5 --device cpu --devices 4 --exchange-report
    PYTHONPATH=src python -m repro_torch.launch.decompose --profile twitch \\
        --scale 2e-5 --device cpu --devices 4 \\
        --set partition.strategy=equal_nnz --rebalance

Runs the staged repro_torch.api pipeline — on ``cuda:0 .. cuda:N-1`` (one
logical device per card; fewer visible cards than ``--devices`` raises)
unless ``--device cpu``, which runs the N logical devices on the CPU — and
reports preprocessing (plan) time separately from compile (shard placement)
and execution time, as the reference launcher does. ``--exchange-report``
prints the modelled exchange bytes of one sweep and the bytes that each
logical device counted. ``--rebalance`` (``schedule.rebalance=on``) and
``--measure-balance`` (``=measure``) turn the dynamic load balancer on and
print its calibrated cost model, the measured and modelled max/mean
imbalance per mode and each rebalance point, as the reference launcher
does. The ``fused`` and ``sorted`` presets turn the autotuner on, which
the port does not have yet: pass ``--set kernel.autotune=false``.
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
    ap.add_argument("--devices", type=int, default=None,
                    help="logical device count (default: the visible cards;"
                         " 1 with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the solve runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--rebalance", action="store_true",
                    help="enable the dynamic load balancer "
                         "(schedule.rebalance=on; tune via --set "
                         "schedule.cadence=... etc.)")
    ap.add_argument("--measure-balance", action="store_true",
                    help="collect per-device EC-time telemetry and report "
                         "imbalance without migrating "
                         "(schedule.rebalance=measure)")
    ap.add_argument("--exchange-report", action="store_true",
                    help="print modelled vs counted exchange bytes per "
                         "sweep")
    args = ap.parse_args(argv)

    import repro_torch.api as api
    from repro_torch.sparse.io import make_profile_tensor, read_tns

    cfg = api.preset(args.preset, {"rank": args.rank})
    if args.devices:
        cfg = cfg.with_overrides({"runtime.num_devices": args.devices})
    if args.rebalance:
        cfg = cfg.with_overrides({"schedule.rebalance": "on"})
    elif args.measure_balance:
        cfg = cfg.with_overrides({"schedule.rebalance": "measure"})
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
          f"policy={cfg.resolved_policy()} "
          f"rebalance={cfg.schedule.rebalance} device={args.device}")

    t0 = time.perf_counter()
    plan = api.plan(t, cfg, device=args.device)
    t_plan = time.perf_counter() - t0
    part = plan.modes[0]
    print(f"geometry: tile={part.tile} block_p={part.block_p} "
          f"layout={part.block_layout} devices={plan.num_devices} "
          f"r={part.r}")
    solver = api.compile(plan, cfg, device=args.device)
    t_compile = time.perf_counter() - t0 - t_plan
    t1 = time.perf_counter()
    res = solver.run(args.iters, verbose=True)
    t_exec = time.perf_counter() - t1

    print(f"plan {t_plan:.1f}s | compile {t_compile:.1f}s | "
          f"execute {t_exec:.1f}s")
    print(f"{res.sweeps} sweeps; final fit {res.fits[-1]:.5f}")

    report = solver.imbalance_report()
    if report.get("enabled"):
        c = report["coefficients"]
        print(f"schedule: epoch {report['rebalance_epoch']} | calibrated "
              f"sec_per_nnz={c['sec_per_nnz']:.3e} "
              f"sec_per_slot={c['sec_per_slot']:.3e} "
              f"sec_fixed={c['sec_fixed']:.3e}")
        for mode, row in report["per_mode"].items():
            meas = row["measured_imbalance"]
            print(f"  mode {mode} (r={row['r']}): measured max/mean "
                  f"{meas:.3f} | modelled {row['modelled_imbalance']:.3f}")
        for ev in report["events"]:
            worst = max(ev["imbalance"].values())
            print(f"  sweep {ev['sweep']}: worst imbalance {worst:.3f}, "
                  f"{ev['migrations']} migration(s), "
                  f"{ev['moved_nnz']} nnz moved")
    if args.exchange_report:
        rep = solver.exchange_report()
        spec = rep["spec"]
        print(f"exchange {spec['variant']}/{spec['merge']} wire="
              f"{spec['wire_dtype']}: modelled "
              f"{rep['modelled']['sweep_total_bytes']} B/sweep/device, "
              f"counted per device "
              f"{rep['counted']['sweep_bytes_per_device']} B")


if __name__ == "__main__":
    main()
