"""CP decomposition launcher for the port: runs the paper's workload.

    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \
        --profile amazon --scale 1e-3
    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \
        --scale 2e-5 --device cpu                     # no card
    PYTHONPATH=src python -m repro_torch.launch.decompose --profile twitch \
        --scale 2e-5 --device cpu --devices 4 --exchange-report
    PYTHONPATH=src python -m repro_torch.launch.decompose --profile twitch \
        --scale 2e-5 --device cpu --devices 4 \
        --set partition.strategy=equal_nnz --rebalance
    PYTHONPATH=src python -m repro_torch.store.convert amazon /tmp/a.store \
        --profile --scale 2e-5
    PYTHONPATH=src python -m repro_torch.launch.decompose --store /tmp/a.store \
        --stream --memory-budget-mb 0.5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.decompose --scale 2e-5 \
        --device cpu --plan-cache /tmp/plans --ckpt /tmp/ckpt \
        --trace-out /tmp/trace.json --events-out /tmp/events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.decompose --preset sorted \
        --scale 2e-5 --device cpu --analyze warn

Runs the staged repro_torch.api pipeline — on ``cuda:0 .. cuda:N-1`` (one
logical device per card; fewer visible cards than ``--devices`` raises)
unless ``--device cpu``, which runs the N logical devices on the CPU — and
reports preprocessing (plan) time separately from compile (shard placement)
and execution time, as the reference launcher does. The ``fused`` and
``sorted`` presets autotune the kernel geometry on that device first.
``--store`` runs from an out-of-core tensor store (planning reads its
manifest statistics only); ``--stream`` with ``--memory-budget-mb`` runs
it in budget-sized super-shards and prints the streaming report.
``--exchange-report`` prints the modelled exchange bytes of one sweep and
the bytes that each logical device counted. ``--rebalance``
(``schedule.rebalance=on``) and ``--measure-balance`` (``=measure``) turn
the dynamic load balancer on and print its calibrated cost model, the
measured and modelled max/mean imbalance per mode and each rebalance point,
as the reference launcher does. ``--plan-cache`` reuses preprocessing across
runs (a second run prints ``plan Xs (cache hit)``), ``--ckpt`` checkpoints
every sweep and resumes from the latest checkpoint unless ``--no-resume``;
``--trace-out`` turns the span tracer on for the whole invocation and
writes a Chrome-trace JSON (``python -m repro_torch.obs TRACE.json``
validates it), and ``--events-out`` mirrors every structured event as JSON
lines, live. ``--analyze warn|strict`` runs the
:mod:`repro_torch.analysis` plan rules on the plan and audits the compiled
solver's recorded operations (``strict`` aborts on any error finding).
"""
from __future__ import annotations

import argparse


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
    src.add_argument("--store", default=None, metavar="DIR",
                     help="run out-of-core from a tensor store directory "
                          "(repro_torch.store.convert); planning reads "
                          "manifest stats only and shards stream per "
                          "device")
    ap.add_argument("--scale", type=float, default=2e-4)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--devices", type=int, default=None,
                    help="logical device count (default: the visible cards;"
                         " 1 with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the solve runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--plan-cache", default=None,
                    help="plan cache directory (reuse preprocessing across "
                         "runs with a matching content signature)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (a checkpoint every sweep)")
    ap.add_argument("--no-resume", action="store_true",
                    help="with --ckpt: start fresh instead of resuming")
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
    ap.add_argument("--stream", action="store_true",
                    help="epoch-streaming execution: each mode's sweep "
                         "iterates over budget-sized super-shards with "
                         "double-buffered host-to-device transfer "
                         "(requires --store and --memory-budget-mb)")
    ap.add_argument("--memory-budget-mb", type=float, default=None,
                    metavar="MB",
                    help="per-device memory budget for --stream, in MiB "
                         "(covers all stream buffers of one mode shard)")
    ap.add_argument("--analyze", choices=("off", "warn", "strict"),
                    default="off",
                    help="run the repro_torch.analysis plan rules on the "
                         "plan (strict: abort on any error finding) and, "
                         "with warn/strict, audit the compiled solver's "
                         "recorded operations")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome-trace "
                         "JSON (chrome://tracing / ui.perfetto.dev) "
                         "covering plan/compile/execute")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="mirror structured events (sweeps, rebalance "
                         "points, H2D windows) as JSON lines, flushed "
                         "live")
    args = ap.parse_args(argv)

    from repro_torch.obs import clock
    from repro_torch.obs import trace as obs_trace
    if args.trace_out:
        obs_trace.enable()

    import repro_torch.api as api
    from repro_torch.sparse.io import make_profile_tensor, read_tns

    cfg = api.preset(args.preset, {"rank": args.rank})
    if args.devices:
        cfg = cfg.with_overrides({"runtime.num_devices": args.devices})
    if args.ckpt:
        cfg = cfg.with_overrides({"runtime.checkpoint_dir": args.ckpt})
    if args.rebalance:
        cfg = cfg.with_overrides({"schedule.rebalance": "on"})
    elif args.measure_balance:
        cfg = cfg.with_overrides({"schedule.rebalance": "measure"})
    if args.stream:
        overrides = {"runtime.streaming": True}
        if args.memory_budget_mb is not None:
            overrides["runtime.memory_budget"] = \
                int(args.memory_budget_mb * 2 ** 20)
        cfg = cfg.with_overrides(overrides)
    cfg = api.apply_set_args(cfg, args.set_args)

    if args.store is not None:
        from repro_torch.store import TensorStore
        t = TensorStore(args.store)
        source = f"store {args.store}"
    elif args.tns is not None:
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

    t0 = clock.now()
    hits0 = api.CACHE_STATS["hits"]   # process-wide: count this plan's own
    plan = api.plan(t, cfg, cache_dir=args.plan_cache, device=args.device,
                    analyze=args.analyze)
    t_plan = clock.now() - t0
    part = plan.modes[0]
    print(f"geometry: tile={part.tile} block_p={part.block_p} "
          f"layout={part.block_layout} devices={plan.num_devices} "
          f"r={part.r}")
    solver = api.compile(plan, cfg, device=args.device)
    t_compile = clock.now() - t0 - t_plan
    if args.events_out:
        solver.events.set_sink(args.events_out)
    if args.analyze != "off":
        findings = solver.audit()
        for f in findings:
            print(f"analysis: {f}")
        if args.analyze == "strict" and \
                any(f.severity == "error" for f in findings):
            from repro_torch.analysis import AnalysisError, errors
            raise AnalysisError(errors(findings))
    if args.ckpt and not args.no_resume:
        solver.restore()
    t1 = clock.now()
    res = solver.run(args.iters, verbose=True)
    t_exec = clock.now() - t1

    hit = args.plan_cache is not None and api.CACHE_STATS["hits"] > hits0
    print(f"plan {t_plan:.1f}s{' (cache hit)' if hit else ''} | "
          f"compile {t_compile:.1f}s | execute {t_exec:.1f}s")
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
        counted = (f"counted per device "
                   f"{rep['counted']['sweep_bytes_per_device']} B"
                   if "counted" in rep else rep["counted_skipped"])
        print(f"exchange {spec['variant']}/{spec['merge']} wire="
              f"{spec['wire_dtype']}"
              + (f" chunk_rows={spec['chunk_rows']}"
                 if spec["chunk_rows"] else "")
              + f": modelled {rep['modelled']['sweep_total_bytes']} "
              f"B/sweep/device, {counted}")

    ov = solver.overlap_report()
    if ov.get("enabled"):
        print(f"streaming: budget {ov['budget_bytes'] / 2**20:.1f} MiB/dev "
              f"x{ov['buffers']} buffers | shards/mode "
              f"{ov['shards_per_mode']} | peak resident "
              f"{ov['peak_resident_bytes'] / 2**20:.1f} MiB | "
              f"{ov['bytes_streamed'] / 2**20:.1f} MiB streamed "
              f"({ov['builds']} builds, {ov['cold_builds']} cold)")
        steady = ov["overlap_fraction_steady"]
        overlap = ov["overlap_fraction"]
        print(f"  transfer {ov['transfer_s']:.2f}s | hidden "
              f"{ov['hidden_s']:.2f}s | exposed {ov['exposed_s']:.2f}s"
              + (f" | overlap {overlap:.1%}" if overlap is not None else "")
              + (f" (steady {steady:.1%})" if steady is not None else ""))
        if ov["spill_saves"] or ov["spill_hits"]:
            print(f"  window spill: {ov['spill_saves']} saved, "
                  f"{ov['spill_hits']} replayed")
    if args.trace_out:
        solver.dump_trace(args.trace_out)
        summary = obs_trace.get_tracer().summary()
        stages = " ".join(f"{k}={v['count']}"
                          for k, v in sorted(summary.items()))
        print(f"trace: {args.trace_out} [{stages}]")
    if args.events_out:
        print(f"events: {args.events_out} ({len(solver.events)} lines)")
    solver.close()


if __name__ == "__main__":
    main()
