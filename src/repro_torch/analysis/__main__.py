"""``python -m repro_torch.analysis`` — run the three analysis passes.

The counterpart of ``python -m repro.analysis``, with its flags plus
``--device`` (``cuda``, the default, or ``cpu``); ``--smem-budget`` (bytes
of shared memory per CUDA block) takes the place of ``--vmem-budget-mb``.
Default run: the plan/config rules and the recorded-operation audit for
one preset's scenario (a small synthetic profile tensor, planned and
compiled on the device) plus the concurrency lint and the configs/
allowlist.
``--all-presets`` sweeps every named preset; ``--streaming`` and
``--serving`` add an out-of-core scenario (temp TensorStore, AP-P007)
and a serving-engine bucket scenario (AH-H006).

Exit codes: 0 — no findings; 1 — findings (after ``--baseline``
suppression); 2 — usage error.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch.analysis import (apply_baseline, audit_serving_engine,
                                  audit_solver, check_autotune_cache,
                                  check_config_modules, check_plan,
                                  concurrency, load_baseline, plan_rules,
                                  save_baseline)


def _preset_scenario(name, args, findings):
    import repro_torch.api as api
    from repro_torch.sparse.io import make_profile_tensor

    cfg = api.preset(name, {"rank": args.rank})
    t = make_profile_tensor(args.profile, scale=args.scale, seed=0)
    plan = api.plan(t, cfg, device=args.device)
    findings += check_plan(plan, cfg, deep=args.deep,
                           smem_budget=args.smem_budget)
    solver = api.compile(plan, cfg, device=args.device)
    try:
        findings += audit_solver(solver)
    finally:
        solver.close()


def _streaming_scenario(name, args, findings):
    import repro_torch.api as api
    from repro_torch.store import TensorStore
    from repro_torch.store.writer import write_profile_store

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "analysis.store")
        write_profile_store(args.profile, path, scale=args.scale,
                            chunk_nnz=4096)
        cfg = api.preset(name, {"rank": args.rank}).with_overrides({
            "runtime.streaming": True,
            "runtime.memory_budget":
                int(args.memory_budget_mb * 2 ** 20)})
        plan = api.plan(TensorStore(path), cfg, device=args.device)
        findings += check_plan(plan, cfg, deep=args.deep,
                               smem_budget=args.smem_budget)
        solver = api.compile(plan, cfg, device=args.device)
        try:
            findings += audit_solver(solver)
        finally:
            solver.close()


def _serving_scenario(args, findings):
    from repro_torch.serve.engine import FactorSnapshot, ServingEngine

    rng = np.random.default_rng(0)
    shape, rank = (64, 48, 32), 8
    snap = FactorSnapshot.from_arrays(
        [rng.normal(size=(s, rank)).astype(np.float32) for s in shape],
        np.ones(rank, np.float32), version=1, source="analysis-cli",
        device=args.device)
    engine = ServingEngine(snap)
    for n in (1, 5, 9, 33, 100):
        idx = np.stack([rng.integers(0, s, size=n) for s in shape], axis=1)
        engine.reconstruct_batch(idx)
    engine.topk_slice(np.zeros(len(shape), np.int64), mode=1, k=4)
    engine.topk_slice(np.zeros(len(shape), np.int64), mode=2, k=7)
    findings += audit_serving_engine(engine)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan/kernel invariant checker, recorded-"
                    "operation auditor, and concurrency lint")
    sel = ap.add_mutually_exclusive_group()
    sel.add_argument("--preset", default="paper",
                     help="named repro_torch.api preset to analyze "
                          "(default: paper)")
    sel.add_argument("--all-presets", action="store_true",
                     help="sweep every named preset")
    ap.add_argument("--profile", default="amazon",
                    help="synthetic dataset profile for the scenario")
    ap.add_argument("--scale", type=float, default=2e-5)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--deep", action="store_true",
                    help="stream lazy plans' per-device arrays for the "
                         "O(nnz) rules (AP-P003/4/5)")
    ap.add_argument("--smem-budget", type=int,
                    default=plan_rules.DEFAULT_SMEM_BUDGET, metavar="BYTES",
                    help="AP-P006's shared memory per CUDA block (default: "
                         "the card's limit)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where scenarios plan, compile and run (cpu: the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--streaming", action="store_true",
                    help="add an out-of-core scenario (temp TensorStore, "
                         "checks AP-P007)")
    ap.add_argument("--memory-budget-mb", type=float, default=8.0,
                    metavar="MB", help="budget for --streaming")
    ap.add_argument("--serving", action="store_true",
                    help="add a serving-engine bucket scenario (AH-H006)")
    ap.add_argument("--skip-compile", action="store_true",
                    help="plan rules + lint only (no solver compile or "
                         "operation audit) — fast mode for pre-commit hooks")
    ap.add_argument("--lint-file", action="append", default=[],
                    metavar="PATH",
                    help="additional file for the concurrency lint "
                         "(repeatable; default targets still run)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="JSON baseline of accepted findings "
                         "(rule+location) that do not fail the run")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write current findings as an accepted baseline "
                         "and exit 0")
    args = ap.parse_args(argv)

    findings = []
    findings += concurrency.lint_default_targets()
    for path in args.lint_file:
        findings += concurrency.lint_file(path)
    findings += check_config_modules()
    findings += check_autotune_cache()

    presets = None
    if args.all_presets:
        from repro_torch.api.config import PRESETS
        presets = sorted(PRESETS)
    else:
        presets = [args.preset]
    for name in presets:
        print(f"analysis: preset {name} "
              f"({args.profile} @ {args.scale}, rank {args.rank})")
        if args.skip_compile:
            import repro_torch.api as api
            from repro_torch.sparse.io import make_profile_tensor
            cfg = api.preset(name, {"rank": args.rank})
            t = make_profile_tensor(args.profile, scale=args.scale, seed=0)
            findings += check_plan(api.plan(t, cfg, device=args.device), cfg,
                                   deep=args.deep,
                                   smem_budget=args.smem_budget)
        else:
            _preset_scenario(name, args, findings)
        if args.streaming:
            print(f"analysis: preset {name} streaming scenario "
                  f"(budget {args.memory_budget_mb} MiB)")
            _streaming_scenario(name, args, findings)
    if args.serving:
        print("analysis: serving bucket scenario")
        _serving_scenario(args, findings)

    # a rule firing identically across presets is one finding, not N
    seen, unique = set(), []
    for f in findings:
        k = (f.rule, f.location, f.message)
        if k not in seen:
            seen.add(k)
            unique.append(f)

    if args.write_baseline:
        save_baseline(args.write_baseline, unique)
        print(f"analysis: wrote {len(unique)} finding(s) to baseline "
              f"{args.write_baseline}")
        return 0

    suppressed = []
    if args.baseline:
        unique, suppressed = apply_baseline(unique,
                                            load_baseline(args.baseline))
    for f in unique:
        print(f)
    n_err = sum(f.severity == "error" for f in unique)
    n_warn = len(unique) - n_err
    note = f" ({len(suppressed)} baselined)" if suppressed else ""
    if unique:
        print(f"analysis: {n_err} error(s), {n_warn} warning(s){note}")
        return 1
    print(f"analysis: clean{note} — {len(plan_rules.PLAN_RULES)} plan "
          f"rules, operation audit, and concurrency lint passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
