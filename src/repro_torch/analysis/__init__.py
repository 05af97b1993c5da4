"""Static analysis for the PyTorch/CUDA port: three passes, one CLI.

The counterpart of the reference package's ``repro.analysis``, with the
same rule ids, severities and location strings, so that findings compare
one for one:

- :mod:`repro_torch.analysis.plan_rules` — ``AP-*`` plan/config
  invariants, run before compile (``api.plan(..., analyze="strict"|"warn"
  |"off")``). AP-P006 models the EC kernels' shared memory per CUDA block
  against ``smem_budget`` (default :data:`DEFAULT_SMEM_BUDGET`, the card's
  limit), where the reference models VMEM.
- :mod:`repro_torch.analysis.hlo_audit` — ``AH-*`` checks over the
  operations the eager port records while it runs a mode update and an EC
  on copies of the state (``CPSolver.audit()``), plus the serving bucket
  bound. The reference's AH-H003 and AH-H004 (and its
  ``donation_aliased``) audit compiler output that a one-controller eager
  port does not have; the module says why.
- :mod:`repro_torch.analysis.concurrency` — ``AC-*`` AST lint of the
  ``# guarded-by:`` / ``# holds:`` lock annotations in the port's
  thread-using modules, with an opt-in runtime assertion mode
  (``AMPED_ANALYSIS_ASSERT_LOCKS=1``, :mod:`repro_torch.analysis.runtime`).

CLI: ``python -m repro_torch.analysis --preset sorted`` (on the card;
``--device cpu`` off it; exit 0 clean, 1 on findings, 2 on usage errors);
see ``--help`` for the streaming/serving scenarios and ``--baseline``.
"""
import importlib

# public name -> submodule; loaded on first access, so that the solver's
# and the streamer's imports of model/runtime do not load the recorder,
# the AST lint and the plan rules
_EXPORTS = {
    "concurrency": ("DEFAULT_TARGETS", "lint_default_targets", "lint_file",
                    "lint_source"),
    "hlo_audit": ("audit_ec_kernel", "audit_serving_engine", "audit_solver",
                  "gather_free", "serving_retrace_report"),
    "model": ("AnalysisError", "Finding", "apply_baseline", "errors",
              "format_findings", "load_baseline", "save_baseline"),
    "plan_rules": ("DEFAULT_SMEM_BUDGET", "PLAN_RULES",
                   "check_autotune_cache", "check_config_modules",
                   "check_plan"),
    "runtime": ("ENV_ASSERT", "LockNotHeldError", "assert_holds",
                "lock_assertions_enabled"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_HOME))


__all__ = [
    "AnalysisError", "Finding", "errors", "format_findings",
    "apply_baseline", "load_baseline", "save_baseline",
    "PLAN_RULES", "DEFAULT_SMEM_BUDGET", "check_plan",
    "check_autotune_cache", "check_config_modules",
    "audit_solver", "audit_ec_kernel", "audit_serving_engine",
    "serving_retrace_report", "gather_free",
    "DEFAULT_TARGETS", "lint_file", "lint_source", "lint_default_targets",
    "ENV_ASSERT", "LockNotHeldError", "assert_holds",
    "lock_assertions_enabled",
]
