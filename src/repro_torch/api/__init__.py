"""repro_torch.api — the public plan/compile/execute surface of the port.

    import repro_torch.api as api

    cfg    = api.preset("sorted")                   # autotuned on the card
    plan   = api.plan(tensor, cfg, cache_dir="plans/")   # preprocess once
    solver = api.compile(plan, cfg)                 # shards on the card(s)
    result = solver.run(iters=10)                   # CPResult

A plan for M devices (``runtime.num_devices``) compiles onto ``cuda:0 ..
cuda:M-1``, or onto an explicit mesh:
``api.compile(plan, cfg, mesh=cp_mesh(M, r, devices=["cuda:0"] * M))``
(``repro_torch.core.mttkrp.cp_mesh``) puts the M logical devices on one
card. ``api.compile(plan, cfg, device="cpu")`` runs the same path on the
CPU with the kernels' plain PyTorch versions (pass ``device="cpu"`` to
``api.plan`` too when the config autotunes). ``api.plan`` also takes an
out-of-core :class:`~repro_torch.store.TensorStore`, whose plan runs
resident or, with ``runtime.streaming``, in budget-sized super-shards.
Everything else (``save_plan``/``load_plan``, ``solver.sweep()``,
``solver.checkpoint()/restore()``, the tracer behind ``runtime.trace``,
``api.plan(..., analyze="strict")`` and ``solver.audit()`` with their
:class:`AnalysisError` / :class:`Finding`, ``solver.export_snapshot()`` for
:mod:`repro_torch.serve`) hangs off these three calls. The legacy
``repro_torch.core.decompose.cp_decompose`` is a deprecated shim over
exactly this pipeline.
"""
from repro_torch.analysis.model import AnalysisError, Finding
from repro_torch.api.config import (DecomposeConfig, ExchangeConfig,
                                    KernelConfig, PartitionConfig, PRESETS,
                                    RuntimeConfig, ScheduleConfig,
                                    apply_set_args, fused, optimized, paper,
                                    preset, sorted_ec)
from repro_torch.api.planning import (CACHE_STATS, PlanSignatureError,
                                      load_plan, plan, plan_signature,
                                      reset_cache_stats, save_plan)
from repro_torch.api.solver import CPSolver, compile

__all__ = [
    "DecomposeConfig", "PartitionConfig", "ScheduleConfig", "KernelConfig",
    "ExchangeConfig", "RuntimeConfig", "paper", "optimized", "fused",
    "sorted_ec", "preset", "PRESETS", "apply_set_args",
    "plan", "plan_signature", "save_plan", "load_plan", "PlanSignatureError",
    "CACHE_STATS", "reset_cache_stats",
    "compile", "CPSolver",
    "AnalysisError", "Finding",
]
