"""repro_torch.api — the public plan/compile/execute surface of the port.

    import repro_torch.api as api

    cfg    = api.preset("sorted", {"kernel.autotune": False})
    plan   = api.plan(tensor, cfg)                  # host preprocessing
    solver = api.compile(plan, cfg)                 # shards on the card(s)
    result = solver.run(iters=10)                   # CPResult

A plan for M devices (``runtime.num_devices``) compiles onto ``cuda:0 ..
cuda:M-1``, or onto an explicit mesh:
``api.compile(plan, cfg, mesh=cp_mesh(M, r, devices=["cuda:0"] * M))``
(``repro_torch.core.mttkrp.cp_mesh``) puts the M logical devices on one
card. ``api.compile(plan, cfg, device="cpu")`` runs the same path on the
CPU with the kernels' plain PyTorch versions.
"""
from repro_torch.api.config import (DecomposeConfig, ExchangeConfig,
                                    KernelConfig, PartitionConfig, PRESETS,
                                    RuntimeConfig, ScheduleConfig,
                                    apply_set_args, fused, optimized, paper,
                                    preset, sorted_ec)
from repro_torch.api.planning import plan
from repro_torch.api.solver import CPSolver, compile

__all__ = [
    "DecomposeConfig", "PartitionConfig", "ScheduleConfig", "KernelConfig",
    "ExchangeConfig", "RuntimeConfig", "paper", "optimized", "fused",
    "sorted_ec", "preset", "PRESETS", "apply_set_args",
    "plan",
    "compile", "CPSolver",
]
