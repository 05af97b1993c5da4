"""repro_torch.schedule — the scheduling subsystem (partitioning policies +
dynamic load balancing), the port of the reference package's
``repro.schedule``:

  * :mod:`repro_torch.schedule.cost`      — the per-device cost model (nnz
    work, padded kernel slots, exchange volume, block count) and its EWMA
    calibration from measured EC times.
  * :mod:`repro_torch.schedule.static`    — the four one-shot partitioning
    strategies (``amped_cdf | amped_lpt | uniform_index | equal_nnz``).
  * :mod:`repro_torch.schedule.rebalance` — the dynamic half: per-mode
    per-device EC-time probes, imbalance detection, block-granular nnz
    migrations between replication-group members, and the incremental plan
    update that applies them without changing any device array shape.

:class:`repro_torch.api.CPSolver` owns a
:class:`~repro_torch.schedule.rebalance.Rebalancer` when
``schedule.rebalance`` is ``"measure"`` or ``"on"``.
"""
from repro_torch.schedule.cost import (CostCoefficients, DEFAULT_COEFFS,
                                       EwmaCostModel, device_features,
                                       exchange_bytes, fit_coefficients,
                                       index_work, predict_times)
from repro_torch.schedule.static import (POLICIES, StaticPolicy,
                                         auto_replication, get_policy)
from repro_torch.schedule.rebalance import (GroupMigration, Rebalancer,
                                            ReplanDecision, apply_rebalance,
                                            measure_mode_device_times)

__all__ = [
    # cost model
    "CostCoefficients", "DEFAULT_COEFFS", "EwmaCostModel", "device_features",
    "exchange_bytes", "fit_coefficients", "index_work", "predict_times",
    # static policies
    "POLICIES", "StaticPolicy", "auto_replication", "get_policy",
    # dynamic rebalancing
    "GroupMigration", "Rebalancer", "ReplanDecision", "apply_rebalance",
    "measure_mode_device_times",
]
