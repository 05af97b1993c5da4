"""repro_torch.serve — decomposition-as-a-service, on the card.

The counterpart of the reference package's ``repro.serve``: the same
modules, names and lifecycle, with every snapshot on the card unless booted
with ``device="cpu"``. The solver side of the repo turns a tensor into
factors; this package turns factors into a long-running query service, the
regime the ROADMAP's production north star describes:

* :mod:`repro_torch.serve.engine` — :class:`FactorSnapshot` (immutable
  published model version) and :class:`ServingEngine` (shape-bucketed
  ``reconstruct_batch`` / ``topk_slice`` queries as plain torch
  operations; blue/green snapshot swaps).
* :mod:`repro_torch.serve.batcher` — :class:`MicroBatcher` request
  coalescing with admission control (bounded depth, deadlines,
  :class:`RejectedError` on overload).
* :mod:`repro_torch.serve.refresh` — grown-store detection
  (:meth:`TensorStore.refresh`) and :func:`incremental_refit`
  (warm-start ALS with untouched rows frozen), plus the fit evaluators
  deploys gate on.
* :mod:`repro_torch.serve.metrics` — :class:`ServiceMetrics` counters /
  latency histograms / gauges behind one JSON ``metrics_report()``.
* :mod:`repro_torch.serve.service` — :class:`CPService`: boot from a
  checkpoint directory, serve during background refits, rolling deploys
  with rollback on fit regression.

Quickstart (after a fit with ``runtime.checkpoint_dir`` set)::

    from repro_torch.serve import CPService
    from repro_torch.store import TensorStore

    svc = CPService.boot("ckpts/", store=TensorStore("data.store"),
                         config=cfg)
    values = svc.reconstruct(coords)           # (k, nmodes) -> (k,)
    scores, items = svc.topk([user, 0, t], mode=1, k=10)
    # ... append_to_store(...) grows data.store ...
    svc.refresh(wait=False)                    # queries keep flowing
    print(svc.metrics_report())

``python -m repro_torch.serve --once`` (``--device cpu`` off the card)
drives the same lifecycle from the CLI.
"""
from repro_torch.serve.batcher import MicroBatcher, RejectedError
from repro_torch.serve.engine import FactorSnapshot, ServingEngine
from repro_torch.serve.metrics import LatencyHistogram, ServiceMetrics
from repro_torch.serve.refresh import (affected_row_masks, incremental_refit,
                                       sample_fit, store_fit)
from repro_torch.serve.service import CPService

__all__ = [
    "CPService", "FactorSnapshot", "ServingEngine", "MicroBatcher",
    "RejectedError", "ServiceMetrics", "LatencyHistogram",
    "incremental_refit", "affected_row_masks", "store_fit", "sample_fit",
]
