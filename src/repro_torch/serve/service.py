"""`CPService` — the long-running decomposition service.

The counterpart of the reference package's ``serve/service.py``, serving
from the card unless booted with ``device="cpu"``. Ties the subsystem together into one lifecycle:

* **boot** — load the newest verified checkpoint from a
  :class:`CheckpointManager` directory, validate its rank/shape against
  the serving geometry (same :func:`validate_factor_payload` the solver's
  restore uses — a rank-mismatched checkpoint fails with a named
  ``ValueError``, not a broadcast error), publish it as snapshot v1;
* **serve** — queries flow through a :class:`MicroBatcher` into the
  :class:`ServingEngine`; top-k slices go straight to the engine
  (already one device call each);
* **refresh** — when the backing :class:`TensorStore` grew, run an
  :func:`incremental_refit` (optionally on a background thread — queries
  keep flowing against the old snapshot), validate the candidate on a
  held-out nnz sample, and blue/green publish;
* **rolling deploy** — promote a checkpoint (e.g. from an offline full
  refit) through the same validate-then-swap gate, rolling back on a fit
  regression instead of publishing it.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.api.config import DecomposeConfig
from repro_torch.api.solver import validate_factor_payload
from repro_torch.obs import clock
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.engine import FactorSnapshot, ServingEngine
from repro_torch.serve.metrics import ServiceMetrics
from repro_torch.serve.refresh import (affected_row_masks, incremental_refit,
                                       sample_fit)
from repro_torch.store.store import TensorStore
from repro_torch.training.checkpoint import CheckpointManager

__all__ = ["CPService"]


class CPService:
    """One serving process: engine + batcher + optional store/refresh."""

    def __init__(self, engine: ServingEngine, *,
                 store: TensorStore | None = None,
                 config: DecomposeConfig | None = None,
                 checkpoint_dir: str | None = None,
                 max_batch: int = 4096, max_delay_s: float = 0.002,
                 max_depth: int = 256, default_deadline_s: float = 1.0,
                 validate_sample_nnz: int = 4096,
                 regression_margin: float = 0.02,
                 plan_cache: str | None = None):
        self.engine = engine
        self.metrics = engine.metrics
        self.store = store
        self.config = config
        self.checkpoint_dir = checkpoint_dir
        self.validate_sample_nnz = int(validate_sample_nnz)
        self.regression_margin = float(regression_margin)
        self.plan_cache = plan_cache
        self.batcher = MicroBatcher(
            engine.reconstruct_batch, max_batch=max_batch,
            max_delay_s=max_delay_s, max_depth=max_depth,
            default_deadline_s=default_deadline_s, metrics=self.metrics)
        self.deploy_events: list[dict] = []
        self._refit_lock = threading.Lock()
        self._refit_thread: threading.Thread | None = None
        self._refit_error: BaseException | None = None
        self.metrics.set_gauge("refit_in_progress", 0)

    # -- boot --------------------------------------------------------------
    @classmethod
    def boot(cls, checkpoint_dir: str, *,
             store: TensorStore | None = None,
             config: DecomposeConfig | None = None,
             rank: int | None = None, device=None,
             **kwargs) -> "CPService":
        """Start serving from the newest verified checkpoint in
        ``checkpoint_dir`` (the format :meth:`CPSolver.checkpoint` of
        either package writes) on ``device`` (``None``: the card).
        ``store`` enables refresh and deploy validation; ``config``
        parameterizes refits (its rank must match the checkpoint).
        ``rank`` alone adds the validation without a full config."""
        mgr = CheckpointManager(checkpoint_dir)
        restored = mgr.restore_latest()
        if restored is None:
            raise ValueError(
                f"no verified checkpoint under {checkpoint_dir!r}; run a "
                f"fit with runtime.checkpoint_dir set first")
        payload, step = restored
        factors, lam = payload["factors"], payload["lam"]
        expect_rank = rank if rank is not None else \
            (config.rank if config is not None else
             int(np.shape(factors[0])[1]))
        expect_shape = store.shape if store is not None else \
            tuple(int(np.shape(f)[0]) for f in factors)
        validate_factor_payload(
            factors, lam, shape=expect_shape, rank=expect_rank,
            source=f"checkpoint step {step} in {checkpoint_dir!r}")
        fits = [float(f) for f in np.atleast_1d(payload.get("fits", []))]
        snap = FactorSnapshot.from_arrays(
            factors, lam, version=1, fit=fits[-1] if fits else None,
            source=f"checkpoint step {step}", device=device)
        metrics = ServiceMetrics()
        engine = ServingEngine(snap, metrics=metrics)
        return cls(engine, store=store, config=config,
                   checkpoint_dir=checkpoint_dir, **kwargs)

    # -- queries -----------------------------------------------------------
    def reconstruct(self, indices: np.ndarray, *,
                    deadline_s: float | None = None) -> np.ndarray:
        """Batched model values at coordinates, through admission control
        (raises :class:`~repro_torch.serve.batcher.RejectedError` on
        overload)."""
        return self.batcher.submit(indices, deadline_s=deadline_s)

    def topk(self, fixed_coords: np.ndarray, mode: int, k: int):
        """Top-k slice query, directly on the engine."""
        return self.engine.topk_slice(fixed_coords, mode, k)

    # -- refresh / deploy --------------------------------------------------
    def _validated_publish(self, candidate: FactorSnapshot,
                           kind: str, extra: dict) -> dict:
        """The shared deploy gate: score incumbent and candidate on the
        same held-out nnz sample, publish on parity-or-better, roll back
        on regression beyond ``regression_margin``. The two sample fits
        are host work; their seconds are the event's ``sample_fit_s``."""
        event = {"kind": kind, "time_unix": time.time(),
                 "candidate_version": candidate.version,
                 "candidate_source": candidate.source, **extra}
        if self.store is not None:
            seed = self.store.nnz  # same draw for both sides, fresh per nnz
            cur = self.engine.snapshot
            t0 = clock.now()
            fit_cur = sample_fit(cur.host_factors(), cur.host_lam(),
                                 self.store,
                                 sample_nnz=self.validate_sample_nnz,
                                 seed=seed)
            fit_cand = sample_fit(candidate.host_factors(),
                                  candidate.host_lam(), self.store,
                                  sample_nnz=self.validate_sample_nnz,
                                  seed=seed)
            event["sample_fit_s"] = clock.now() - t0
            event["sample_fit_current"] = fit_cur
            event["sample_fit_candidate"] = fit_cand
            if fit_cand < fit_cur - self.regression_margin:
                event["published"] = False
                event["rolled_back"] = True
                self.metrics.inc("rollbacks_total")
                self.deploy_events.append(event)
                return event
        self.engine.publish(candidate)
        event["published"] = True
        event["rolled_back"] = False
        self.metrics.inc("publishes_total")
        self.deploy_events.append(event)
        return event

    def refresh(self, *, sweeps: int = 4, wait: bool = True,
                freeze_untouched: bool = True) -> dict:
        """Detect an append on the backing store and refit incrementally.

        Returns the deploy event dict; ``{"refreshed": False}`` when the
        store is unchanged. With ``wait=False`` the refit runs on a
        background thread (one at a time) and queries continue against
        the current snapshot; join it with :meth:`wait_refresh`."""
        if self.store is None or self.config is None:
            raise ValueError("refresh needs the service booted with both "
                             "store= and config=")
        if not self._refit_lock.acquire(blocking=False):
            raise RuntimeError("a refresh/deploy is already in progress")
        try:
            delta = self.store.refresh()
            if delta is None:
                self._refit_lock.release()
                return {"refreshed": False, "reason": "store unchanged"}
            masks = affected_row_masks(self.store, delta) \
                if freeze_untouched else None
        except BaseException:
            self._refit_lock.release()
            raise

        def run() -> dict:
            try:
                candidate, info = incremental_refit(
                    self.store, self.config, self.engine.snapshot,
                    sweeps=sweeps, masks=masks,
                    plan_cache=self.plan_cache)
                return self._validated_publish(
                    candidate, "incremental_refresh",
                    {"delta": delta, "refit": info, "refreshed": True})
            finally:
                self.metrics.set_gauge("refit_in_progress", 0)
                self._refit_lock.release()

        # raised here, not on the refit thread, so that a caller that
        # polls the gauge after refresh() returns sees the refit running
        self.metrics.set_gauge("refit_in_progress", 1)
        if wait:
            return run()

        def run_bg() -> None:
            try:
                run()
            except BaseException as e:  # surfaced by wait_refresh()
                self._refit_error = e

        self._refit_thread = threading.Thread(
            target=run_bg, daemon=True, name="serve-refit")
        self._refit_thread.start()
        return {"refreshed": True, "background": True, "delta": delta}

    def wait_refresh(self) -> dict | None:
        """Join a background refresh; re-raise its exception, return its
        deploy event (or None when no refresh ran in the background)."""
        if self._refit_thread is not None:
            self._refit_thread.join()
            self._refit_thread = None
        if self._refit_error is not None:
            err, self._refit_error = self._refit_error, None
            raise err
        return self.deploy_events[-1] if self.deploy_events else None

    def deploy_checkpoint(self, step: int | None = None) -> dict:
        """Rolling deploy: load a checkpoint (newest verified when
        ``step`` is None), validate on the held-out sample, swap — or
        roll back on regression. The offline-full-refit promotion path."""
        if self.checkpoint_dir is None:
            raise ValueError("service booted without checkpoint_dir")
        mgr = CheckpointManager(self.checkpoint_dir)
        if step is None:
            restored = mgr.restore_latest()
        else:
            payload = mgr.restore(step)
            restored = None if payload is None else (payload, step)
        if restored is None:
            raise ValueError(f"no verified checkpoint "
                             f"{'at step %d ' % step if step else ''}under "
                             f"{self.checkpoint_dir!r}")
        payload, step = restored
        cur = self.engine.snapshot
        validate_factor_payload(
            payload["factors"], payload["lam"], shape=cur.shape,
            rank=cur.rank,
            source=f"checkpoint step {step} in {self.checkpoint_dir!r}")
        fits = [float(f) for f in np.atleast_1d(payload.get("fits", []))]
        candidate = FactorSnapshot.from_arrays(
            payload["factors"], payload["lam"], version=cur.version + 1,
            fit=fits[-1] if fits else None,
            source=f"checkpoint step {step}", device=cur.device)
        if not self._refit_lock.acquire(blocking=False):
            raise RuntimeError("a refresh/deploy is already in progress")
        try:
            return self._validated_publish(candidate, "rolling_deploy",
                                           {"step": step})
        finally:
            self._refit_lock.release()

    # -- observability / teardown ------------------------------------------
    def metrics_report(self) -> dict:
        """:meth:`ServiceMetrics.metrics_report` plus snapshot identity,
        age, and the deploy event log."""
        snap = self.engine.snapshot
        report = self.metrics.metrics_report()
        report["snapshot"] = {
            "version": snap.version,
            "age_s": snap.age_s,
            "fit": snap.fit,
            "source": snap.source,
            "shape": list(snap.shape),
            "rank": snap.rank,
        }
        report["deploy_events"] = list(self.deploy_events)
        return report

    def close(self) -> None:
        """Drain: reject queued queries, join any background refit."""
        self.batcher.close()
        if self._refit_thread is not None:
            self._refit_thread.join()
            self._refit_thread = None

    def __enter__(self) -> "CPService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
