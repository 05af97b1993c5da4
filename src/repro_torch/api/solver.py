"""Execute layer: ``compile(plan, config) -> CPSolver``.

The counterpart of the reference package's ``api/solver.py``. A
:class:`CPSolver` owns the mesh, the per-mode shards placed on its logical
devices (held through a :class:`~repro_torch.sparse.stream.ShardStreamer`,
which also re-places rebalanced shards in the background), the resolved
exchange spec, the per-mode ALS updates and the current
:class:`~repro_torch.core.als.ALSState`:

    solver = api.compile(plan, cfg)             # on cuda:0..M-1 unless told
    solver.restore()            # optional: elastic resume from checkpoints
    result = solver.run(iters)                  # CPResult — or solver.sweep()
    solver.close()                              # joins the streamer's thread

``compile(plan, cfg, mesh=cp_mesh(4, r, devices=["cuda:0"] * 4))`` places
four logical devices on one card; ``device="cpu"`` runs every logical
device on the CPU. ``load_state`` installs GLOBAL-layout factors and
``lam`` — for instance a reference ``CPResult``'s — onto every replica, so
a run carries over between the packages.

With ``runtime.checkpoint_dir`` the solver owns a
:class:`~repro_torch.training.CheckpointManager` and ``run`` checkpoints
after every sweep. ``checkpoint()`` saves replica 0's factors in the
GLOBAL layout (on the host, in the reference's on-disk format), and
``restore()`` installs them through ``load_state`` onto every replica of
THIS plan's layout: a checkpoint written under any device count — or by
the reference package — restores here.

With ``kernel.autotune`` the ring depth is the tuned winner's (tuned on the
mesh's first device), and with ``exchange.autotune_chunk`` an ``overlap``
gather's chunk size is tuned on the mesh itself.

``runtime.streaming=True`` runs a :class:`~repro_torch.store.TensorStore`
plan out of core: every mode is split into super-shards that fit
``runtime.memory_budget`` per device
(:func:`~repro_torch.store.split_mode_super_shards`), and a
:class:`~repro_torch.sparse.stream.SuperShardStreamer` moves them through
pinned host buffers and a side CUDA stream while the previous one
computes. The fits and factors are bitwise those of the same plan run
resident.

When ``config.schedule.rebalance`` is ``"measure"`` or ``"on"`` the solver
also owns a :class:`~repro_torch.schedule.rebalance.Rebalancer`: every
``schedule.cadence`` sweeps it times each logical device's EC on its device,
recalibrates the cost model, and — in ``"on"`` mode — applies
block-granular nnz migrations between replication-group members as an
incremental plan update that changes no array's shape; the streamer then
places the moved modes' shards anew in the background. With
``runtime.memory_budget`` set, migrations stay inside the streamed-slot
budget (:func:`~repro_torch.store.budget_slot_cap`). Sweeps between
rebalance points read nothing on the host.

Observability (:mod:`repro_torch.obs`): every report the solver serves is a
view over its own :class:`~repro_torch.obs.MetricsRegistry` (``report()``)
and :class:`~repro_torch.obs.EventLog` (``events``: ``sweep``,
``stream_sweep``, ``rebalance`` and the streamer's ``h2d_build`` /
``h2d_wait`` events). With the span tracer enabled (``runtime.trace=True``
or ``obs.trace.enable()``) a resident sweep runs
:func:`~repro_torch.core.als.als_traced_sweep` — the EC and the exchange
of each mode as separate stages, each in its own span and followed by a
synchronise of every card of the mesh — with fits and factors bitwise
those of the untraced sweep; ``dump_trace`` writes the spans as Chrome
trace JSON. Tracing off, each span is one shared no-op object.
"""
from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from repro_torch import comm, obs
from repro_torch.api.config import DecomposeConfig
from repro_torch.core import als as als_mod
from repro_torch.core import mttkrp as dmttkrp
from repro_torch.core.decompose import CPResult
from repro_torch.core.partition import CPPlan, validate_plan
from repro_torch.kernels import _build
from repro_torch.obs import clock
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import EventLog, MetricsRegistry
from repro_torch.obs.profiler import StreamMonitor
from repro_torch.schedule import rebalance as rebalance_mod
from repro_torch.sparse.stream import (ShardStreamer, SuperShardStreamer,
                                       WindowSpill)
from repro_torch.store.plan import budget_slot_cap, split_mode_super_shards
from repro_torch.training.checkpoint import CheckpointManager

# distinguishes concurrent solvers' sections in the process-wide
# obs.report() — names are never reused within a process
_SOLVER_IDS = itertools.count(1)

__all__ = ["CPSolver", "compile", "validate_factor_payload", "resolve_device"]


def validate_factor_payload(factors, lam, *, shape, rank,
                            source: str) -> None:
    """Validate GLOBAL-layout factors + lam against an expected geometry;
    raises ``ValueError`` naming the offending mode and both sizes."""
    nmodes = len(shape)
    if len(factors) != nmodes:
        raise ValueError(
            f"{source} has {len(factors)} factor matrices, but the target "
            f"tensor has {nmodes} modes (shape {tuple(shape)})")
    for w, fg in enumerate(factors):
        fs = tuple(int(s) for s in np.shape(fg))
        if len(fs) != 2:
            raise ValueError(f"{source} factor for mode {w} is not a "
                             f"matrix (shape {fs})")
        if fs[1] != rank:
            raise ValueError(
                f"{source} was written at rank {fs[1]}, but this "
                f"solver/plan is compiled for rank {rank} (mode {w} "
                f"factor is {fs}); re-fit or re-compile at a matching rank")
        if fs[0] != shape[w]:
            raise ValueError(
                f"{source} factor for mode {w} has {fs[0]} rows, but the "
                f"target tensor's mode {w} has {shape[w]} — the "
                f"checkpoint belongs to a different tensor")
    ls = tuple(int(s) for s in np.shape(lam))
    if ls != (rank,):
        raise ValueError(f"{source} lambda has shape {ls}, expected "
                         f"({rank},)")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never falls back to the CPU unless asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


class CPSolver:
    """A compiled CP-ALS session: mesh + per-device shards + per-mode
    updates + current :class:`~repro_torch.core.als.ALSState` (+ optional
    :class:`~repro_torch.schedule.rebalance.Rebalancer`)."""

    def __init__(self, plan: CPPlan, config: DecomposeConfig,
                 mesh: dmttkrp.CPMesh):
        lazy = any(getattr(p, "lazy", False) for p in plan.modes)
        if config.schedule.telemetry_enabled and lazy:
            raise ValueError(
                "schedule.rebalance='measure'/'on' needs an in-memory plan: "
                "the rebalancer's probes and migrations address whole-mode "
                "shard arrays, which an out-of-core TensorStore plan "
                "deliberately never materializes. Plan from the in-memory "
                "tensor (store.to_coo()) to use the dynamic scheduler, or "
                "run with schedule.rebalance='off'.")
        self.plan = plan
        self.config = config
        self.mesh = mesh
        self.streaming = config.runtime.streaming
        # The grams, the R×R solve and the fit are held to f32: TF32 keeps
        # about three decimal digits and would drift the fits away from the
        # reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # every report this solver serves is a view over this registry and
        # event log (see repro_torch.obs)
        self.metrics = MetricsRegistry()
        self.events = EventLog()
        if config.runtime.trace:
            obs_trace.enable()
        self._kernel_kw = config.kernel.mttkrp_kwargs(
            nmodes=plan.nmodes, rank=config.rank, device=mesh.devices[0])
        self.exchange_spec = comm.resolve_exchange_spec(
            config.exchange, plan=plan, rank=config.rank, mesh=mesh)
        if self.streaming:
            if not all(getattr(p, "lazy", False) for p in plan.modes):
                raise ValueError(
                    "runtime.streaming=True needs an out-of-core plan "
                    "(every mode a TensorStore-backed StoreModePartition): "
                    "super-shards are materialized per tile window from "
                    "store chunks. Plan from a TensorStore "
                    "(api.plan(TensorStore(...), cfg)), or turn streaming "
                    "off — an in-memory plan is already fully resident.")
            budget = config.runtime.memory_budget
            if budget is None:
                raise ValueError(
                    "runtime.streaming needs runtime.memory_budget "
                    "(per-device bytes for streamed shard arrays); the "
                    "super-shard split is defined by this budget")
            buffers = config.runtime.stream_buffers
            self.stream_plans = [
                split_mode_super_shards(p, budget, buffers=buffers)
                for p in plan.modes]
            spill = None
            if config.runtime.stream_spill:
                spill = WindowSpill(config.runtime.stream_spill_dir)
            self.streamer = SuperShardStreamer(
                plan, mesh, self.stream_plans, buffers=buffers, spill=spill,
                events=self.events)
            self.updates = als_mod.make_streaming_sweep_updates(
                plan, mesh, rank=config.rank,
                exchange_spec=self.exchange_spec, **self._kernel_kw)
        else:
            self.stream_plans = None
            # All modes stay resident (prefetch=nmodes): the streamer is
            # here for its background (re)placement, not for eviction —
            # out-of-memory epoch streaming is the runtime.streaming path.
            self.streamer = ShardStreamer(plan, mesh, prefetch=plan.nmodes,
                                          events=self.events)
            self.updates = als_mod.make_sweep_updates(
                plan, mesh, exchange_spec=self.exchange_spec,
                **self._kernel_kw)
            for d in range(plan.nmodes):  # placed now, as compile promises
                self.streamer.get(d)
        self.rebalancer = None
        if config.schedule.telemetry_enabled:
            sched = config.schedule
            member_caps = None
            if config.runtime.memory_budget is not None:
                # budget set on a resident plan: keep migrations inside the
                # streamed-slot budget so a later streaming run of the same
                # (rebalanced) layout still fits its super-shard windows
                member_caps = {
                    d: budget_slot_cap(
                        config.runtime.memory_budget, nmodes=plan.nmodes,
                        n_tiles=p.rows_max // p.tile, block_p=p.block_p,
                        buffers=config.runtime.stream_buffers)
                    for d, p in enumerate(plan.modes)}
            self.rebalancer = rebalance_mod.Rebalancer(
                imbalance_threshold=sched.imbalance_threshold,
                migration_budget=sched.migration_budget,
                ewma_alpha=sched.ewma_alpha,
                probe_repeats=sched.probe_repeats,
                kernel_kw=self._kernel_kw,
                migrate=sched.migrations_enabled,
                member_nnz_caps=member_caps)
        # per rebalance point: the raw probe seconds per mode and device,
        # the kernel launches the probes made (``_build.LAUNCHES`` deltas),
        # and the host seconds of the probes, the apply and the
        # re-placement's dispatch (kept apart from schedule_events, which
        # stay the reference's values)
        self.rebalance_timings: list[dict] = []
        self._ckpt_mgr = None
        if config.runtime.checkpoint_dir is not None:
            self._ckpt_mgr = CheckpointManager(config.runtime.checkpoint_dir)
        # traced resident sweeps need the EC and the exchange as separate
        # stages — built on the first traced sweep (see _traced_updates)
        self._traced_updates_cache = None
        self.metrics.register_provider("overlap", self.overlap_report)
        self.metrics.register_provider("imbalance", self.imbalance_report)
        self.metrics.register_provider(
            "exchange", lambda: self.exchange_report(measure=False))
        self.metrics.register_provider("stream",
                                       self.streamer.stats_snapshot)
        self._obs_name = f"solver.{next(_SOLVER_IDS)}"
        obs.get_registry().register_provider(self._obs_name,
                                             self.metrics.report)
        self.reset()

    @property
    def stream_events(self) -> list[dict]:
        """Per streamed sweep: transfer, exposed and hidden seconds, the
        windows placed and the bytes moved to each device (what
        :meth:`overlap_report` aggregates) — a stamp-stripped view over the
        event log's ``stream_sweep`` events."""
        return self.events.payloads("stream_sweep")

    @property
    def schedule_events(self) -> list[dict]:
        """One dict per rebalance point, as the reference's event log holds
        them (``launch.decompose`` prints them) — a stamp-stripped view
        over the event log's ``rebalance`` events."""
        return self.events.payloads("rebalance")

    @property
    def dev_arrays(self) -> list:
        """Per-mode, per-device shards (kept resident by the streamer),
        ready on each device's current stream."""
        if self.streaming:
            raise RuntimeError(
                "no whole-mode resident shards in streaming mode: tensor "
                "data cycles through super-shards under the memory budget; "
                "see overlap_report() for what is resident")
        return [self.streamer.get(d) for d in range(self.plan.nmodes)]

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        """Release the session's background resources: cancels the
        streamer's pending prefetches and joins its thread, so no copy
        outlives the solver, and removes an owned window spill. Also
        deregisters the solver's section from the process-wide
        ``obs.report()``, closes any event-log sink and waits for an
        in-flight checkpoint. Idempotent; the solver is unusable
        afterwards."""
        try:
            self.streamer.close()
        finally:
            obs.get_registry().unregister_provider(self._obs_name)
            self.events.close_sink()
            if self._ckpt_mgr is not None:
                self._ckpt_mgr.wait()

    def __enter__(self) -> "CPSolver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- state lifecycle ---------------------------------------------------
    def reset(self) -> None:
        """(Re)initialize factors from the config seed; sweep counter to 0."""
        rank = self.config.rank
        devices = self.mesh.devices
        factors = als_mod.init_factors(self.plan, rank,
                                       seed=self.config.runtime.seed,
                                       devices=devices)
        self.state = als_mod.ALSState(
            factors=factors,
            lam=als_mod.replicate(np.ones(rank, np.float32), devices),
            grams=[[f.T @ f for f in reps] for reps in factors])

    def restore(self, step: int | None = None) -> bool:
        """Elastic resume: load the latest (or given) verified checkpoint
        and install its GLOBAL-layout factors through :meth:`load_state`
        on every replica of THIS plan's layout — the checkpoint may have
        been written under any device count, or by the reference package.
        Returns True iff a checkpoint was restored."""
        if self._ckpt_mgr is None:
            raise ValueError("no checkpoint_dir configured in "
                             "config.runtime; nothing to restore from")
        if step is None:
            restored = self._ckpt_mgr.restore_latest()
        else:
            payload = self._ckpt_mgr.restore(step)
            restored = None if payload is None else (payload, step)
        if restored is None:
            return False
        payload, step = restored
        self.load_state(payload["factors"], payload["lam"],
                        fits=list(payload.get("fits", [])), sweep=step,
                        source=f"checkpoint step {step} in "
                               f"{self._ckpt_mgr.dir!r}")
        return True

    def checkpoint(self) -> None:
        """Write the current state at its sweep: replica 0's factors in
        the GLOBAL layout, its ``lam`` and the fits, all moved to the host
        first (reading them waits for the sweep's device work)."""
        if self._ckpt_mgr is None:
            raise ValueError("no checkpoint_dir configured in config.runtime")
        s = self.state
        self._ckpt_mgr.save(s.sweep, {
            "factors": als_mod.unpad_factors(self.plan, s.factors),
            "lam": s.lam[0].detach().cpu().numpy(),
            "fits": np.asarray([float(f) for f in s.fits], np.float64),
        })

    def load_state(self, factors, lam, *, fits=(), sweep: int = 0,
                   source: str = "warm-start state") -> None:
        """Install GLOBAL-layout ``(I_w, rank)`` factors and ``lam`` as the
        solver's current state on every replica — the warm-start entry of
        :meth:`restore`, and the one that carries a run over from the
        reference package (a ``CPResult``'s ``factors`` and ``lam``).
        Validates geometry first."""
        rank = self.config.rank
        validate_factor_payload(factors, lam, shape=self.plan.shape,
                                rank=rank, source=source)
        devices = self.mesh.devices
        padded = []
        for w, fg in enumerate(factors):
            fp = np.zeros((self.plan.modes[w].padded_rows, rank), np.float32)
            fp[self.plan.global_to_padded[w]] = fg
            padded.append(als_mod.replicate(fp, devices))
        self.state = als_mod.ALSState(
            factors=padded,
            lam=als_mod.replicate(np.asarray(lam, np.float32), devices),
            grams=[[f.T @ f for f in reps] for reps in padded],
            sweep=sweep, fits=list(fits))

    # -- execution ---------------------------------------------------------
    def _traced_updates(self) -> list[als_mod.StreamingModeUpdate]:
        """The EC and the exchange as separate stages for the RESIDENT plan
        — the traced sweep's updates (the streaming triples, one window
        per mode). Accumulating the EC into a zero accumulator and then
        finishing gives the bits of the one-shot update; splitting them is
        what lets each stage carry its own span. Built on the first traced
        sweep."""
        if self._traced_updates_cache is None:
            self._traced_updates_cache = als_mod.make_streaming_sweep_updates(
                self.plan, self.mesh, rank=self.config.rank,
                exchange_spec=self.exchange_spec, **self._kernel_kw)
        return self._traced_updates_cache

    def sweep(self) -> als_mod.ALSState:
        """One full ALS sweep (all modes). The appended fit is a 0-d device
        tensor (reading it blocks the host).

        In streaming mode each mode iterates its super-shards through the
        double-buffered streamer instead (fits bitwise identical), and the
        sweep's transfer and exposed seconds are emitted as a
        ``stream_sweep`` event (see :attr:`stream_events`).

        With the span tracer enabled a resident sweep runs
        :func:`~repro_torch.core.als.als_traced_sweep` instead: EC and
        exchange as separate stages with their own spans, fits still
        bitwise identical, at the cost of a synchronise after each
        stage."""
        tracer = obs_trace.get_tracer()
        with tracer.span("sweep", sweep=self.state.sweep + 1, annotate=True):
            if self.streaming:
                self._streaming_sweep()
            elif tracer.enabled:
                self.state = als_mod.als_traced_sweep(
                    self.plan, self.mesh, self.dev_arrays, self.state,
                    self._traced_updates())
            else:
                self.state = als_mod.als_sweep(self.plan, self.mesh,
                                               self.dev_arrays, self.state,
                                               self.updates)
        self.events.emit("sweep", sweep=self.state.sweep)
        return self.state

    def _streaming_sweep(self) -> None:
        before = self.streamer.stats_snapshot()
        self.state = als_mod.als_streaming_sweep(
            self.plan, self.mesh, self.streamer, self.stream_plans,
            self.state, self.updates)
        after = self.streamer.stats_snapshot()
        transfer = after["transfer_s"] - before["transfer_s"]
        exposed = after["exposed_s"] - before["exposed_s"]
        hidden = max(transfer - exposed, 0.0)
        self.events.emit(
            "stream_sweep",
            sweep=self.state.sweep,
            transfer_s=transfer,
            exposed_s=exposed,
            hidden_s=hidden,
            overlap_fraction=hidden / transfer if transfer > 0 else None,
            shards_streamed=after["builds"] - before["builds"],
            bytes_streamed=after["bytes_streamed"]
            - before["bytes_streamed"],
        )

    def rebalance_step(self):
        """One rebalance point: wait for the enqueued sweeps, probe every
        mode's per-device EC time on the live replicas, recalibrate the
        cost model, and (in ``rebalance="on"``) apply any triggered
        migrations. Returns the
        :class:`~repro_torch.schedule.rebalance.ReplanDecision`, or None
        when the scheduler is off.

        An applied decision's plan passes :func:`validate_plan` (each
        device visits a tile in one run of blocks, which the kernels need:
        they write each run's tile once, without atomics), and only the
        modes where something moved are placed anew, by the streamer in the
        background (:meth:`ShardStreamer.update_plan`, which recomputes the
        ``sorted`` descriptors); the next sweep, or the next probe, waits
        for them."""
        if self.rebalancer is None:
            return None
        als_mod.synchronize(self.mesh)
        launched = dict(_build.LAUNCHES)
        t0 = clock.now()
        decision = self.rebalancer.observe(self.plan, self.state.factors,
                                           sweep=self.state.sweep,
                                           dev_arrays=self.dev_arrays)
        t1 = clock.now()
        event = dict(self.rebalancer.events[-1])
        timing = {"sweep": self.state.sweep,
                  "probe_s": {m: t.tolist() for m, t in
                              self.rebalancer.probe_times.items()},
                  # kernel launches the probes made, counted as they ran
                  "probe_launches": {k: _build.LAUNCHES[k] - n
                                     for k, n in launched.items()},
                  "observe_s": t1 - t0, "apply_s": 0.0, "replace_s": 0.0,
                  "moved_modes": []}
        if decision.triggered:
            plan, applied = rebalance_mod.apply_rebalance(self.plan,
                                                          decision)
            self.plan = validate_plan(plan)
            t2 = clock.now()
            # Re-place only modes where something actually moved: a skipped
            # migration leaves bit-identical arrays. replace_s is the host
            # time of the dispatch; the copies run on the streamer's thread
            # and the next use of dev_arrays waits. The MTTKRPFn of each
            # mode update keeps the part it was built with; it reads only
            # mode, rows_max, tile, block_p, r and n_groups, none of which
            # a migration changes (shapes and ownership stay).
            moved = sorted({a["mode"] for a in applied
                            if a.get("moved_nnz", 0) > 0})
            if moved:
                self.streamer.update_plan(self.plan, moved)
            else:
                self.streamer.plan = self.plan  # epoch bump only
            timing.update(apply_s=t2 - t1,
                          replace_s=clock.now() - t2,
                          moved_modes=moved)
            event["applied"] = applied
            event["epoch_after"] = self.plan.rebalance_epoch
        self.events.emit("rebalance", **event)
        self.rebalance_timings.append(timing)
        return decision

    def run(self, iters: int, *, tol: float | None = None,
            verbose: bool = False) -> CPResult:
        """Sweep until ``iters`` total sweeps or the fit plateaus below
        ``tol`` (default: config.runtime.tol). Resumes from the current
        state's sweep counter, so ``restore(); run(iters)`` continues where
        the checkpoint left off. Checkpoints after every sweep when a
        checkpoint_dir is configured (which reads the factors on the
        host); hits a rebalance point every ``config.schedule.cadence``
        sweeps when the scheduler is enabled, except after the last sweep.
        The plateau test reads each fit on the host between sweeps; with
        ``tol=0`` and neither of those, nothing is read until the result."""
        if tol is None:
            tol = self.config.runtime.tol
        cadence = self.config.schedule.cadence
        with obs_trace.span("run", iters=iters, annotate=True):
            for _ in range(self.state.sweep, iters):
                state = self.sweep()
                if verbose:
                    print(f"sweep {state.sweep}: "
                          f"fit={float(state.fits[-1]):.6f}")
                if self._ckpt_mgr is not None:
                    with obs_trace.span("checkpoint", sweep=state.sweep):
                        self.checkpoint()
                if self.rebalancer is not None \
                        and state.sweep % cadence == 0 \
                        and state.sweep < iters:
                    with obs_trace.span("rebalance", sweep=state.sweep):
                        self.rebalance_step()
                if tol > 0 and len(state.fits) >= 2 and \
                        abs(float(state.fits[-1])
                            - float(state.fits[-2])) < tol:
                    break
        return self.result()

    def imbalance_report(self) -> dict:
        """Measured-vs-modelled imbalance per mode plus the rebalance
        event log — what ``launch.decompose`` prints. Empty when the
        scheduler never ran."""
        if self.rebalancer is None or not self.rebalancer.ewma_times:
            return {"enabled": False, "events": []}
        ratio = rebalance_mod.imbalance_ratio
        per_mode = {}
        for mode, part in enumerate(self.plan.modes):
            measured = self.rebalancer.ewma_times.get(mode)
            per_mode[mode] = {
                "measured_imbalance":
                    ratio(measured) if measured is not None else None,
                "modelled_imbalance":
                    ratio(self.rebalancer.cost_model.predict(part)),
                "r": int(part.r),
            }
        c = self.rebalancer.cost_model.coeffs
        return {
            "enabled": True,
            "rebalance_epoch": int(self.plan.rebalance_epoch),
            "coefficients": {"sec_per_nnz": c.sec_per_nnz,
                             "sec_per_slot": c.sec_per_slot,
                             "sec_fixed": c.sec_fixed},
            "per_mode": per_mode,
            "events": list(self.schedule_events),
        }

    def exchange_report(self, *, measure: bool = True) -> dict:
        """Modelled — and, with ``measure``, counted — per-device exchange
        bytes for one ALS sweep under the resolved
        :class:`~repro_torch.comm.ExchangeSpec`. Measuring runs each mode's
        MTTKRP once more on the current factors (the state is left as it
        is) and reads the bytes its collectives copied between logical
        devices, so it is a deliberate extra pass — what
        ``launch.decompose --exchange-report`` prints."""
        spec = self.exchange_spec
        report = {
            "spec": {"variant": spec.variant, "merge": spec.merge,
                     "chunk_rows": spec.chunk_rows,
                     "wire_dtype": spec.wire_dtype},
            "modelled": comm.modelled_exchange_bytes(
                self.plan, self.config.rank, wire_dtype=spec.wire_dtype),
        }
        if measure and self.streaming:
            # the streaming updates split the EC across super-shards; the
            # exchange runs once per mode on the accumulated partials, with
            # the collectives the model above counts
            report["counted_skipped"] = (
                "streaming mode: the per-mode count runs the resident "
                "update; modelled bytes above apply unchanged")
            measure = False
        if measure:
            m = self.mesh.num_devices
            per_mode = []               # [mode][device]
            for d, upd in enumerate(self.updates):
                comm.reset_sent_bytes()
                upd.mttkrp_fn(self.dev_arrays[d], self.state.factors)
                per_mode.append(comm.sent_bytes(m))
            comm.reset_sent_bytes()
            report["counted"] = {
                "per_mode": per_mode,
                "sweep_bytes_per_device": [
                    sum(p[k]["total_bytes"] for p in per_mode)
                    for k in range(m)]}
        return report

    def overlap_report(self) -> dict:
        """Streaming budget accounting and per-sweep transfer overlap —
        what ``launch.decompose --stream`` prints.

        ``transfer_s`` is the total time of the window builds (chunk reads,
        the scatter into slots, the pinned copy and the host→device copy on
        the side stream, until its event completed); ``exposed_s`` the part
        the sweep blocked on in ``get``; their difference is the time
        double buffering hid behind compute. ``peak_resident_bytes`` counts
        in-flight prefetches and is the quantity bounded by
        ``runtime.memory_budget``. ``overlap_fraction_steady`` drops the
        first streamed sweep, whose builds scan the store's chunks (the
        one-time work the window spill then caches); None until a second
        streamed sweep exists."""
        if not self.streaming:
            return {"enabled": False}
        snap = self.streamer.stats_snapshot()
        rt = self.config.runtime
        transfer, exposed = snap["transfer_s"], snap["exposed_s"]
        hidden = max(transfer - exposed, 0.0)
        steady = self.stream_events[1:]
        s_transfer = sum(e["transfer_s"] for e in steady)
        s_exposed = sum(e["exposed_s"] for e in steady)
        return {
            "enabled": True,
            "budget_bytes": int(rt.memory_budget),
            "buffers": int(rt.stream_buffers),
            "shards_per_mode": [sp.num_shards for sp in self.stream_plans],
            "shard_bytes_per_mode": [sp.shard_bytes
                                     for sp in self.stream_plans],
            "peak_resident_bytes": int(snap["peak_resident_bytes"]),
            "bytes_streamed": int(snap["bytes_streamed"]),
            "builds": int(snap["builds"]),
            "cold_builds": int(snap["cold_builds"]),
            "transfer_s": transfer,
            "exposed_s": exposed,
            "hidden_s": hidden,
            "overlap_fraction": hidden / transfer if transfer > 0 else None,
            "overlap_fraction_steady":
                (max(s_transfer - s_exposed, 0.0) / s_transfer
                 if s_transfer > 0 else None),
            "spill_hits": int(snap.get("spill_hits", 0)),
            "spill_saves": int(snap.get("spill_saves", 0)),
            "per_sweep": list(self.stream_events),
        }

    def report(self) -> dict:
        """This solver's metrics report: counters/gauges/latency histograms
        plus the ``overlap``/``imbalance``/``exchange``/``stream``
        sections — each a registered provider over the report method of
        that name, value-identical to calling it directly (``exchange``
        with ``measure=False``: a snapshot must not run the MTTKRP)."""
        return self.metrics.report()

    def stream_monitor(self) -> StreamMonitor:
        """Per-window exposed-vs-hidden transfer attribution built from
        the streamer's ``h2d_build``/``h2d_wait`` events."""
        return StreamMonitor(self.events)

    def dump_trace(self, path: str) -> dict:
        """Export every span the process tracer recorded as Chrome-trace
        JSON (load in ``chrome://tracing`` or https://ui.perfetto.dev);
        returns the trace dict. Spans nest run → sweep → mode_update →
        {ec, exchange, h2d_window} (+ plan/compile/checkpoint/rebalance)."""
        return obs_export.dump_chrome_trace(
            path, obs_trace.get_tracer().records())

    def dump_events(self, path: str) -> None:
        """One-shot dump of the solver's structured event log as JSON
        lines (the live twin is ``events.set_sink``)."""
        with open(path, "w") as f:
            for e in self.events.events():
                f.write(json.dumps(e, default=str) + "\n")

    def result(self) -> CPResult:
        """Snapshot the current state as a host-side :class:`CPResult`
        from replica 0 (forces a sync: factors unpadded to global layout,
        fits to floats)."""
        s = self.state
        return CPResult(
            factors=als_mod.unpad_factors(self.plan, s.factors),
            lam=s.lam[0].detach().cpu().numpy(),
            fits=[float(f) for f in s.fits],
            plan=self.plan,
            sweeps=s.sweep,
        )

    def export_snapshot(self, *, version: int = 1, source: str = "solver"):
        """Export the current state as an immutable serving
        :class:`~repro_torch.serve.engine.FactorSnapshot` on the mesh's
        first device — the hand-off from a training/refit session to a
        :class:`~repro_torch.serve.ServingEngine` (forces a sync like
        :meth:`result`)."""
        from repro_torch.serve.engine import FactorSnapshot
        return FactorSnapshot.from_result(self.result(), version=version,
                                          source=source,
                                          device=self.mesh.devices[0])

    def audit(self, *, modes=None) -> list:
        """Run the :mod:`repro_torch.analysis` passes against THIS compiled
        session: the plan rules over the live (possibly rebalanced) plan
        and the recorded-operation audit of each mode's update, run on
        copies of the state, which stays bitwise as it was (no
        ``(nnz, R)`` gathered intermediate in the fused/sorted EC, no host
        synchronisation in the update, bf16 on the wire when asked).
        Returns the findings (empty == clean)."""
        from repro_torch.analysis import check_plan, hlo_audit
        findings = check_plan(self.plan, self.config)
        findings += hlo_audit.audit_solver(self, modes=modes)
        return findings


def compile(plan: CPPlan, config: DecomposeConfig, *,
            mesh: dmttkrp.CPMesh | None = None, device=None) -> CPSolver:
    """Build a :class:`CPSolver` for ``plan`` under ``config``: place every
    mode's shards on the mesh and build the per-mode updates.

    Without a ``mesh``, ``device`` picks one: ``None`` or ``"cuda"`` puts
    logical device k on ``cuda:k`` (raising when fewer cards are visible),
    ``"cpu"`` puts every logical device on the CPU, and a one-device plan
    may name its card (``"cuda:1"``). To share a card among several
    logical devices, pass ``mesh=cp_mesh(M, r, devices=["cuda:0"] * M)``."""
    if config.runtime.trace:
        obs_trace.enable()  # before the span below so it is recorded
    with obs_trace.span("compile", annotate=True):
        validate_plan(plan)  # fail loudly before any device placement
        m, r = plan.num_devices, plan.modes[0].r
        if mesh is None:
            dev = resolve_device(device)
            if dev.type == "cpu" or (m == 1 and dev.index is not None):
                mesh = dmttkrp.cp_mesh(m, r, devices=[dev] * m)
            elif dev.index is not None:
                raise ValueError(
                    f"device={str(dev)!r} names one card for a {m}-device "
                    f"plan; pass mesh=cp_mesh({m}, {r}, devices=[...]) "
                    f"instead")
            else:
                mesh = dmttkrp.cp_mesh(m, r)
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both")
        return CPSolver(plan, config, mesh)
