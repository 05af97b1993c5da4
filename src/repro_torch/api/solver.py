"""Execute layer: ``compile(plan, config) -> CPSolver``.

The resident, untraced subset of the reference package's ``api/solver.py``.
A :class:`CPSolver` owns the mesh, the per-mode shards placed on its
logical devices, the resolved exchange spec, the per-mode ALS updates and
the current :class:`~repro_torch.core.als.ALSState`:

    solver = api.compile(plan, cfg)             # on cuda:0..M-1 unless told
    result = solver.run(iters)                  # CPResult — or solver.sweep()

``compile(plan, cfg, mesh=cp_mesh(4, r, devices=["cuda:0"] * 4))`` places
four logical devices on one card; ``device="cpu"`` runs every logical
device on the CPU. ``load_state`` installs GLOBAL-layout factors and
``lam`` — for instance a reference ``CPResult``'s, or the factors of a
reference checkpoint — onto every replica, so a run carries over between
the packages.

When ``config.schedule.rebalance`` is ``"measure"`` or ``"on"`` the solver
also owns a :class:`~repro_torch.schedule.rebalance.Rebalancer`: every
``schedule.cadence`` sweeps it times each logical device's EC on its device,
recalibrates the cost model, and — in ``"on"`` mode — applies
block-granular nnz migrations between replication-group members as an
incremental plan update that changes no array's shape, then places the
moved modes' shards anew (synchronously: the reference's background
re-placement waits for the streaming slice of the port). Sweeps between
rebalance points read nothing on the host. Epoch streaming, checkpointing
and span tracing raise ``NotImplementedError`` naming their ROADMAP item
when the config asks for them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import comm
from repro_torch.api.config import DecomposeConfig
from repro_torch.core import als as als_mod
from repro_torch.core import mttkrp as dmttkrp
from repro_torch.core.decompose import CPResult
from repro_torch.core.partition import CPPlan, validate_plan
from repro_torch.kernels import _build
from repro_torch.schedule import rebalance as rebalance_mod

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


def _reject_unported(config: DecomposeConfig) -> None:
    """Raise for every config feature the port does not run yet."""
    unported = [
        # the reference caps migrations at the store's streamed-slot budget
        # (store.plan.budget_slot_cap) when a memory budget is set
        (config.schedule.telemetry_enabled
         and config.runtime.memory_budget is not None,
         f"runtime.memory_budget with schedule.rebalance="
         f"{config.schedule.rebalance!r} (the Rebalancer's member caps)",
         "Streaming and the store"),
        (config.runtime.streaming, "runtime.streaming=True",
         "Streaming and the store"),
        (config.runtime.checkpoint_dir is not None, "runtime.checkpoint_dir",
         "Plan cache and checkpoint"),
        (config.runtime.trace, "runtime.trace=True",
         "Observability and tracing"),
    ]
    for asked, what, item in unported:
        if asked:
            raise NotImplementedError(
                f"{what}: not ported to repro_torch yet (ROADMAP, queue 1, "
                f"{item!r})")


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
        _reject_unported(config)
        self.plan = plan
        self.config = config
        self.mesh = mesh
        # The grams, the R×R solve and the fit are held to f32: TF32 keeps
        # about three decimal digits and would drift the fits away from the
        # reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._kernel_kw = config.kernel.mttkrp_kwargs()
        self.exchange_spec = comm.resolve_exchange_spec(config.exchange)
        self.dev_arrays = [dmttkrp.shard_plan_mode(p, mesh)
                           for p in plan.modes]
        self.updates = als_mod.make_sweep_updates(
            plan, mesh, exchange_spec=self.exchange_spec, **self._kernel_kw)
        self.rebalancer = None
        if config.schedule.telemetry_enabled:
            sched = config.schedule
            self.rebalancer = rebalance_mod.Rebalancer(
                imbalance_threshold=sched.imbalance_threshold,
                migration_budget=sched.migration_budget,
                ewma_alpha=sched.ewma_alpha,
                probe_repeats=sched.probe_repeats,
                kernel_kw=self._kernel_kw,
                migrate=sched.migrations_enabled)
        # one dict per rebalance point, as the reference's event log holds
        # them (``launch.decompose`` prints them)
        self.schedule_events: list[dict] = []
        # per rebalance point: the raw probe seconds per mode and device,
        # the kernel launches the probes made (``_build.LAUNCHES`` deltas),
        # and the host seconds of the probes, the apply and the
        # re-placement (kept apart from schedule_events, which stay the
        # reference's values)
        self.rebalance_timings: list[dict] = []
        self.reset()

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

    def load_state(self, factors, lam, *, fits=(), sweep: int = 0,
                   source: str = "warm-start state") -> None:
        """Install GLOBAL-layout ``(I_w, rank)`` factors and ``lam`` as the
        solver's current state on every replica — the warm-start entry that
        carries a run over from the reference package (a ``CPResult``'s
        ``factors`` and ``lam``, or a checkpoint payload's). Validates
        geometry first."""
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
    def sweep(self) -> als_mod.ALSState:
        """One full ALS sweep (all modes). The appended fit is a 0-d device
        tensor (reading it blocks the host)."""
        self.state = als_mod.als_sweep(self.plan, self.mesh, self.dev_arrays,
                                       self.state, self.updates)
        return self.state

    def _synchronize(self) -> None:
        for card in {d for d in self.mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(card)

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
        modes where something moved are placed anew, synchronously, by
        :func:`~repro_torch.core.mttkrp.shard_plan_mode` (which recomputes
        the ``sorted`` descriptors)."""
        if self.rebalancer is None:
            return None
        self._synchronize()
        launched = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        decision = self.rebalancer.observe(self.plan, self.state.factors,
                                           sweep=self.state.sweep,
                                           dev_arrays=self.dev_arrays)
        t1 = time.perf_counter()
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
            t2 = time.perf_counter()
            # Re-place only modes where something actually moved: a skipped
            # migration leaves bit-identical arrays. The MTTKRPFn of each
            # mode update keeps the part it was built with; it reads only
            # mode, rows_max, tile, block_p, r and n_groups, none of which
            # a migration changes (shapes and ownership stay).
            moved = sorted({a["mode"] for a in applied
                            if a.get("moved_nnz", 0) > 0})
            for mode in moved:
                self.dev_arrays[mode] = dmttkrp.shard_plan_mode(
                    self.plan.modes[mode], self.mesh)
            self._synchronize()
            timing.update(apply_s=t2 - t1,
                          replace_s=time.perf_counter() - t2,
                          moved_modes=moved)
            event["applied"] = applied
            event["epoch_after"] = self.plan.rebalance_epoch
        self.schedule_events.append(event)
        self.rebalance_timings.append(timing)
        return decision

    def run(self, iters: int, *, tol: float | None = None,
            verbose: bool = False) -> CPResult:
        """Sweep until ``iters`` total sweeps or the fit plateaus below
        ``tol`` (default: config.runtime.tol). Resumes from the current
        state's sweep counter. Hits a rebalance point every
        ``config.schedule.cadence`` sweeps when the scheduler is enabled,
        except after the last sweep. The plateau test reads each fit on
        the host between sweeps; with ``tol=0`` nothing is read until the
        result (or a rebalance point)."""
        if tol is None:
            tol = self.config.runtime.tol
        cadence = self.config.schedule.cadence
        for _ in range(self.state.sweep, iters):
            state = self.sweep()
            if verbose:
                print(f"sweep {state.sweep}: "
                      f"fit={float(state.fits[-1]):.6f}")
            if self.rebalancer is not None \
                    and state.sweep % cadence == 0 \
                    and state.sweep < iters:
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


def compile(plan: CPPlan, config: DecomposeConfig, *,
            mesh: dmttkrp.CPMesh | None = None, device=None) -> CPSolver:
    """Build a :class:`CPSolver` for ``plan`` under ``config``: place every
    mode's shards on the mesh and build the per-mode updates.

    Without a ``mesh``, ``device`` picks one: ``None`` or ``"cuda"`` puts
    logical device k on ``cuda:k`` (raising when fewer cards are visible),
    ``"cpu"`` puts every logical device on the CPU, and a one-device plan
    may name its card (``"cuda:1"``). To share a card among several
    logical devices, pass ``mesh=cp_mesh(M, r, devices=["cuda:0"] * M)``."""
    validate_plan(plan)  # fail loudly before any device placement
    m, r = plan.num_devices, plan.modes[0].r
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cpu" or (m == 1 and dev.index is not None):
            mesh = dmttkrp.cp_mesh(m, r, devices=[dev] * m)
        elif dev.index is not None:
            raise ValueError(
                f"device={str(dev)!r} names one card for a {m}-device plan;"
                f" pass mesh=cp_mesh({m}, {r}, devices=[...]) instead")
        else:
            mesh = dmttkrp.cp_mesh(m, r)
    elif device is not None:
        raise ValueError("pass a mesh or a device, not both")
    return CPSolver(plan, config, mesh)
