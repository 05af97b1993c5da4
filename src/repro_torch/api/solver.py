"""Execute layer: ``compile(plan, config) -> CPSolver``.

The one-device, resident, untraced subset of the reference package's
``api/solver.py``. A :class:`CPSolver` owns the per-mode shards placed on
its device, the per-mode ALS updates and the current
:class:`~repro_torch.core.als.ALSState`:

    solver = api.compile(plan, cfg)             # on "cuda" unless told
    result = solver.run(iters)                  # CPResult — or solver.sweep()

``load_state`` installs GLOBAL-layout factors and ``lam`` — for instance a
reference ``CPResult``'s, or the factors of a reference checkpoint — so a
run carries over between the packages. The rebalancer, epoch streaming,
checkpointing and span tracing raise ``NotImplementedError`` naming their
ROADMAP item when the config asks for them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.config import DecomposeConfig
from repro_torch.core import als as als_mod
from repro_torch.core import mttkrp as dmttkrp
from repro_torch.core.decompose import CPResult
from repro_torch.core.partition import CPPlan, validate_plan

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
        (config.schedule.telemetry_enabled,
         f"schedule.rebalance={config.schedule.rebalance!r}",
         "Rebalancer"),
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
    """A compiled CP-ALS session on one device: shards + per-mode updates +
    current :class:`~repro_torch.core.als.ALSState`."""

    def __init__(self, plan: CPPlan, config: DecomposeConfig, device=None):
        _reject_unported(config)
        self.plan = plan
        self.config = config
        self.device = resolve_device(device)
        # The grams, the R×R solve and the fit are held to f32: TF32 keeps
        # about three decimal digits and would drift the fits away from the
        # reference's.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._kernel_kw = config.kernel.mttkrp_kwargs()
        self.dev_arrays = [dmttkrp.shard_plan_mode(p, self.device)
                           for p in plan.modes]
        self.updates = als_mod.make_sweep_updates(plan, **self._kernel_kw)
        self.reset()

    # -- state lifecycle ---------------------------------------------------
    def reset(self) -> None:
        """(Re)initialize factors from the config seed; sweep counter to 0."""
        rank = self.config.rank
        factors = als_mod.init_factors(self.plan, rank,
                                       seed=self.config.runtime.seed,
                                       device=self.device)
        grams = [f.T @ f for f in factors]
        self.state = als_mod.ALSState(
            factors=factors, lam=torch.ones(rank, device=self.device),
            grams=grams)

    def load_state(self, factors, lam, *, fits=(), sweep: int = 0,
                   source: str = "warm-start state") -> None:
        """Install GLOBAL-layout ``(I_w, rank)`` factors and ``lam`` as the
        solver's current state — the warm-start entry that carries a run
        over from the reference package (a ``CPResult``'s ``factors`` and
        ``lam``, or a checkpoint payload's). Validates geometry first."""
        rank = self.config.rank
        validate_factor_payload(factors, lam, shape=self.plan.shape,
                                rank=rank, source=source)
        padded = []
        for w, fg in enumerate(factors):
            fp = np.zeros((self.plan.modes[w].padded_rows, rank), np.float32)
            fp[self.plan.global_to_padded[w]] = fg
            padded.append(torch.from_numpy(fp).to(self.device))
        grams = [f.T @ f for f in padded]
        self.state = als_mod.ALSState(
            factors=padded,
            lam=torch.tensor(np.asarray(lam), dtype=torch.float32,
                             device=self.device),
            grams=grams, sweep=sweep, fits=list(fits))

    # -- execution ---------------------------------------------------------
    def sweep(self) -> als_mod.ALSState:
        """One full ALS sweep (all modes). The appended fit is a 0-d device
        tensor (reading it blocks the host)."""
        self.state = als_mod.als_sweep(self.plan, self.dev_arrays, self.state,
                                       self.updates)
        return self.state

    def run(self, iters: int, *, tol: float | None = None,
            verbose: bool = False) -> CPResult:
        """Sweep until ``iters`` total sweeps or the fit plateaus below
        ``tol`` (default: config.runtime.tol). Resumes from the current
        state's sweep counter. The plateau test reads each fit on the host
        between sweeps; with ``tol=0`` nothing is read until the result."""
        if tol is None:
            tol = self.config.runtime.tol
        for _ in range(self.state.sweep, iters):
            state = self.sweep()
            if verbose:
                print(f"sweep {state.sweep}: "
                      f"fit={float(state.fits[-1]):.6f}")
            if tol > 0 and len(state.fits) >= 2 and \
                    abs(float(state.fits[-1])
                        - float(state.fits[-2])) < tol:
                break
        return self.result()

    def result(self) -> CPResult:
        """Snapshot the current state as a host-side :class:`CPResult`
        (forces a sync: factors unpadded to global layout, fits to floats)."""
        s = self.state
        return CPResult(
            factors=als_mod.unpad_factors(self.plan, s.factors),
            lam=s.lam.detach().cpu().numpy(),
            fits=[float(f) for f in s.fits],
            plan=self.plan,
            sweeps=s.sweep,
        )


def compile(plan: CPPlan, config: DecomposeConfig, *,
            device=None) -> CPSolver:
    """Build a :class:`CPSolver` for ``plan`` under ``config`` on ``device``
    (default ``"cuda"``; raises when no card is present): place every mode's
    shards and build the per-mode updates."""
    validate_plan(plan)  # fail loudly before any device placement
    return CPSolver(plan, config, device)
