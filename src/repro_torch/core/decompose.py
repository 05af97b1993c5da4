"""Legacy entry point: CP decomposition of a sparse tensor in one call.

The counterpart of the reference package's ``core/decompose.py``.

.. deprecated::
    ``cp_decompose`` is a thin shim over the staged public API in
    :mod:`repro_torch.api` — prefer::

        import repro_torch.api as api
        cfg    = api.DecomposeConfig(rank=32)
        solver = api.compile(api.plan(tensor, cfg), cfg)
        result = solver.run(iters=10)

    which separates preprocessing (reusable, cacheable, serializable) from
    execution instead of repartitioning the tensor on every invocation.

:class:`CPResult` (with its coordinate check) remains the canonical
host-side result container for both paths.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.coo import SparseTensor
from repro_torch.core.partition import CPPlan, Strategy

__all__ = ["CPResult", "cp_decompose", "validate_coords"]


def validate_coords(indices: np.ndarray, shape: tuple[int, ...], *,
                    what: str = "coordinate") -> np.ndarray:
    """Bounds-check a ``(k, nmodes)`` coordinate batch against ``shape``.

    Numpy fancy indexing wraps negatives and only faults past ``-I_w``, so
    an unvalidated bad coordinate silently scores the wrong row. Raises
    ``IndexError`` naming the offending mode and row; returns the batch as
    a contiguous int64 array."""
    ind = np.asarray(indices)
    if ind.ndim != 2 or ind.shape[1] != len(shape):
        raise ValueError(f"{what}s must be (k, {len(shape)}), "
                         f"got shape {tuple(ind.shape)}")
    ind = ind.astype(np.int64, copy=False)
    for w, size in enumerate(shape):
        col = ind[:, w]
        bad = (col < 0) | (col >= size)
        if bad.any():
            row = int(np.flatnonzero(bad)[0])
            raise IndexError(
                f"mode {w}: {what} {int(col[row])} at row {row} is out of "
                f"range [0, {size})")
    return ind


@dataclasses.dataclass
class CPResult:
    factors: list[np.ndarray]     # global layout (I_w, R)
    lam: np.ndarray               # (R,)
    fits: list[float]
    plan: CPPlan
    sweeps: int

    def reconstruct_at(self, indices: np.ndarray) -> np.ndarray:
        """Model values at the given coordinates (nnz, N) — for evaluation:
        ``x̂[i] = Σ_r λ_r · Π_w F_w[indices[i, w], r]``. Coordinates are
        bounds-checked per mode (``IndexError`` on any out-of-range row)."""
        shape = tuple(int(f.shape[0]) for f in self.factors)
        indices = validate_coords(indices, shape)
        acc = np.ones((indices.shape[0], self.lam.shape[0]), np.float64)
        for w, f in enumerate(self.factors):
            acc *= np.asarray(f, np.float64)[indices[:, w]]
        return acc @ np.asarray(self.lam, np.float64)


def cp_decompose(
    tensor: SparseTensor,
    rank: int = 32,
    *,
    num_devices: int | None = None,
    mesh=None,
    device=None,
    strategy: Strategy = "amped_cdf",
    replication: int | None = None,
    iters: int = 10,
    tol: float = 1e-5,
    seed: int = 0,
    use_kernel: bool = False,
    kernel_variant: str | None = None,
    num_buffers: int | None = None,
    autotune: bool = False,
    ring: bool = True,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    verbose: bool = False,
) -> CPResult:
    """Deprecated one-shot CP-ALS (see module docstring for the replacement).

    Maps its kwargs onto a :class:`repro_torch.api.DecomposeConfig` and runs
    the plan/compile/execute pipeline — plan, compile, ``restore`` when
    ``resume`` and a ``checkpoint_dir`` are given, run; results are those
    of the staged API with the same seed, bit for bit. It runs on the card
    unless ``device="cpu"``, or on ``mesh`` (a
    :class:`~repro_torch.core.mttkrp.CPMesh`) when one is passed; without
    ``num_devices`` it is the mesh's device count, else that of
    :func:`repro_torch.api.planning.resolve_num_devices`.
    """
    warnings.warn(
        "cp_decompose() is deprecated; use repro_torch.api "
        "(plan/compile/execute) instead", DeprecationWarning, stacklevel=2)
    from repro_torch import api
    from repro_torch.api.planning import resolve_num_devices

    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if num_devices is None:
        num_devices = mesh.num_devices if mesh is not None else \
            resolve_num_devices(api.DecomposeConfig(), device=device)

    cfg = api.DecomposeConfig.from_legacy_kwargs(
        rank=rank, num_devices=num_devices, strategy=strategy,
        replication=replication, tol=tol, seed=seed, use_kernel=use_kernel,
        kernel_variant=kernel_variant, num_buffers=num_buffers,
        autotune=autotune, ring=ring, checkpoint_dir=checkpoint_dir)

    plan = api.plan(tensor, cfg, device=device if mesh is None
                    else mesh.devices[0])
    solver = api.compile(plan, cfg, mesh=mesh, device=device)
    try:
        if resume and checkpoint_dir is not None:
            solver.restore()
        return solver.run(iters, verbose=verbose)
    finally:
        solver.close()
