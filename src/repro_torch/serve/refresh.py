"""Incremental model refresh over a grown :class:`TensorStore`.

The counterpart of the reference package's ``serve/refresh.py``; the fit
helpers are the same numpy float64 code. The serving regime the paper motivates is a tensor that keeps growing —
new interactions appended (:func:`repro_torch.store.append_to_store`), detected
by a manifest digest/nnz delta (:meth:`TensorStore.refresh`). Refitting
from scratch on every append wastes almost all of its work: appends touch
a small set of rows per mode, and an ALS solve is row-separable per mode
given the other factors. :func:`incremental_refit` therefore warm-starts
from the published snapshot and, optionally, FREEZES the untouched rows:

after every sweep the factors are blended in the *scaled* representation
``S_w = F_w · λ^{1/N}`` — untouched rows restored from the baseline's
scaled rows, touched rows kept from the sweep — then re-normalized
(``c_w = colnorm(S_w)``, ``F_w = S_w / c_w``, ``λ = Π_w c_w``). The
blend is exact CP renormalization: it changes which rows move, never the
model a given (F, λ) represents.

Fit evaluation helpers live here too: :func:`store_fit` streams the store
once for the exact fit of arbitrary ``(factors, λ)`` (same definition the
solver reports: ``1 - ‖X - X̂‖/‖X‖``, with ``‖X̂‖²`` from the Gram
matrices and ``⟨X, X̂⟩`` accumulated chunk-by-chunk), and
:func:`sample_fit` scores a held-out nnz sample — the cheap regression
probe rolling deploys gate on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.config import DecomposeConfig
from repro_torch.obs import clock
from repro_torch.serve.engine import FactorSnapshot
from repro_torch.store.store import TensorStore

__all__ = ["affected_row_masks", "incremental_refit", "store_fit",
           "sample_fit"]


def affected_row_masks(store: TensorStore, delta: dict
                       ) -> list[np.ndarray]:
    """Per-mode boolean masks (``(I_w,)``) of rows touched by the append
    described by a :meth:`TensorStore.refresh` delta — the rows an
    incremental refit lets move."""
    masks = []
    for w, rows in enumerate(store.appended_mode_rows(delta["old_nnz"])):
        m = np.zeros(store.shape[w], bool)
        m[rows] = True
        masks.append(m)
    return masks


def _model_norm_sq(factors: list[np.ndarray], lam: np.ndarray) -> float:
    """``‖X̂‖² = λᵀ (⊛_w F_wᵀF_w) λ`` — exact, no tensor data needed."""
    lam = np.asarray(lam, np.float64)
    had = np.outer(lam, lam)
    for f in factors:
        f = np.asarray(f, np.float64)
        had *= f.T @ f
    return float(had.sum())


def _model_at(factors: list[np.ndarray], lam: np.ndarray,
              ind: np.ndarray) -> np.ndarray:
    acc = np.ones((ind.shape[0], lam.shape[0]), np.float64)
    for w, f in enumerate(factors):
        acc *= np.asarray(f, np.float64)[ind[:, w]]
    return acc @ np.asarray(lam, np.float64)


def store_fit(factors: list[np.ndarray], lam: np.ndarray,
              store: TensorStore) -> float:
    """Exact fit of ``(factors, λ)`` on ``store``: one streaming pass
    (O(chunk) memory), same definition as the solver's per-sweep fit —
    comparable across a warm-start refit and a from-scratch refit."""
    norm_x_sq = float(store.manifest["values_sumsq"])
    inner = 0.0
    for ind, val in store.iter_chunks():
        inner += float(val.astype(np.float64) @ _model_at(factors, lam, ind))
    resid_sq = max(norm_x_sq - 2.0 * inner
                   + _model_norm_sq(factors, lam), 0.0)
    return 1.0 - float(np.sqrt(resid_sq) / np.sqrt(norm_x_sq))


def sample_fit(factors: list[np.ndarray], lam: np.ndarray,
               store: TensorStore, *, sample_nnz: int = 4096,
               seed: int = 0) -> float:
    """Held-out-sample fit proxy: relative residual over ``sample_nnz``
    uniformly sampled stored nonzeros, ``1 - ‖x_s - x̂_s‖/‖x_s‖``. Cheaper
    than :func:`store_fit` by reading only the sampled chunks; only
    comparable against the SAME sample (same store nnz + seed) — which is
    how rolling deploys use it, scoring the incumbent and the candidate on
    one draw."""
    rng = np.random.default_rng(seed)
    n = min(int(sample_nnz), store.nnz)
    rows = np.sort(rng.choice(store.nnz, size=n, replace=False))
    chunk_of = rows // store.chunk_nnz
    x = np.empty(n, np.float64)
    xhat = np.empty(n, np.float64)
    for c in np.unique(chunk_of):
        sel = chunk_of == c
        lo, _ = store.chunk_bounds(int(c))
        ind, val = store.read_chunk(int(c))
        local = rows[sel] - lo
        x[sel] = val[local]
        xhat[sel] = _model_at(factors, lam, ind[local])
    nx = float(np.linalg.norm(x))
    if nx == 0.0:
        return 0.0
    return 1.0 - float(np.linalg.norm(x - xhat) / nx)


def _freeze_blend(factors: list[np.ndarray], lam: np.ndarray,
                  base_scaled: list[np.ndarray],
                  masks: list[np.ndarray]
                  ) -> tuple[list[np.ndarray], np.ndarray]:
    """Restore untouched rows from the baseline in scaled representation,
    then re-normalize columns — exact CP renormalization (see module
    docstring)."""
    n = len(factors)
    scale = np.asarray(lam, np.float64) ** (1.0 / n)
    out_f, colnorms = [], []
    for w, f in enumerate(factors):
        s = np.asarray(f, np.float64) * scale
        s[~masks[w]] = base_scaled[w][~masks[w]]
        c = np.linalg.norm(s, axis=0)
        c = np.where(c > 0, c, 1.0)
        out_f.append((s / c).astype(np.float32))
        colnorms.append(c)
    lam_new = np.ones_like(colnorms[0])
    for c in colnorms:
        lam_new *= c
    return out_f, lam_new.astype(np.float32)


def incremental_refit(store: TensorStore, config: DecomposeConfig,
                      base: FactorSnapshot, *, sweeps: int = 4,
                      masks: list[np.ndarray] | None = None,
                      plan_cache: str | None = None
                      ) -> tuple[FactorSnapshot, dict]:
    """Warm-start refit of ``base`` on the (already refreshed) ``store``.

    Plans the grown store (plan-from-stats — the layout follows the new
    histograms), compiles a solver, installs the snapshot's factors via
    :meth:`CPSolver.load_state` (which validates rank/shape), and runs
    ``sweeps`` ALS sweeps. With ``masks`` given, rows outside the masks
    are frozen to the baseline after every sweep (see module docstring);
    without masks this is a plain warm-start refit. Returns the candidate
    snapshot (version ``base.version + 1``, exact :func:`store_fit`
    attached, on ``base``'s device) plus an info dict — publication is the
    caller's decision (:meth:`CPService.refresh` validates before
    swapping). The solver runs on ``base``'s device (on the cards
    ``cuda:0..M-1`` when the plan spans M > 1); ``info["seconds"]`` splits the
    refit's host time into plan, compile (shard placement), sweeps,
    freeze-blend and store fit.
    """
    from repro_torch import api
    from repro_torch.core.als import unpad_factors
    seconds = {"plan": 0.0, "compile": 0.0, "sweeps": 0.0,
               "freeze_blend": 0.0, "store_fit": 0.0}
    t0 = clock.now()
    plan = api.plan(store, config, cache_dir=plan_cache, device=base.device)
    seconds["plan"] = clock.now() - t0
    # the snapshot's own card for a one-device plan; a plan over several
    # cards is placed on cuda:0..M-1
    device = base.device if base.device.type == "cpu" or \
        plan.num_devices == 1 else None
    info: dict = {
        "sweeps": int(sweeps),
        "frozen": masks is not None,
        "affected_rows": ([int(m.sum()) for m in masks]
                          if masks is not None else None),
        "affected_fraction": ([float(m.mean()) for m in masks]
                              if masks is not None else None),
    }
    base_factors, base_lam = base.host_factors(), base.host_lam()
    base_scaled = None
    if masks is not None:
        scale = np.asarray(base_lam, np.float64) ** (1.0 / len(base.shape))
        base_scaled = [np.asarray(f, np.float64) * scale
                       for f in base_factors]
    t0 = clock.now()
    with api.compile(plan, config, device=device) as solver:
        solver.load_state(base_factors, base_lam,
                          source=f"serving snapshot v{base.version}")
        seconds["compile"] = clock.now() - t0
        fits = []
        for _ in range(sweeps):
            t0 = clock.now()
            state = solver.sweep()
            fits.append(float(state.fits[-1]))
            seconds["sweeps"] += clock.now() - t0
            if masks is not None:
                # blend on host, re-install: per-sweep sync — fine for a
                # background refit whose cost ceiling is the from-scratch
                # refit it replaces
                t0 = clock.now()
                f_new, lam_new = _freeze_blend(
                    unpad_factors(solver.plan, state.factors),
                    state.lam[0].cpu().numpy(), base_scaled, masks)
                solver.load_state(f_new, lam_new, fits=fits,
                                  sweep=state.sweep,
                                  source="freeze-blend state")
                seconds["freeze_blend"] += clock.now() - t0
        result = solver.result()
    t0 = clock.now()
    fit = store_fit(result.factors, result.lam, store)
    seconds["store_fit"] = clock.now() - t0
    info["sweep_fits"] = fits
    info["fit"] = fit
    info["seconds"] = seconds
    snap = FactorSnapshot.from_arrays(
        result.factors, result.lam, version=base.version + 1, fit=fit,
        source=f"incremental refit of v{base.version} "
               f"(store nnz {store.nnz})", device=base.device)
    return snap, info
