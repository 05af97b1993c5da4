"""CP-ALS on top of the distributed MTTKRP (paper Algorithm 1 + §2.1.4).

The counterpart of the reference package's ``core/als.py``. One ALS sweep
updates every mode in sequence:

    M_d   = MTTKRP(X_(d), {F_w}_{w≠d})          (distributed, the paper's core)
    V_d   = ⊛_{w≠d} (F_wᵀ F_w)                  (R×R Hadamard of grams)
    F_d   = M_d V_d⁺,  λ = colnorms(F_d),  F_d /= λ

with the fit computed from the norm identity (no residual tensor is ever
materialised):

    ||X̂||² = λᵀ (⊛_w G_w) λ,   ⟨X, X̂⟩ = Σ (M_last ⊛ F_last) λ

Grams are cached across modes; only the updated mode's gram is recomputed.

Replicated state, as in the reference: every logical device of the mesh
holds its own replica of every padded factor, gram and ``lam`` (a list in
linear device order), and the solve, the normalisation, the gram and the
fit run once on each replica, as XLA runs a replicated computation on each
device. The replicas stay bitwise identical because each one starts from
the same bits and receives the same bits from the exchange (every block,
the own one included, takes the same wire round trip).

Nothing in a sweep reads a result on the host: the fit it appends is a 0-d
device tensor, read only when the caller asks. (On CUDA,
``torch.linalg.eigh`` synchronises once per replica and mode for its own
error check, so the host waits for each mode's MTTKRP before it enqueues
that mode's solve.)

Factor matrices live in the padded ownership layout of their mode (see
core/partition.py); padding rows are zero and stay zero.

Epoch streaming (:func:`als_streaming_sweep`) runs the same sweep over an
out-of-core plan's super-shards: per mode, each window's partial EC is
folded into a zero accumulator, then merge, exchange and solve run once.
Its fits and factors are bitwise those of :func:`als_sweep` on the
resident shards of the same plan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import mttkrp as dmttkrp
from repro_torch.core.partition import CPPlan

__all__ = ["ALSState", "init_factors", "replicate", "make_mode_update",
           "make_sweep_updates", "als_sweep", "fit_from_stats",
           "unpad_factors", "StreamingModeUpdate",
           "make_streaming_mode_update", "make_streaming_sweep_updates",
           "als_streaming_sweep"]


@dataclasses.dataclass
class ALSState:
    factors: list[list[torch.Tensor]]  # [mode][device], padded layout
    lam: list[torch.Tensor]            # [device], (R,) column scales
    grams: list[list[torch.Tensor]]    # [mode][device], (R, R) = F_wᵀ F_w
    sweep: int = 0
    # Replica 0's fit per sweep: 0-d device tensors (or floats after a host
    # read) — reading one blocks.
    fits: list = dataclasses.field(default_factory=list)
    # Every replica's fit of the latest sweep (all hold the same bits).
    replica_fits: list = dataclasses.field(default_factory=list)


def init_factors(plan: CPPlan, rank: int, seed: int = 0, *,
                 devices) -> list[list[torch.Tensor]]:
    """Random factors in padded layout, one replica on each of ``devices``
    (a mesh's device list); padding rows exactly zero. The same numpy draw
    as the reference (als.py:53-63), so both packages start from the same
    factors. Replicas never share storage, even on one device."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(plan.nmodes):
        rows = plan.modes[w].padded_rows
        f = np.zeros((rows, rank), np.float32)
        g2p = plan.global_to_padded[w]
        f[g2p] = rng.uniform(0.1, 1.0, size=(plan.shape[w], rank)).astype(np.float32)
        out.append(replicate(f, devices))
    return out


def replicate(x: np.ndarray, devices) -> list[torch.Tensor]:
    """One copy of host array ``x`` on each of ``devices``."""
    return [torch.tensor(x, device=d) for d in devices]


def _pinv_psd(v: torch.Tensor, rcond: float = 1e-8) -> torch.Tensor:
    """Pseudo-inverse of a symmetric PSD R×R matrix via eigh (stable, tiny)."""
    w, u = torch.linalg.eigh(v)
    w_inv = torch.where(w > rcond * w.abs().max(), 1.0 / w,
                        torch.zeros_like(w))
    return (u * w_inv[None, :]) @ u.T


def _solve(m: torch.Tensor, f_old: torch.Tensor, grams, mode: int):
    """One replica's ``F_d = M_d V_d⁺`` (written into ``f_old``), its
    column norms ``lam`` (F_d is divided by them) and its gram."""
    v = functools.reduce(
        lambda a, b: a * b,
        [g for w, g in enumerate(grams) if w != mode])    # (R, R)
    f_new = torch.matmul(m, _pinv_psd(v), out=f_old)
    lam = torch.linalg.vector_norm(f_new, dim=0)
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    f_new.div_(lam[None, :])
    return f_new, f_new.T @ f_new, lam


def make_mode_update(plan: CPPlan, mode: int, mesh, **mttkrp_kw) -> Callable:
    """``(F_d_old, dev_arrays, other_factors, grams) -> (F_d, G_d, M_d,
    lam)``, every argument and result replicated (a per-device list).

    ``other_factors`` is the factor list *without* mode ``mode``; the old
    output-mode factor is passed separately because the update overwrites
    it in place: the reference donates that buffer to XLA (als.py:101), and
    here each replica of ``F_d`` is written into its ``F_d_old``'s storage,
    saving one padded_d×R allocation per replica and update. Do not read a
    factor of an ``ALSState`` from before the sweep that replaced it. The
    returned update's ``mttkrp_fn`` is its
    :class:`~repro_torch.core.mttkrp.MTTKRPFn`.
    """
    mfn = dmttkrp.make_mttkrp_fn(plan.modes[mode], mesh, **mttkrp_kw)

    def update(f_old, dev, other_factors, grams):
        factors = list(other_factors[:mode]) + [f_old] + \
            list(other_factors[mode:])
        ms = mfn(dev, factors)                  # per device (padded_d, R)
        # the EC ignores the output mode's factor, so F_d_old is free now
        solved = [_solve(m, f_old[k], [g[k] for g in grams], mode)
                  for k, m in enumerate(ms)]
        f_new, g_new, lam = (list(x) for x in zip(*solved))
        return f_new, g_new, ms, lam

    update.mttkrp_fn = mfn
    return update


def make_sweep_updates(plan: CPPlan, mesh, **mttkrp_kw) -> list[Callable]:
    """One :func:`make_mode_update` per mode, sharing ``mttkrp_kw`` (kernel
    variant, num_buffers, ``exchange_spec`` — the
    :class:`repro_torch.comm.ExchangeSpec` selecting gather/merge schedule,
    overlap chunking and wire dtype — or the legacy ``ring`` flag). Build
    once, pass to every :func:`als_sweep` — this is what
    :class:`repro_torch.api.CPSolver` owns."""
    return [make_mode_update(plan, d, mesh, **mttkrp_kw)
            for d in range(plan.nmodes)]


# -- epoch streaming: super-shard partial accumulation ------------------------

_STREAM_KERNEL_KEYS = ("use_kernel", "variant", "num_buffers")
_STREAM_EXCHANGE_KEYS = ("exchange_spec",)


@dataclasses.dataclass(frozen=True)
class StreamingModeUpdate:
    """The three steps one mode's epoch-streaming update runs:
    ``init_acc()`` → ``accumulate(acc, dev_arrays, factors)`` per
    super-shard → ``finish(f_old, acc, other_factors, grams)``. While
    ``accumulate`` computes super-shard k, the streamer's background thread
    places super-shard k+1."""

    init_acc: Callable[[], list]
    accumulate: Callable
    finish: Callable


def make_streaming_mode_update(plan: CPPlan, mode: int, mesh, *, rank: int,
                               **mttkrp_kw) -> StreamingModeUpdate:
    """Streaming twin of :func:`make_mode_update`: the MTTKRP is split into
    a per-super-shard partial accumulation (EC only, no exchange) and a
    one-shot finish (merge + exchange + solve). Folding each super-shard's
    masked EC into a zero accumulator reproduces the resident partial bit
    for bit (windows split at tile boundaries: every output row is computed
    by exactly one super-shard), so fits match the resident path bitwise.
    Takes the same ``mttkrp_kw`` as :func:`make_mode_update`."""
    unknown = set(mttkrp_kw) - set(_STREAM_KERNEL_KEYS
                                   + _STREAM_EXCHANGE_KEYS)
    if unknown:
        raise TypeError(f"unknown mttkrp kwargs for streaming update: "
                        f"{sorted(unknown)}")
    kernel_kw = {k: v for k, v in mttkrp_kw.items()
                 if k in _STREAM_KERNEL_KEYS}
    part = plan.modes[mode]
    pfn = dmttkrp.make_partial_mttkrp_fn(part, mesh, **kernel_kw)
    ffn = dmttkrp.make_streaming_finish_fn(
        part, mesh, exchange_spec=mttkrp_kw.get("exchange_spec"))

    def init_acc():
        return dmttkrp.zero_partials(part, mesh, rank)

    def finish(f_old, acc, other_factors, grams):
        ms = ffn(acc)                           # per device (padded_d, R)
        solved = [_solve(m, f_old[k], [g[k] for g in grams], mode)
                  for k, m in enumerate(ms)]
        f_new, g_new, lam = (list(x) for x in zip(*solved))
        return f_new, g_new, ms, lam

    return StreamingModeUpdate(init_acc=init_acc, accumulate=pfn,
                               finish=finish)


def make_streaming_sweep_updates(plan: CPPlan, mesh, *, rank: int,
                                 **mttkrp_kw) -> list[StreamingModeUpdate]:
    """One :func:`make_streaming_mode_update` per mode — what
    :class:`repro_torch.api.CPSolver` owns in streaming mode."""
    return [make_streaming_mode_update(plan, d, mesh, rank=rank, **mttkrp_kw)
            for d in range(plan.nmodes)]


def _barrier(tensors) -> None:
    """Wait until the work that writes ``tensors`` (one per logical
    device) has run on their devices' current streams."""
    for s in {torch.cuda.current_stream(t.device) for t in tensors
              if t.device.type == "cuda"}:
        s.synchronize()


def als_streaming_sweep(plan: CPPlan, mesh, streamer, stream_plans,
                        state: ALSState,
                        updates: Sequence[StreamingModeUpdate]) -> ALSState:
    """One full epoch-streaming sweep: per mode, iterate that mode's
    super-shards through the double-buffered streamer, folding each
    partial MTTKRP into the accumulator, then merge/exchange/solve once.
    Fits and factors are bitwise those of :func:`als_sweep` on the
    resident shards.

    ``streamer.get(d, k)`` returns super-shard k's arrays and dispatches
    k+1's transfer in the background; the enqueued ``accumulate`` is what
    hides it. After each window the host waits for its accumulation (the
    reference's per-window barrier): the next window's compute depends on
    this accumulator anyway, and it keeps the streamer's exposed time
    honest (the time ``get`` blocks is transfer NOT hidden behind compute,
    not host queue-ahead racing the device)."""
    n = plan.nmodes
    factors, grams = list(state.factors), list(state.grams)
    m_last = f_last = lam = None
    for d in range(n):
        upd = updates[d]
        acc = upd.init_acc()
        for k in range(stream_plans[d].num_shards):
            dev = streamer.get(d, k)
            acc = upd.accumulate(acc, dev, factors)
            _barrier(acc)
        others = [factors[w] for w in range(n) if w != d]
        f_d, g_d, m_d, lam = upd.finish(factors[d], acc, others, grams)
        factors[d], grams[d] = f_d, g_d
        m_last, f_last = m_d, f_d
    fits = [fit_from_stats(plan.norm, m_last[k], f_last[k], lam[k],
                           [g[k] for g in grams])
            for k in range(len(lam))]
    return ALSState(factors=factors, lam=lam, grams=grams,
                    sweep=state.sweep + 1, fits=state.fits + [fits[0]],
                    replica_fits=fits)


def fit_from_stats(norm_x: float, m_last, f_last, lam, grams) -> torch.Tensor:
    """fit = 1 - ||X - X̂||_F / ||X||_F via the norm identity, on one
    replica; a 0-d tensor on its device."""
    inner = torch.sum(torch.sum(m_last * f_last, dim=0) * lam)
    gall = functools.reduce(lambda a, b: a * b, grams)
    model_sq = lam @ gall @ lam
    resid_sq = torch.clamp(norm_x ** 2 - 2.0 * inner + model_sq, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x


def als_sweep(plan: CPPlan, mesh, dev_arrays: Sequence, state: ALSState,
              updates: Sequence[Callable] | None = None,
              **mttkrp_kw) -> ALSState:
    """One full sweep over all modes (Algorithm 1). Multi-sweep callers
    pass ``updates`` (from :func:`make_sweep_updates`).

    The fit is appended as a 0-d device tensor and forces a host sync only
    when read (see the module docstring for eigh's own sync). Each mode's
    updated factor overwrites the old one in place (see
    :func:`make_mode_update`)."""
    n = plan.nmodes
    if updates is None:
        updates = make_sweep_updates(plan, mesh, **mttkrp_kw)
    factors, grams = list(state.factors), list(state.grams)
    m_last = f_last = lam = None
    for d in range(n):
        others = [factors[w] for w in range(n) if w != d]
        f_d, g_d, m_d, lam = updates[d](factors[d], dev_arrays[d], others,
                                        grams)
        factors[d], grams[d] = f_d, g_d
        m_last, f_last = m_d, f_d
    fits = [fit_from_stats(plan.norm, m_last[k], f_last[k], lam[k],
                           [g[k] for g in grams])
            for k in range(len(lam))]
    return ALSState(factors=factors, lam=lam, grams=grams,
                    sweep=state.sweep + 1, fits=state.fits + [fits[0]],
                    replica_fits=fits)


def unpad_factors(plan: CPPlan, factors: Sequence[Sequence[torch.Tensor]]
                  ) -> list[np.ndarray]:
    """Padded ownership layout → global row order (I_w, R), on the host,
    from replica 0."""
    return [f[0].detach().cpu().numpy()[plan.global_to_padded[w]]
            for w, f in enumerate(factors)]
