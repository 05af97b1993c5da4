"""Baselines the paper compares against (§5.1.4, Figures 5–6).

The counterpart of the reference package's ``core/baselines.py``:

* ``blco_like_streaming`` — BLCO's out-of-memory model: the whole tensor
  lives in host memory and is streamed chunk by chunk through a SINGLE
  device, accumulating into the full output factor. (The *algorithmic
  structure* — one device, a host-to-device copy per chunk — not BLCO's
  linearized format.) Its EC is the plain
  :func:`~repro_torch.kernels.ref.ec_rows_ref`, as the reference's is.

* ``equal_nnz`` partitioning — the Fig. 6 baseline — is not here: it is the
  ``strategy="equal_nnz"`` (replication r=m) path of the main
  implementation.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.coo import SparseTensor
from repro_torch.kernels.ref import ec_rows_ref
from repro_torch.obs import clock

__all__ = ["blco_like_streaming"]


def blco_like_streaming(
    t: SparseTensor,
    factors: Sequence[torch.Tensor],   # global layout (I_w, R)
    mode: int,
    *,
    chunk: int = 1 << 16,
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Single-device MTTKRP with host→device streaming. Returns (output
    factor (I_mode, R) on ``device``, timing dict).

    ``device`` is the card unless the caller passes ``"cpu"`` (no card
    raises); the factors are moved there once. The tensor is sorted by
    ``mode`` on the host and cut into chunks of ``chunk`` nonzeros, the
    last padded with zero values. Per chunk, ``h2d_s`` times the copies of
    its coordinates, values and output rows (pageable host memory, then a
    synchronise), and ``ec_s`` the gather, the EC and the accumulation into
    the output: on the card with CUDA events around that work, on the CPU
    with the host clock. ``chunks`` is the chunk count."""
    from repro_torch.api.solver import resolve_device
    dev = resolve_device(device)
    n = t.nmodes
    rank = factors[0].shape[1]
    rows_out = t.shape[mode]
    facs = [f.to(dev) for f in factors]

    srt = t.sorted_by_mode(mode)
    nnz = srt.nnz
    nchunks = max(1, -(-nnz // chunk))

    def consume(out, idx, val, rows):
        gathered = [facs[w].index_select(0, idx[:, w])
                    for w in range(n) if w != mode]
        return out + ec_rows_ref(val, gathered, rows, rows_out)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = torch.zeros((rows_out, rank), dtype=torch.float32, device=dev)
    h2d_time = 0.0
    ec_time = 0.0
    for c in range(nchunks):
        lo, hi = c * chunk, min((c + 1) * chunk, nnz)
        pad = chunk - (hi - lo)
        idx = np.pad(srt.indices[lo:hi], ((0, pad), (0, 0)))
        val = np.pad(srt.values[lo:hi], (0, pad))
        rows = idx[:, mode]
        sync()
        t0 = clock.now()
        idx_d = torch.from_numpy(idx).to(dev)
        val_d = torch.from_numpy(val).to(dev)
        rows_d = torch.from_numpy(rows.astype(np.int32)).to(dev)
        sync()
        t1 = clock.now()
        h2d_time += t1 - t0
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = consume(out, idx_d, val_d, rows_d)
            end.record(stream)
            end.synchronize()
            ec_time += start.elapsed_time(end) / 1e3
        else:
            out = consume(out, idx_d, val_d, rows_d)
            ec_time += clock.now() - t1
    return out, {"h2d_s": h2d_time, "ec_s": ec_time, "chunks": nchunks}
