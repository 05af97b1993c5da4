"""``pinv_psd``: the ALS solve's pseudo-inverse ``V⁺``, ``V = ⊛ grams``, as
one CUDA kernel on the card's current stream.

It replaces no TPU kernel: the reference pseudo-inverts ``V`` with XLA's
``eigh`` (``src/repro/core/als.py``), and so did the port, through
``torch.linalg.eigh``. On the card that call is cuSOLVER's batched Jacobi,
which synchronises with the host about ten times a call for its own error
and convergence reads; once per replica and mode, the host then waited for
the card to finish the mode's EC and exchange before it could enqueue the
solve. ``pinv_psd_launch`` in ``csrc/pinv_psd.cu`` takes the grams, forms
``V`` in f32 (the bits of ``functools.reduce`` over them), diagonalises it
by cyclic Jacobi in fp64 in one CUDA block, stops on the card, applies the
cut and writes ``V⁺`` in f32; nothing returns to the host. See the source
for what bounds it and the design.

Which version runs follows the device alone (:func:`takes_kernel`): CUDA
tensors take the kernel, at every rank the EC kernels take (up to
:data:`MAX_RANK`, 128) and with up to :data:`MAX_GRAMS` grams, and a card
configuration outside those is refused (``api.compile`` refuses it before
placing anything); CPU tensors take :func:`pinv_psd_plain`, which is the
``eigh`` code the solve ran before the kernel, unchanged, so CPU bits are
as they were.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build

__all__ = ["pinv_psd", "pinv_psd_plain", "takes_kernel", "check_shape",
           "MAX_RANK", "MAX_GRAMS", "MAX_SWEEPS", "RCOND"]

# Mirrors of csrc/pinv_psd.cu: the largest R, every rank the EC kernels
# take (above 64 a second kernel holds A's upper triangle, updated in
# place: see the source); the most grams a launch takes; the Jacobi sweeps
# after which the kernel stops unconverged.
MAX_RANK = _build.MAX_ITEM_RANK
MAX_GRAMS = 8
MAX_SWEEPS = 30
# The solve's cut: eigenvalues at most RCOND · max|w| are dropped.
RCOND = 1e-8

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
             ctypes.c_double, _P, _P, _P]


def check_shape(rank: int, ngrams: int) -> None:
    """Raise unless the kernel takes ``ngrams`` grams of rank ``rank``:
    ``1 <= rank <= MAX_RANK`` and ``1 <= ngrams <= MAX_GRAMS`` (a tensor of
    at most ``MAX_GRAMS + 1`` modes)."""
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"pinv_psd takes R in [1, {MAX_RANK}], got {rank}: "
                         f"on a card the solve's pseudo-inverse is this "
                         f"kernel")
    if not 1 <= ngrams <= MAX_GRAMS:
        raise ValueError(f"pinv_psd takes 1 to {MAX_GRAMS} grams (a tensor "
                         f"of 2 to {MAX_GRAMS + 1} modes), got {ngrams}")


def takes_kernel(device: torch.device, rank: int, ngrams: int) -> bool:
    """Whether the pseudo-inverse of ``ngrams`` grams of rank ``rank`` on
    ``device`` runs as the kernel: on a card, always (raising, by
    :func:`check_shape`, on a shape the kernel does not take: the card has
    no other version); elsewhere never (:func:`pinv_psd_plain`)."""
    if torch.device(device).type != "cuda":
        return False
    check_shape(rank, ngrams)
    return True


def pinv_psd(grams: Sequence[torch.Tensor], rcond: float = RCOND, *,
             sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """``V⁺`` of ``V = grams[0] * grams[1] * ...`` (elementwise, left to
    right in f32), symmetric PSD ``(R, R)`` f32 CUDA tensors on one card,
    by the kernel: an ``(R, R)`` f32 tensor, launched on the card's current
    stream, with no host synchronisation. Eigenvalues ``w <= rcond ·
    max|w|`` are cut to 0, the others inverted. ``sweeps``, a one-element
    int32 tensor on the card, receives the Jacobi sweeps the kernel ran (at
    most :data:`MAX_SWEEPS`; the kernel stops earlier once the off-diagonal
    norm is at most float64's epsilon times ``‖V‖_F``).

    Raises, before any launch, on anything the kernel does not take: no
    grams or more than :data:`MAX_GRAMS`, a tensor that is not a contiguous
    ``(R, R)`` f32 tensor on the first gram's card, R above
    :data:`MAX_RANK`."""
    if not grams:
        check_shape(1, 0)
    g0 = grams[0]
    if not isinstance(g0, torch.Tensor):
        raise TypeError(f"grams[0] must be a torch.Tensor, got {type(g0)}")
    if g0.dim() != 2 or g0.shape[0] != g0.shape[1]:
        raise ValueError(f"grams[0] has shape {tuple(g0.shape)}, expected "
                         f"(R, R)")
    rank, dev = g0.shape[0], g0.device
    check_shape(rank, len(grams))
    for w, g in enumerate(grams):
        _build.require(g, f"grams[{w}]", shape=(rank, rank),
                       dtypes=(torch.float32,), device=dev)
    if sweeps is not None:
        _build.require(sweeps, "sweeps", shape=(1,), dtypes=(torch.int32,),
                       device=dev)
    if dev.type != "cuda":
        raise ValueError(f"pinv_psd runs on cuda tensors, got {dev} "
                         f"(pinv_psd_plain takes the others)")
    out = torch.empty((rank, rank), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(grams))(*[g.data_ptr() for g in grams])
    _build.launch("pinv_psd", "pinv_psd_launch", _ARGTYPES, dev, ptrs,
                  len(grams), rank, float(rcond), out.data_ptr(),
                  None if sweeps is None else sweeps.data_ptr())
    return out


def pinv_psd_plain(v: torch.Tensor, rcond: float = RCOND) -> torch.Tensor:
    """Plain PyTorch version, on any device: ``V⁺`` of the symmetric PSD
    ``v`` through ``torch.linalg.eigh`` in ``v``'s dtype, with the same
    cut. On a card ``eigh`` synchronises with the host."""
    w, u = torch.linalg.eigh(v)
    w_inv = torch.where(w > rcond * w.abs().max(), 1.0 / w,
                        torch.zeros_like(w))
    return (u * w_inv[None, :]) @ u.T
