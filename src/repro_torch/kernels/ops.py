"""Kernel-variant dispatch for the MTTKRP EC.

The counterpart of the reference package's ``kernels/ops.py``.
``mttkrp_local`` is the single-device EC used by core/mttkrp.py. Four
interchangeable variants:

  ``ref``      plain PyTorch gather + ``index_add_`` (the semantic oracle)
  ``blocked``  ``index_select`` pre-gather of (nnz, R) input rows + the
               tile-accumulator CUDA kernel (mttkrp_blocked.ec_blocked)
  ``fused``    the factor gather inside the kernel — no gathered
               intermediate (mttkrp_fused.ec_fused)
  ``sorted``   the in-kernel gather + segmented reduction over the
               row-sorted block layout (mttkrp_sorted.ec_sorted; needs
               seg_starts/seg_rows descriptors, see
               core.partition.block_segment_descriptors)

``blocked``, ``fused`` and ``sorted`` equal the slot-order ``ref`` bitwise
on every tile whose run is at most ``_build.CHUNK_BLOCKS`` blocks; a longer
run is summed in a fixed two-level order (per-chunk partials in slot order,
then the chunks in order, ``ref.ec_rows_chunked``), deterministically.
``blocked`` and ``fused`` give the same bits everywhere.

Selection precedence: explicit ``variant=`` argument > ``AMPED_EC_VARIANT``
environment variable > default (``blocked``). ``use_kernel=False`` forces
``ref`` unless a variant is named explicitly.

Dispatch is by the tensors' device: on CPU tensors every variant runs its
kernel's plain PyTorch version; on CUDA tensors it launches the kernel or
raises — there is no fallback.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import SMEM_LIMIT, variant_smem_bytes
from repro_torch.kernels.mttkrp_blocked import ec_blocked
from repro_torch.kernels.mttkrp_fused import ec_fused
from repro_torch.kernels.mttkrp_sorted import ec_sorted

__all__ = ["mttkrp_local", "kernel_args", "resolve_variant",
           "kernel_kwargs_from_config",
           "variant_smem_bytes", "SMEM_LIMIT", "KERNEL_VARIANTS",
           "ENV_VARIANT", "DEFAULT_VARIANT", "DEFAULT_NUM_BUFFERS"]

ENV_VARIANT = "AMPED_EC_VARIANT"
DEFAULT_VARIANT = "blocked"
DEFAULT_NUM_BUFFERS = 2


def resolve_variant(variant: str | None = None, use_kernel: bool = True) -> str:
    """Resolve the EC kernel variant name (see module docstring)."""
    if variant is None:
        if not use_kernel:
            return "ref"
        variant = os.environ.get(ENV_VARIANT, DEFAULT_VARIANT)
    if variant not in KERNEL_VARIANTS:
        raise ValueError(
            f"unknown EC variant {variant!r}; expected one of "
            f"{sorted(KERNEL_VARIANTS)}")
    return variant


def kernel_kwargs_from_config(cfg, *, nmodes: int | None = None,
                              rank: int | None = None, device=None) -> dict:
    """Resolve a :class:`repro_torch.api.KernelConfig`-shaped object
    (``use_kernel``, ``variant``, ``num_buffers``, ``autotune``) into the
    kwargs ``make_mttkrp_fn`` / ``mttkrp_local`` take — including the ring
    depth, with the reference's precedence: explicit ``num_buffers`` >
    the autotuned winner (when ``cfg.autotune`` and the problem key
    ``(nmodes, rank)`` is given; tuned on ``device``, ``None`` being the
    card, and memoized) > :data:`DEFAULT_NUM_BUFFERS`."""
    variant = resolve_variant(getattr(cfg, "variant", None),
                              getattr(cfg, "use_kernel", True))
    num_buffers = getattr(cfg, "num_buffers", None)
    if num_buffers is None and getattr(cfg, "autotune", False) and \
            variant != "ref" and nmodes is not None and rank is not None:
        from repro_torch.kernels import autotune
        num_buffers = autotune.autotune_ec(nmodes, rank, variant=variant,
                                           device=device).num_buffers
    return dict(
        use_kernel=variant != "ref",
        variant=variant,
        num_buffers=DEFAULT_NUM_BUFFERS if num_buffers is None
        else int(num_buffers),
    )


def _mask_unvisited(out: torch.Tensor, tile_mask: torch.Tensor | None,
                    tile: int) -> torch.Tensor:
    if tile_mask is None:
        return out
    # Tiles never visited by a block carry no contribution and must come
    # out 0 — select, don't multiply (NaN * 0 == NaN).
    mask = (tile_mask > 0).repeat_interleave(tile)[:, None]
    return torch.where(mask, out, 0.0)


def kernel_args(variant, indices, values, local_rows, block_to_tile,
                factors, *, mode, tile, seg_starts=None, seg_rows=None):
    """The positional arguments of ``ec_<variant>`` (and of its plain
    version) for one mode's shard, built as ``mttkrp_local`` builds them:
    ``blocked`` gets the ``index_select`` pre-gather of its ``(nnz, R)``
    input rows; ``fused`` and ``sorted`` get the input-mode index columns
    compacted into one ``(nnz, nin)`` array and the factor matrices
    themselves, read in the kernel (no ``(nnz, R)`` intermediate)."""
    in_modes = [w for w in range(len(factors)) if w != mode]
    if variant == "blocked":
        return (values, (local_rows % tile).to(torch.int32), block_to_tile,
                [factors[w].index_select(0, indices[:, w])
                 for w in in_modes])
    # one column at a time: indexing with the list would copy it to the
    # card from pageable memory, a host synchronisation (AH-H002)
    input_indices = torch.stack([indices[:, w] for w in in_modes], dim=1)
    in_factors = [factors[w] for w in in_modes]
    if variant == "fused":
        return (values, (local_rows % tile).to(torch.int32), block_to_tile,
                input_indices, in_factors)
    if variant == "sorted":
        # the descriptors replace the per-slot rows
        if seg_starts is None or seg_rows is None:
            raise ValueError(
                "variant='sorted' needs per-block segment descriptors; "
                "compute them with core.partition.block_segment_descriptors("
                "local_rows, tile=..., block_p=...) and pass "
                "seg_starts=/seg_rows=")
        return (values, seg_starts, seg_rows, block_to_tile, input_indices,
                in_factors)
    raise ValueError(f"EC variant {variant!r} launches no kernel")


def _run_ref(indices, values, local_rows, block_to_tile, factors, *,
             mode, num_rows, tile, block_p, tile_mask, num_buffers,
             seg_starts, seg_rows):
    del block_to_tile, tile, block_p, tile_mask, num_buffers
    del seg_starts, seg_rows
    return _ref.mttkrp_local_ref(indices, values, local_rows, factors, mode,
                                 num_rows)


def _kernel_runner(variant, kernel, takes_num_buffers):
    def run(indices, values, local_rows, block_to_tile, factors, *, mode,
            num_rows, tile, block_p, tile_mask, num_buffers, seg_starts,
            seg_rows):
        args = kernel_args(variant, indices, values, local_rows,
                           block_to_tile, factors, mode=mode, tile=tile,
                           seg_starts=seg_starts, seg_rows=seg_rows)
        extra = dict(num_buffers=num_buffers) if takes_num_buffers else {}
        out = kernel(*args, num_rows=num_rows, tile=tile, block_p=block_p,
                     **extra)
        return _mask_unvisited(out, tile_mask, tile)
    return run


KERNEL_VARIANTS = {
    "ref": _run_ref,
    "blocked": _kernel_runner("blocked", ec_blocked, False),
    "fused": _kernel_runner("fused", ec_fused, True),
    "sorted": _kernel_runner("sorted", ec_sorted, True),
}


def mttkrp_local(
    indices: torch.Tensor,        # (nnz, N) int32, padded layouts
    values: torch.Tensor,         # (nnz,)
    local_rows: torch.Tensor,     # (nnz,) int32 in [0, num_rows)
    block_to_tile: torch.Tensor,  # (nblocks,) int32
    factors: Sequence[torch.Tensor],
    *,
    mode: int,
    num_rows: int,
    tile: int,
    block_p: int,
    use_kernel: bool = True,
    variant: str | None = None,
    num_buffers: int = DEFAULT_NUM_BUFFERS,
    tile_mask: torch.Tensor | None = None,  # (num_rows/tile,) 1=visited
    seg_starts: torch.Tensor | None = None,  # (nblocks, S+1) int32 ("sorted")
    seg_rows: torch.Tensor | None = None,    # (nblocks, S) int32 ("sorted")
) -> torch.Tensor:
    """Local (one-device) EC over this device's shard. Returns
    (num_rows, R) f32."""
    variant = resolve_variant(variant, use_kernel)
    return KERNEL_VARIANTS[variant](
        indices, values, local_rows, block_to_tile, factors,
        mode=mode, num_rows=num_rows, tile=tile, block_p=block_p,
        tile_mask=tile_mask, num_buffers=num_buffers,
        seg_starts=seg_starts, seg_rows=seg_rows)
