"""Resolved exchange configuration — the concrete object the stack threads.

The counterpart of the reference package's ``comm/spec.py``.
:class:`repro_torch.api.ExchangeConfig` is user-facing and lazy (``None``
fields mean "resolve later": environment variable, legacy ``ring`` flag);
an :class:`ExchangeSpec` is the fully resolved counterpart that
``core.mttkrp.make_mttkrp_fn`` runs — frozen, hashable, concrete.
``resolve_exchange_spec`` is the single point where one becomes the other.

Not ported: ``expected_hlo_markers``, which states what a lowered XLA
update must contain and has no meaning without HLO.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.comm import collectives

__all__ = ["ExchangeSpec", "resolve_exchange_spec"]

_WIRE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Concrete exchange schedule: gather variant × merge variant ×
    chunking × wire format. ``wire_dtype`` is stored by name so the spec
    stays hashable/JSON-able; :attr:`wire` yields the torch dtype (or None
    for full precision — no casts at all)."""

    variant: str = collectives.DEFAULT_VARIANT       # allgather|ring|overlap
    merge: str = collectives.DEFAULT_MERGE           # psum_scatter|ring_rs
    chunk_rows: int | None = None                    # overlap row-chunk size
    wire_dtype: str = "float32"                      # float32 | bfloat16

    def __post_init__(self):
        if self.variant not in collectives.GATHER_VARIANTS:
            raise ValueError(
                f"exchange variant must be one of "
                f"{sorted(collectives.GATHER_VARIANTS)}, got {self.variant!r}")
        if self.merge not in collectives.MERGE_VARIANTS:
            raise ValueError(
                f"exchange merge must be one of "
                f"{sorted(collectives.MERGE_VARIANTS)}, got {self.merge!r}")
        if self.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"exchange wire_dtype must be one of {_WIRE_DTYPES}, "
                f"got {self.wire_dtype!r}")
        if self.chunk_rows is not None and self.chunk_rows < 1:
            raise ValueError("exchange chunk_rows must be >= 1")
        if self.wire_dtype != "float32" and self.merge == "psum_scatter":
            # the spec names the schedule that actually runs, and the
            # psum_scatter merge does not split wire and accumulation dtypes
            raise ValueError(
                "a reduced-precision wire cannot use the psum_scatter "
                "merge (it would accumulate in the wire dtype, losing the "
                "fp32 merge); use merge='ring_rs' or leave merge unset")

    @property
    def wire(self):
        """The wire dtype as a torch dtype, or None for full precision."""
        if self.wire_dtype == "float32":
            return None
        return getattr(torch, self.wire_dtype)

    def gather_kwargs(self) -> dict:
        """Kwargs for :func:`repro_torch.comm.collectives.all_gather_axes`."""
        return dict(variant=self.variant, chunk_rows=self.chunk_rows,
                    wire_dtype=self.wire)

    def merge_kwargs(self) -> dict:
        """Kwargs for :func:`repro_torch.comm.collectives.merge_partials`."""
        return dict(merge=self.merge, wire_dtype=self.wire)


def resolve_exchange_spec(config=None, *, plan=None, rank: int | None = None,
                          mesh=None) -> ExchangeSpec:
    """Resolve an :class:`repro_torch.api.ExchangeConfig`-shaped object
    (duck-typed: ``ring``, ``variant``, ``merge``, ``chunk_rows``,
    ``wire_dtype``, ``autotune_chunk``) into a concrete
    :class:`ExchangeSpec`. ``None`` is a config with every field unset.

    Precedence per field mirrors ``kernels/ops.py``: explicit config value >
    environment variable (``AMPED_EXCHANGE_VARIANT`` / ``_MERGE``) > legacy
    ``ring`` flag (variant only) > default. With ``autotune_chunk`` and an
    ``overlap`` variant, ``chunk_rows=None`` is filled by the chunk-size
    autotuner (:mod:`repro_torch.comm.autotune`, timed on ``mesh``; needs
    ``plan``, ``rank`` and ``mesh``, as in the reference); otherwise an
    unset ``chunk_rows`` takes :func:`collectives.default_chunk_rows` when
    the gather runs."""
    variant = collectives.resolve_variant(
        getattr(config, "variant", None), getattr(config, "ring", None))
    cfg_merge = getattr(config, "merge", None)
    merge = collectives.resolve_merge(cfg_merge)
    wire_dtype = getattr(config, "wire_dtype", None) or "float32"
    if wire_dtype != "float32" and merge == "psum_scatter":
        # A bf16 wire can only merge via ring_rs (fp32 accumulate). An
        # EXPLICIT psum_scatter request (config field or env var) is a
        # contradiction and raises — from ExchangeSpec below; the default
        # is normalized so reports name the schedule that actually runs.
        if cfg_merge is None and collectives.ENV_MERGE not in os.environ:
            merge = "ring_rs"
    chunk_rows = getattr(config, "chunk_rows", None)
    if chunk_rows is None and variant == "overlap" and \
            getattr(config, "autotune_chunk", False) and \
            plan is not None and rank is not None and mesh is not None:
        from repro_torch.comm.autotune import autotune_chunk_rows
        gather_rows = max(p.rows_max // p.r for p in plan.modes)
        chunk_rows = autotune_chunk_rows(
            gather_rows, rank, mesh,
            wire_dtype=None if wire_dtype == "float32" else wire_dtype)
    return ExchangeSpec(variant=variant, merge=merge, chunk_rows=chunk_rows,
                        wire_dtype=wire_dtype)
