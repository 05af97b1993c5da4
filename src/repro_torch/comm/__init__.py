"""repro_torch.comm — the factor-exchange subsystem (paper §4.9, Algorithm 3).

The counterpart of the reference package's ``repro.comm``, minus its HLO
measurement and its chunk autotuner:

* :mod:`repro_torch.comm.collectives` — the gather-variant registry
  (``allgather | ring | overlap``) and merge-variant registry
  (``psum_scatter | ring_rs``), including the chunked overlap gather and the
  bf16-wire / fp32-accumulate path, over per-device tensor lists.
* :mod:`repro_torch.comm.spec` — :class:`ExchangeSpec`, the resolved,
  hashable configuration ``core.mttkrp`` runs, and
  :func:`resolve_exchange_spec` (config → spec).
* :mod:`repro_torch.comm.volume` — modelled exchange volume, and the bytes
  the collectives actually copied.

``repro_torch.core.exchange`` is a thin backwards-compatibility shim over
this package.
"""
from repro_torch.comm.collectives import (DEFAULT_MERGE, DEFAULT_VARIANT,
                                          ENV_MERGE, ENV_VARIANT,
                                          GATHER_VARIANTS, MERGE_VARIANTS,
                                          all_gather_axes, axis_size,
                                          default_chunk_rows, merge_partials,
                                          overlap_all_gather, resolve_merge,
                                          resolve_variant, ring_all_gather,
                                          ring_reduce_scatter)
from repro_torch.comm.spec import ExchangeSpec, resolve_exchange_spec
from repro_torch.comm.volume import (mode_exchange_bytes,
                                     modelled_exchange_bytes,
                                     reset_sent_bytes, sent_bytes,
                                     wire_bytes)

__all__ = [
    "GATHER_VARIANTS", "MERGE_VARIANTS", "ENV_VARIANT", "ENV_MERGE",
    "DEFAULT_VARIANT", "DEFAULT_MERGE",
    "resolve_variant", "resolve_merge", "axis_size", "default_chunk_rows",
    "ring_all_gather", "overlap_all_gather", "all_gather_axes",
    "ring_reduce_scatter", "merge_partials",
    "ExchangeSpec", "resolve_exchange_spec",
    "wire_bytes", "mode_exchange_bytes", "modelled_exchange_bytes",
    "reset_sent_bytes", "sent_bytes",
]
