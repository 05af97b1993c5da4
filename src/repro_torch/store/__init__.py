"""repro_torch.store — the out-of-core sparse tensor subsystem.

The paper's datasets are billions of nonzeros; the in-memory
:class:`~repro_torch.core.coo.SparseTensor` path needs the full COO in host RAM
before the first partition decision. This package removes that last
O(nnz)-resident stage:

* **Format** (:mod:`repro_torch.store.format`) — a versioned directory of
  little-endian packed arrays in fixed-size nnz chunks, per-mode minimized
  index dtypes, a JSON manifest with per-chunk per-mode stats, and exact
  per-mode histogram sidecars.
* **Ingest** (:mod:`repro_torch.store.writer`) — :func:`convert_tns` (two-pass
  streaming ``.tns``/``.tns.gz`` converter, ``python -m
  repro_torch.store.convert``), :func:`write_store_from_coo`, and the
  store-native profile generator :func:`write_profile_store` (paper-scale
  synthetic tensors with O(chunk) memory).
* **Read** (:mod:`repro_torch.store.store`) — :class:`TensorStore`, the
  mmap-backed ``SparseTensor``-compatible surface with counted chunk
  access.
* **Plan** (:mod:`repro_torch.store.plan`) — :func:`build_plan_from_store`
  partitions from manifest histograms with zero chunk reads;
  :class:`StoreModePartition` materializes per-device shards by streaming
  only overlapping chunks, bit-identical to the in-memory path.

``api.plan``/``api.compile`` accept a :class:`TensorStore` wherever they
accept a :class:`SparseTensor`::

    from repro_torch.store import convert_tns, TensorStore
    convert_tns("amazon.tns.gz", "amazon.store")
    plan = api.plan(TensorStore("amazon.store"), cfg, cache_dir="plans/")
    result = api.compile(plan, cfg).run(10)
"""
from repro_torch.store.format import StoreFormatError
from repro_torch.store.plan import (ModeStreamPlan, OutOfCoreError,
                              StoreModePartition, budget_slot_cap,
                              build_plan_from_store, resident_shard_nbytes,
                              split_mode_super_shards, stream_shard_nbytes)
from repro_torch.store.store import TensorStore
from repro_torch.store.writer import (StoreWriter, append_to_store, convert_tns,
                                write_profile_store, write_store_from_coo)

__all__ = [
    "TensorStore", "StoreWriter", "StoreFormatError", "append_to_store",
    "convert_tns", "write_store_from_coo", "write_profile_store",
    "OutOfCoreError", "StoreModePartition", "build_plan_from_store",
    "ModeStreamPlan", "split_mode_super_shards", "stream_shard_nbytes",
    "resident_shard_nbytes", "budget_slot_cap",
]
