"""Recorded-operation auditor (the ``AH-*`` pass).

The counterpart of the reference package's ``analysis/hlo_audit.py``, kept
under that name so a reader finds it. The reference lints the HLO text its
compiler sees; the port runs eagerly and has no such text, so this pass
audits what the port *records* while it runs one step on copies of the
state: every torch operation dispatched (a ``TorchDispatchMode``; per
operation its name, its tensors' shapes, dtypes and devices, and the
innermost ``repro_torch`` source line that issued it) and, on the card,
every synchronising CUDA call torch reports under
``torch.cuda.set_sync_debug_mode("warn")`` (a warning raised where the
Python call that synchronised returns, so at its source line):

==========  ========  ==================================================
rule        severity  check
==========  ========  ==================================================
AH-H001     error     no ``(nnz, R)`` gathered intermediate in the fused
                      or sorted EC (one ``ops.mttkrp_local`` call on a
                      representative shard records no gather op with
                      that output; ``blocked`` pre-gathers by design)
AH-H002     error     no host synchronisation in a sweep's mode update:
                      each sync the card reports, and each operation that
                      synchronises on the card wherever it runs
                      (``aten._local_scalar_dense`` — ``.item()``,
                      ``int()`` of a tensor —, a copy to the CPU, an
                      operation whose output size depends on the data)
AH-H005     error     bf16 on the wire when ``wire_dtype=bfloat16`` (the
                      copies ``comm.collectives`` sends between logical
                      devices carry bf16)
AH-H006     error     serving bucket shapes within O(log max_batch)
                      (the engine's shape sets, as in the reference)
==========  ========  ==================================================

Two reference rules have no counterpart in a one-controller eager port,
and this pass does not claim to check them: AH-H003 (a collective-permute
must lower under the ``overlap`` exchange) guards against a compiler
dropping the overlap's chunked copies, and nothing compiles those copies
here — ``tests/test_torch_exchange.py`` counts them; AH-H004 (donated
factor buffers aliased in the compiled HLO) has no object, since torch has
no donation (the update writes the new factor into the old one's storage
itself, ``core/als.py::make_mode_update``).

Operations inside a kernel's plain version (the ``*_plain`` functions of
``repro_torch/kernels``, which CPU tensors take) are not recorded: on the
card the kernel runs in their place, gathering its rows and reducing in
its own memory. So on the CPU the audit sees exactly what the main path
runs on the card apart from the kernels.

:func:`audit_solver` runs each mode's update on clones of the solver's
factors and grams (the reference only lowers), restores the exchange's
byte counters and the sync-debug mode after, and leaves the solver's state
bitwise as it was. The recording and the sync-debug mode are process-wide
while it runs: audit a solver while no other thread runs torch work you
would not want attributed to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.model import Finding

__all__ = ["OpRecord", "record_ops", "gather_free", "gathered_intermediates",
           "host_syncs", "ec_recorded_ops", "audit_ec_kernel",
           "update_recorded_ops", "audit_update_records", "audit_solver",
           "audit_serving_engine", "serving_retrace_report"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_SELF = os.path.dirname(os.path.abspath(__file__))

# ops that read rows of a table by index: a gathered intermediate
_GATHER_OPS = frozenset({
    "aten.index_select.default", "aten.index.Tensor", "aten.gather.default",
    "aten.embedding.default", "aten.take.default"})
# ops that read a device value on the host, or whose output size depends on
# the data (the host waits to learn it)
_SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.item.default",
    "aten.nonzero.default", "aten.masked_select.default",
    "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default", "aten.repeat_interleave.Tensor"})
_COPY_OPS = frozenset({"aten._to_copy.default", "aten.copy_.default"})
_SYNC_WARNING = "synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded operation (or a sync the card reported during it)."""

    op: str                        # "aten.index_select.default"
    out_shapes: tuple = ()         # output tensors' shapes
    in_dtypes: tuple = ()          # tensor arguments' dtypes ("float32")
    in_devices: tuple = ()         # tensor arguments' device types
    out_devices: tuple = ()        # output tensors' device types
    where: str = ""                # "repro_torch/core/als.py:100"
    func: str = ""                 # the function at ``where``
    sync: bool = False             # a synchronisation the card reported


def _site() -> tuple[str, str, bool]:
    """The innermost ``repro_torch`` frame outside this package (its
    ``path:line`` and function), and whether a kernel's plain version is
    on the stack."""
    f = sys._getframe(2)
    where = func = ""
    plain = False
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_SELF):
            if not where:
                where = f"{os.path.relpath(fn, _ROOT)}:{f.f_lineno}"
                func = f.f_code.co_name
            if f.f_code.co_name.endswith("_plain") and \
                    os.sep + "kernels" + os.sep in fn:
                plain = True
        f = f.f_back
    return where, func, plain


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        where, fname, plain = _site()
        out = func(*args, **kwargs)
        if not plain:
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            self.records.append(OpRecord(
                op=str(func), out_shapes=tuple(tuple(t.shape) for t in outs),
                in_dtypes=tuple(str(t.dtype).removeprefix("torch.")
                                for t in ins),
                in_devices=tuple(t.device.type for t in ins),
                out_devices=tuple(t.device.type for t in outs),
                where=where, func=fname))
        return out


def _sync_record(w, records) -> OpRecord:
    """A sync warning as a record at its source line, named after the
    function the operations recorded at that line ran in."""
    fn = os.path.abspath(w.filename)
    where = f"{os.path.relpath(fn, _ROOT) if fn.startswith(_PKG) else fn}" \
        f":{w.lineno}"
    func = next((r.func for r in records if r.where == where), "")
    return OpRecord(op="cuda-sync", where=where, func=func, sync=True)


@contextlib.contextmanager
def record_ops(*, sync_debug: bool = False):
    """Record every torch operation dispatched in the block (a list of
    :class:`OpRecord`, yielded). With ``sync_debug`` the card's sync-debug
    mode is ``"warn"`` inside the block and restored after, and each sync
    it reports is appended as a record (``op="cuda-sync"``, ``sync=True``)
    at the source line whose call synchronised; other warnings pass on."""
    rec = _Recorder()
    was = torch.cuda.get_sync_debug_mode() if sync_debug else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                yield rec.records
        finally:
            if sync_debug:
                torch.cuda.set_sync_debug_mode(was)
    for w in caught:
        if _SYNC_WARNING in str(w.message):
            rec.records.append(_sync_record(w, rec.records))
        else:  # not ours: pass it on
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


def gathered_intermediates(records: Sequence[OpRecord], *,
                           nnz: Optional[int] = None,
                           rank: Optional[int] = None) -> list[OpRecord]:
    """The gather operations among ``records`` — with ``nnz``/``rank``
    given, only those whose output is ``(nnz, rank)``."""
    out = []
    for r in records:
        if r.op not in _GATHER_OPS:
            continue
        if nnz is None or any(len(s) == 2 and s[0] == nnz and
                              (rank is None or s[1] == rank)
                              for s in r.out_shapes):
            out.append(r)
    return out


def gather_free(records: Sequence[OpRecord], *, nnz: Optional[int] = None,
                rank: Optional[int] = None) -> bool:
    """True iff ``records`` hold no gathered intermediate (see
    :func:`gathered_intermediates`)."""
    return not gathered_intermediates(records, nnz=nnz, rank=rank)


def host_syncs(records: Sequence[OpRecord]) -> list[OpRecord]:
    """The records that synchronise with the host: a sync the card
    reported, an operation in the sync set, or a copy from the card to the
    CPU."""
    out = []
    for r in records:
        to_cpu = r.op in _COPY_OPS and "cuda" in r.in_devices and \
            r.out_devices and r.out_devices[0] == "cpu"
        if r.sync or r.op in _SYNC_OPS or to_cpu:
            out.append(r)
    return out


def ec_recorded_ops(variant: str, *, nmodes: int, rank: int,
                    tile: Optional[int] = None,
                    block_p: Optional[int] = None,
                    num_buffers: int = 2, nnz: int = 2048,
                    device=None) -> tuple[list[OpRecord], int]:
    """Record one ``ops.mttkrp_local`` call of ``variant`` on a
    representative shard of this geometry (the autotuner's construction)
    on ``device`` (``None``: the card); returns the records and the
    shard's slot count."""
    from repro_torch.api.solver import resolve_device
    from repro_torch.core.mttkrp import place_shard
    from repro_torch.kernels import autotune, ops

    dev = resolve_device(device)
    layout = "sorted" if variant == "sorted" else "blocked"
    t, part = autotune.representative_shard(
        nmodes, nnz, tile=tile, block_p=block_p, layout=layout)
    rng = np.random.default_rng(0)
    factors = [torch.tensor(rng.normal(size=(s, rank)).astype(np.float32),
                            device=dev) for s in t.shape]

    shard, _ = place_shard(part, 0, dev)
    with record_ops() as records:
        ops.mttkrp_local(shard.indices, shard.values, shard.local_rows,
                         shard.block_to_tile, factors, mode=0,
                         num_rows=part.rows_max, tile=part.tile,
                         block_p=part.block_p, use_kernel=variant != "ref",
                         variant=variant, num_buffers=num_buffers,
                         seg_starts=shard.seg_starts,
                         seg_rows=shard.seg_rows, items=shard.items)
    return records, int(part.indices[0].shape[0])


def audit_ec_kernel(variant: str, *, nmodes: int, rank: int,
                    tile: Optional[int] = None,
                    block_p: Optional[int] = None,
                    num_buffers: int = 2, nnz: int = 2048,
                    recorded_ops: Optional[Sequence[OpRecord]] = None,
                    slots: Optional[int] = None,
                    device=None) -> list[Finding]:
    """AH-H001 on one EC kernel variant (pass ``recorded_ops`` — and the
    shard's ``slots`` — to audit caller-provided records instead of a
    representative call's)."""
    findings: list[Finding] = []
    if variant not in ("fused", "sorted"):
        return findings  # ref/blocked are allowed to gather
    if recorded_ops is None:
        recorded_ops, slots = ec_recorded_ops(
            variant, nmodes=nmodes, rank=rank, tile=tile, block_p=block_p,
            num_buffers=num_buffers, nnz=nnz, device=device)
    hits = gathered_intermediates(recorded_ops, nnz=slots, rank=rank)
    if hits:
        h = hits[0]
        findings.append(Finding(
            "AH-H001", "error",
            f"'{variant}' EC records a gather op producing an (nnz, R) "
            f"intermediate ({h.op} at {h.where or '?'}); the fused/sorted "
            f"paths must gather factor rows in the kernel, not before it",
            f"kernel variant={variant}"))
    return findings


def update_recorded_ops(solver, mode: int) -> list[OpRecord]:
    """Record one run of ``solver``'s resident update of ``mode`` on clones
    of its factors and grams, under the sync-debug mode when a logical
    device is a card. The exchange's byte counters are restored after: the
    solver's state and counters stay as they were."""
    from repro_torch.comm import volume
    s = solver.state
    factors = [[f.clone() for f in reps] for reps in s.factors]
    grams = [[g.clone() for g in reps] for reps in s.grams]
    others = [factors[w] for w in range(len(factors)) if w != mode]
    dev = solver.dev_arrays[mode]
    cards = any(d.type == "cuda" for d in solver.mesh.devices)
    sent = dict(volume._SENT)
    try:
        with record_ops(sync_debug=cards) as records:
            solver.updates[mode](factors[mode], dev, others, grams)
    finally:
        volume._SENT.clear()
        volume._SENT.update(sent)
    return records


def audit_update_records(records: Sequence[OpRecord], *, mode: int,
                         exchange_spec, multi_device: bool
                         ) -> list[Finding]:
    """AH-H002/H005 over one mode update's records."""
    findings: list[Finding] = []
    loc = f"mode={mode} update"
    seen = set()
    for r in host_syncs(records):
        if r.where in seen:
            continue
        seen.add(r.where)
        what = "the card reported a synchronising CUDA call" if r.sync \
            else r.op
        findings.append(Finding(
            "AH-H002", "error",
            f"sweep update synchronises with the host at {r.where or '?'} "
            f"({r.func or '?'}: {what}); the sweep loop must stay on "
            f"device", loc))
    wire_bf16 = multi_device and exchange_spec.wire_dtype == "bfloat16"
    sent = [r for r in records
            if r.op == "aten.copy_.default" and r.func == "_send_into"]
    if wire_bf16 and not any(len(r.in_dtypes) > 1
                             and r.in_dtypes[1] == "bfloat16"
                             for r in sent):
        findings.append(Finding(
            "AH-H005", "error",
            "exchange.wire_dtype=bfloat16 but no bf16 values on the wire "
            "(the exchange's sent copies); the wire would carry f32 at 2x "
            "the volume", loc))
    return findings


def audit_solver(solver, *, modes: Optional[Sequence[int]] = None
                 ) -> list[Finding]:
    """Audit a live :class:`~repro_torch.api.solver.CPSolver`: its EC
    variant (AH-H001, on the solver's first device) and each mode's
    resident update (AH-H002/H005, on copies of the state). Streaming
    solvers skip the per-update recording (their updates run per
    super-shard; the kernel-level and serving checks still apply)."""
    plan, config = solver.plan, solver.config
    kw = solver._kernel_kw
    part0 = plan.modes[0]
    findings = audit_ec_kernel(
        kw["variant"], nmodes=plan.nmodes, rank=config.rank,
        tile=part0.tile, block_p=part0.block_p,
        num_buffers=kw["num_buffers"], device=solver.mesh.devices[0])
    if solver.streaming:
        return findings
    multi = plan.num_devices > 1
    for d in (modes if modes is not None else range(plan.nmodes)):
        findings += audit_update_records(
            update_recorded_ops(solver, d), mode=d,
            exchange_spec=solver.exchange_spec, multi_device=multi)
    return findings


# -- serving bucket accounting (AH-H006) ----------------------------------

def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def serving_retrace_report(engine) -> dict:
    """Bucket accounting for a :class:`ServingEngine`: the distinct query
    shapes so far vs the O(log max_batch) bound the bucketing guarantees
    (the reference's compile counts; here each shape is one bucket the
    engine has run)."""
    bound = (int(math.log2(engine.max_batch))
             - int(math.log2(max(engine.min_bucket, 1))) + 1)
    return {
        "reconstruct_shapes": sorted(engine._reconstruct_shapes),
        "topk_shapes": sorted(engine._topk_shapes),
        "reconstruct_compiles": len(engine._reconstruct_shapes),
        "topk_compiles": len(engine._topk_shapes),
        "bucket_bound": bound,
    }


def audit_serving_engine(engine) -> list[Finding]:
    findings: list[Finding] = []
    rep = serving_retrace_report(engine)
    bound = rep["bucket_bound"]
    sizes = {f.shape[0] for f in engine.snapshot.factors}
    for b in rep["reconstruct_shapes"]:
        if not _is_pow2(b) or b > engine.max_batch:
            findings.append(Finding(
                "AH-H006", "error",
                f"reconstruct ran at non-bucket batch {b}; every distinct "
                f"shape escapes the bucket bound", "serving"))
    if rep["reconstruct_compiles"] > bound:
        findings.append(Finding(
            "AH-H006", "error",
            f"{rep['reconstruct_compiles']} reconstruct buckets exceed the "
            f"O(log max_batch) bound {bound}", "serving"))
    nmodes = len(engine.snapshot.factors)
    # per (mode, k-bucket) at most `bound` batch buckets; k itself is
    # bucketed to powers of two (or clamped to the mode's row count)
    for b, _mode, kb in rep["topk_shapes"]:
        if not _is_pow2(b) or (not _is_pow2(kb) and kb not in sizes):
            findings.append(Finding(
                "AH-H006", "error",
                f"topk ran at non-bucket shape (batch={b}, k={kb})",
                "serving"))
    kbuckets = {kb for _, _, kb in rep["topk_shapes"]}
    topk_bound = bound * nmodes * max(len(kbuckets), 1)
    if rep["topk_compiles"] > topk_bound:
        findings.append(Finding(
            "AH-H006", "error",
            f"{rep['topk_compiles']} topk buckets exceed the bucketed "
            f"bound {topk_bound}", "serving"))
    return findings
