"""Plan/config rule registry (the ``AP-*`` pass).

The counterpart of the reference package's ``analysis/plan_rules.py``, with
the same rule ids, severities, messages and locations. Runs over the port's
:class:`~repro_torch.core.partition.CPPlan` (in-memory or lazy) and an
optional :class:`~repro_torch.api.config.DecomposeConfig` *before* compile,
turning the layout contracts scattered across ``core/partition.py``,
``kernels/_build.py``, ``store/plan.py``, and ``comm/spec.py`` into
findings with stable rule ids:

==========  ========  ==============================================
rule        severity  invariant
==========  ========  ==============================================
AP-P001     error     tile/block_p geometry divisibility
AP-P002     error     replication grid: rows_max % r, device coverage
AP-P003     error     sorted layout: per-device local_rows nondecreasing
AP-P004     error     pad-retarget validity: every slot's row in its
                      block's tile (local_rows//tile == block_to_tile)
AP-P005     error     segment descriptors buildable and consistent
AP-P006     error     per-variant shared-memory byte model within budget
AP-P007     error     streaming window byte model vs memory_budget
                      (densest-tile floor, coverage, resident bound)
AP-P008     warning   autotune cache v3 key hygiene
AP-P009     error     exchange spec resolvable for this plan/config
AP-C001     error     configs/ module not on the explicit allowlist
==========  ========  ==============================================

AP-P006 models one CUDA block of the variant's kernel
(:func:`repro_torch.kernels._build.variant_smem_bytes`, the amount the
wrapper requests at launch) against ``smem_budget``, by default the card's
limit ``_build.SMEM_LIMIT``, where the reference models a Pallas kernel's
VMEM scratch against 16 MiB. AP-P007 checks the port's
``ModeStreamPlan.validate_against``, AP-P008 the port's tuner cache
(``AMPED_TORCH_AUTOTUNE_CACHE``), and AP-C001 the port's ``configs/``.

O(nnz) rules (AP-P003/4/5) run eagerly on in-memory plans; on lazy
(out-of-core) plans they stream per-device arrays only under
``deep=True`` — plan-time ``api.plan(analyze=...)`` stays manifest-cheap.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from repro_torch.analysis.model import Finding
from repro_torch.kernels._build import SMEM_LIMIT

__all__ = ["PLAN_RULES", "RuleContext", "check_plan", "check_autotune_cache",
           "check_config_modules", "SEED_MODEL_CONFIGS",
           "DEFAULT_SMEM_BUDGET"]

# Shared memory one CUDA block may use on Hopper (227 KiB, the EC kernels'
# launch limit), which AP-P006's byte model is checked against.
DEFAULT_SMEM_BUDGET = SMEM_LIMIT

# Seed-scaffold LLM architecture modules under configs/ — exercised by
# the dry-run shape tests but NOT part of the decomposition analysis sweep.
# Anything in configs/ that is neither here nor a known decompose config is
# an AP-C001 error: new modules must be classified, not silently skipped.
SEED_MODEL_CONFIGS = frozenset({
    "gemma2_9b", "nemotron4_340b", "granite_8b", "gemma3_1b",
    "jamba15_large", "rwkv6_7b", "whisper_small", "deepseek_v2_lite",
    "phi35_moe", "llama32_vision_90b",
})
_DECOMPOSE_CONFIGS = frozenset({"amped_paper"})


@dataclasses.dataclass
class RuleContext:
    plan: object                      # CPPlan
    config: object = None             # DecomposeConfig | None
    deep: bool = False                # materialize lazy per-device arrays
    smem_budget: int = DEFAULT_SMEM_BUDGET


@dataclasses.dataclass(frozen=True)
class PlanRule:
    rule_id: str
    severity: str
    summary: str
    fn: Callable[[RuleContext], Iterable[Finding]]


PLAN_RULES: dict[str, PlanRule] = {}


def _rule(rule_id: str, severity: str, summary: str):
    def deco(fn):
        PLAN_RULES[rule_id] = PlanRule(rule_id, severity, summary, fn)
        return fn
    return deco


def _loc(part, dev=None, block=None) -> str:
    loc = f"mode={part.mode}"
    if dev is not None:
        loc += f" dev={dev}"
    if block is not None:
        loc += f" block={block}"
    return loc


def _device_local_rows(part) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (dev, local_rows) per device; streams lazy plans one device
    at a time so peak host memory stays one shard."""
    if not part.lazy:
        lr = np.asarray(part.local_rows)
        for dev in range(part.num_devices):
            yield dev, lr[dev]
    else:
        for dev in range(part.num_devices):
            _, _, rows = part.device_arrays(dev)
            yield dev, np.asarray(rows)


def _skip_nnz_rules(ctx) -> bool:
    return any(p.lazy for p in ctx.plan.modes) and not ctx.deep


# -- geometry -------------------------------------------------------------

@_rule("AP-P001", "error", "tile/block_p geometry divisibility")
def _check_geometry(ctx) -> Iterable[Finding]:
    for part in ctx.plan.modes:
        if part.tile < 1 or part.block_p < 1:
            yield Finding("AP-P001", "error",
                          f"tile={part.tile} block_p={part.block_p} must "
                          f"be >= 1", _loc(part))
            continue
        if part.rows_max % part.tile:
            yield Finding("AP-P001", "error",
                          f"rows_max={part.rows_max} not a multiple of "
                          f"tile={part.tile}: the last output tile would "
                          f"be fractional", _loc(part))
        if part.nnz_max % part.block_p:
            yield Finding("AP-P001", "error",
                          f"nnz_max={part.nnz_max} not a multiple of "
                          f"block_p={part.block_p}: the last kernel block "
                          f"would be fractional", _loc(part))
        elif part.nblocks * part.block_p != part.nnz_max:
            yield Finding("AP-P001", "error",
                          f"nblocks={part.nblocks} * block_p={part.block_p}"
                          f" != nnz_max={part.nnz_max}", _loc(part))


@_rule("AP-P002", "error", "replication grid: rows_max % r, coverage")
def _check_replication(ctx) -> Iterable[Finding]:
    for part in ctx.plan.modes:
        if part.r > 0 and part.rows_max % part.r:
            yield Finding("AP-P002", "error",
                          f"rows_max={part.rows_max} not divisible by "
                          f"replication r={part.r}; the intra-group merge "
                          f"would corrupt row ownership", _loc(part))
        if part.num_devices != part.n_groups * part.r:
            yield Finding("AP-P002", "error",
                          f"device grid {part.n_groups}x{part.r} does not "
                          f"cover num_devices={part.num_devices}",
                          _loc(part))
        lcm = math.lcm(max(part.tile, 1), max(part.r, 1))
        if part.rows_max % lcm:
            yield Finding("AP-P002", "error",
                          f"rows_max={part.rows_max} not a multiple of "
                          f"lcm(tile={part.tile}, r={part.r})={lcm}",
                          _loc(part))


# -- O(nnz) layout rules --------------------------------------------------

@_rule("AP-P003", "error", "sorted layout: local_rows nondecreasing")
def _check_sorted_monotone(ctx) -> Iterable[Finding]:
    if _skip_nnz_rules(ctx):
        return
    for part in ctx.plan.modes:
        if part.block_layout != "sorted":
            continue
        for dev, rows in _device_local_rows(part):
            drop = np.nonzero(np.diff(rows.astype(np.int64)) < 0)[0]
            if drop.size:
                slot = int(drop[0])
                yield Finding(
                    "AP-P003", "error",
                    f"local_rows decreases at slot {slot} "
                    f"({int(rows[slot])} -> {int(rows[slot + 1])}); the "
                    f"sorted EC kernel's segmented reduction requires "
                    f"nondecreasing rows per device",
                    _loc(part, dev, slot // part.block_p))


@_rule("AP-P004", "error", "pad-retarget validity: slot row in block tile")
def _check_row_tile_consistency(ctx) -> Iterable[Finding]:
    if _skip_nnz_rules(ctx):
        return
    for part in ctx.plan.modes:
        b2t = np.asarray(part.block_to_tile)
        for dev, rows in _device_local_rows(part):
            tiles = rows.astype(np.int64) // part.tile
            expect = np.repeat(b2t[dev].astype(np.int64), part.block_p)
            bad = np.nonzero(tiles != expect)[0]
            if bad.size:
                slot = int(bad[0])
                yield Finding(
                    "AP-P004", "error",
                    f"slot {slot} has local_row {int(rows[slot])} in tile "
                    f"{int(tiles[slot])} but its block maps to tile "
                    f"{int(expect[slot])}; pad slots must be retargeted "
                    f"inside their block's tile",
                    _loc(part, dev, slot // part.block_p))


@_rule("AP-P005", "error", "segment descriptors buildable and consistent")
def _check_segment_descriptors(ctx) -> Iterable[Finding]:
    if _skip_nnz_rules(ctx):
        return
    from repro_torch.core.partition import block_segment_descriptors
    for part in ctx.plan.modes:
        for dev, rows in _device_local_rows(part):
            try:
                seg_starts, seg_rows = block_segment_descriptors(
                    rows, tile=part.tile, block_p=part.block_p)
            except ValueError as e:
                yield Finding("AP-P005", "error",
                              f"segment descriptors unbuildable: {e}",
                              _loc(part, dev))
                continue
            # active segments' rows must stay within [0, tile) — the
            # descriptor's row-in-tile plus block_to_tile reconstructs the
            # absolute row the sorted kernel writes.
            active = seg_starts[:, :-1] < part.block_p
            if seg_rows[active].size and (
                    seg_rows[active].max(initial=0) >= part.tile
                    or seg_rows[active].min(initial=0) < 0):
                yield Finding("AP-P005", "error",
                              f"segment row-in-tile outside [0, "
                              f"{part.tile})", _loc(part, dev))
            # tile identity of each segment is AP-P004's check


# -- resource models ------------------------------------------------------

@_rule("AP-P006", "error",
       "per-variant shared-memory byte model within budget")
def _check_smem(ctx) -> Iterable[Finding]:
    if ctx.config is None:
        return
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.mttkrp_blocked import RING_DEPTH
    kw = ops.kernel_kwargs_from_config(ctx.config.kernel)
    if not kw.get("use_kernel", False):
        return
    variant = kw["variant"]
    # ec_blocked runs at its wrapper's fixed ring depth
    num_buffers = RING_DEPTH if variant == "blocked" else kw["num_buffers"]
    for part in ctx.plan.modes:
        need = _build.variant_smem_bytes(
            variant, tile=part.tile, rank=ctx.config.rank,
            nin=ctx.plan.nmodes - 1, num_buffers=num_buffers)
        if need > ctx.smem_budget:
            yield Finding(
                "AP-P006", "error",
                f"variant={variant} needs {need} B of shared memory per "
                f"CUDA block (tile={part.tile} rank={ctx.config.rank} "
                f"num_buffers={num_buffers}) > budget {ctx.smem_budget} B; "
                f"shrink tile/num_buffers or the rank",
                _loc(part))


@_rule("AP-P007", "error", "streaming window byte model vs memory_budget")
def _check_streaming(ctx) -> Iterable[Finding]:
    cfg = ctx.config
    if cfg is None or not cfg.runtime.streaming:
        return
    budget = cfg.runtime.memory_budget
    if budget is None:
        yield Finding("AP-P007", "error",
                      "runtime.streaming=True without "
                      "runtime.memory_budget")
        return
    if not all(p.lazy for p in ctx.plan.modes):
        yield Finding("AP-P007", "error",
                      "runtime.streaming=True needs an out-of-core "
                      "(store-backed) plan; this plan is fully resident")
        return
    from repro_torch.store.plan import split_mode_super_shards
    buffers = cfg.runtime.stream_buffers
    for part in ctx.plan.modes:
        try:
            splan = split_mode_super_shards(part, budget, buffers=buffers)
        except ValueError as e:
            yield Finding("AP-P007", "error", f"window split rejected: {e}",
                          _loc(part))
            continue
        for msg in splan.validate_against(part, nmodes=ctx.plan.nmodes):
            yield Finding("AP-P007", "error", msg, _loc(part))


# -- environment hygiene --------------------------------------------------

def check_autotune_cache() -> list[Finding]:
    """AP-P008: the port's tuner cache file format/key hygiene (v3 keys
    carry the device kind; stale v1/v2 keys mean results from an unknown
    device)."""
    from repro_torch.kernels import autotune
    findings: list[Finding] = []
    path = autotune.cache_path()
    if path is None or not os.path.exists(path):
        return findings
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        findings.append(Finding("AP-P008", "warning",
                                f"unreadable autotune cache: {e}",
                                str(path)))
        return findings
    fmt = doc.get("_format")
    if fmt != autotune.CACHE_FORMAT_VERSION:
        findings.append(Finding(
            "AP-P008", "warning",
            f"cache format {fmt!r} != v{autotune.CACHE_FORMAT_VERSION}; "
            f"entries will be migrated or dropped on next load",
            str(path)))
    for key in doc:
        if key.startswith("_") or key.startswith("xchg_"):
            continue
        if not autotune._V3_KEY_RE.match(key):
            findings.append(Finding(
                "AP-P008", "warning",
                f"stale pre-v3 cache key {key!r} (no device-kind tag); "
                f"timings may come from a different device",
                str(path)))
    return findings


@_rule("AP-P008", "warning", "autotune cache v3 key hygiene")
def _check_autotune_cache_rule(ctx) -> Iterable[Finding]:
    return check_autotune_cache()


@_rule("AP-P009", "error", "exchange spec resolvable for plan/config")
def _check_exchange(ctx) -> Iterable[Finding]:
    if ctx.config is None:
        return
    from repro_torch.comm.spec import resolve_exchange_spec
    try:
        spec = resolve_exchange_spec(ctx.config.exchange, plan=ctx.plan,
                                     rank=ctx.config.rank)
    except ValueError as e:
        yield Finding("AP-P009", "error", f"exchange spec invalid: {e}")
        return
    if spec.chunk_rows is not None:
        gather_rows = max(p.rows_max // max(p.r, 1)
                         for p in ctx.plan.modes)
        if spec.chunk_rows >= gather_rows:
            yield Finding("AP-P009", "warning",
                          f"chunk_rows={spec.chunk_rows} >= per-device "
                          f"gather rows {gather_rows}: chunked overlap "
                          f"degenerates to a single chunk")


def check_config_modules(configs_dir: Optional[str] = None) -> list[Finding]:
    """AP-C001: every module under ``repro_torch/configs`` must be
    classified — a decompose config or an allowlisted seed LLM scaffold.
    New files fail loudly instead of being silently skipped by the
    sweep."""
    if configs_dir is None:
        import repro_torch.configs
        configs_dir = os.path.dirname(repro_torch.configs.__file__)
    findings = []
    for name in sorted(os.listdir(configs_dir)):
        stem, ext = os.path.splitext(name)
        if ext != ".py" or stem == "__init__":
            continue
        if stem in SEED_MODEL_CONFIGS or stem in _DECOMPOSE_CONFIGS:
            continue
        findings.append(Finding(
            "AP-C001", "error",
            f"configs/{name} is neither a decompose config nor on the "
            f"seed-model allowlist; classify it in "
            f"repro_torch.analysis.plan_rules", f"configs/{name}"))
    return findings


def check_plan(plan, config=None, *, deep: bool = False,
               smem_budget: int = DEFAULT_SMEM_BUDGET,
               rules: Optional[Iterable[str]] = None) -> list[Finding]:
    """Run the plan-rule registry; returns findings (empty == clean).

    ``deep=True`` additionally streams lazy plans' per-device arrays for
    the O(nnz) rules. ``smem_budget`` is AP-P006's shared-memory bytes per
    CUDA block. ``rules`` restricts to a subset of rule ids."""
    ctx = RuleContext(plan=plan, config=config, deep=deep,
                      smem_budget=smem_budget)
    selected = PLAN_RULES if rules is None else {
        rid: PLAN_RULES[rid] for rid in rules}
    findings: list[Finding] = []
    for rule in selected.values():
        findings.extend(rule.fn(ctx))
    return findings
