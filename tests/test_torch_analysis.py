"""The port's static analysis (repro_torch.analysis) on the CPU.

Twins of tests/test_analysis.py's tests (all but the LM serving shim's,
which belongs to a later slice): the plan-rule registry, the
recorded-operation audit that stands in for the HLO audit, the
concurrency lint over the port's thread-using modules, the runtime lock
assertions, the ``api.plan(analyze=)`` wiring and the ``python -m
repro_torch.analysis`` contract. Each seeded-defect test names the rule id
it regresses.

Cross-package: on each seeded plan defect the port's findings equal the
reference's as ``(rule, severity, location)`` sets, both plans built from
one tensor at one fixed geometry (bitwise the same plan,
tests/test_torch_plan.py). AP-P006 (shared memory per CUDA block against
the reference's VMEM) and AP-P008 (the port's own tuner cache) model other
things by design and have seeded-defect tests of their own. Synthetic
records trigger AH-H001, AH-H002 and AH-H005; the CPU audit of a solver is
clean, as the reference's is.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro_torch.api as api  # noqa: E402
from repro_torch.analysis import (AnalysisError, Finding,  # noqa: E402
                                  LockNotHeldError, apply_baseline,
                                  audit_ec_kernel, audit_serving_engine,
                                  check_autotune_cache,
                                  check_config_modules, check_plan,
                                  gather_free, hlo_audit, lint_source,
                                  load_baseline, runtime, save_baseline)
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.analysis.hlo_audit import OpRecord  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.kernels._build import (SMEM_LIMIT,  # noqa: E402
                                        variant_smem_bytes)

CPU = "cpu"
FIXED = {"rank": 8, "kernel.autotune": False, "partition.tile": 8,
         "partition.block_p": 64}


@pytest.fixture(scope="module")
def port_tensor(small_tensor):
    return SparseTensor(small_tensor.indices, small_tensor.values,
                        small_tensor.shape)


@pytest.fixture(scope="module")
def sorted_cfg():
    return api.preset("sorted", FIXED)


@pytest.fixture(scope="module")
def sorted_plan(port_tensor, sorted_cfg):
    return api.plan(port_tensor, sorted_cfg, device=CPU)


@pytest.fixture(scope="module")
def jplan(small_tensor):
    import repro.api as japi
    cfg = japi.preset("sorted", FIXED)
    return japi.plan(small_tensor, cfg), cfg


def _swap_mode(plan, part):
    modes = list(plan.modes)
    modes[part.mode] = part
    return dataclasses.replace(plan, modes=tuple(modes))


def _triples(findings):
    return {(f.rule, f.severity, f.location) for f in findings}


def _same_as_reference(defect, rules, sorted_plan, jplan, *, cfg=None,
                       jcfg=None):
    """Apply ``defect`` (plan -> defective plan) to both packages' plans
    and return the port's findings after asserting they equal the
    reference's as (rule, severity, location) sets."""
    from repro.analysis import check_plan as jcheck_plan
    found = check_plan(defect(sorted_plan), cfg, rules=rules)
    jfound = jcheck_plan(defect(jplan[0]), jcfg, rules=rules)
    assert _triples(found) == _triples(jfound)
    return found


# -- plan rules (AP-*) -------------------------------------------------------

def test_clean_plan_no_findings(sorted_plan, sorted_cfg):
    assert check_plan(sorted_plan, sorted_cfg) == []


def test_ap_p001_fractional_tile(sorted_plan, jplan):
    assert sorted_plan.modes[0].tile > 1

    def defect(plan):
        part = plan.modes[0]
        return _swap_mode(plan, dataclasses.replace(
            part, rows_max=part.rows_max + 1))
    found = _same_as_reference(defect, ["AP-P001"], sorted_plan, jplan)
    assert found and all(f.rule == "AP-P001" for f in found)
    assert all(f.severity == "error" for f in found)


def test_ap_p002_grid_coverage(sorted_plan, jplan):
    def defect(plan):
        part = plan.modes[0]
        return _swap_mode(plan, dataclasses.replace(
            part, n_groups=part.n_groups + 1))
    found = _same_as_reference(defect, ["AP-P002"], sorted_plan, jplan)
    assert any("device grid" in f.message for f in found)


def test_ap_p003_nonmonotone_sorted_rows(sorted_plan, jplan):
    assert sorted_plan.modes[0].block_layout == "sorted"

    def defect(plan):
        part = plan.modes[0]
        lr = np.array(part.local_rows)
        rows = lr[0]
        inc = np.nonzero(np.diff(rows.astype(np.int64)) > 0)[0]
        assert inc.size, "fixture needs at least one strict increase"
        i = int(inc[0])
        rows[i], rows[i + 1] = rows[i + 1], rows[i]
        return _swap_mode(plan, dataclasses.replace(part, local_rows=lr))
    found = _same_as_reference(defect, ["AP-P003"], sorted_plan, jplan)
    assert any(f.rule == "AP-P003" and "dev=0" in f.location for f in found)


def test_ap_p004_pad_retarget_violation(sorted_plan, jplan):
    def defect(plan):
        part = plan.modes[0]
        n_tiles = part.rows_max // part.tile
        assert n_tiles >= 2
        b2t = np.asarray(part.block_to_tile)
        lr = np.array(part.local_rows)
        lr[0, 0] = ((int(b2t[0, 0]) + 1) % n_tiles) * part.tile
        return _swap_mode(plan, dataclasses.replace(part, local_rows=lr))
    found = _same_as_reference(defect, ["AP-P004"], sorted_plan, jplan)
    assert any(f.rule == "AP-P004" and "block=0" in f.location
               for f in found)


def test_ap_p005_descriptors_unbuildable(sorted_plan, jplan):
    def defect(plan):
        part = plan.modes[0]
        lr = np.array(part.local_rows)[:, :-1]
        return _swap_mode(plan, dataclasses.replace(part, local_rows=lr))
    found = _same_as_reference(defect, ["AP-P005"], sorted_plan, jplan)
    assert any(f.rule == "AP-P005" and "unbuildable" in f.message
               for f in found)


def test_ap_p006_smem_budget(sorted_plan, sorted_cfg):
    """The port's AP-P006 holds the kernels' shared memory per CUDA block
    against ``smem_budget`` (default: the card's limit)."""
    assert check_plan(sorted_plan, sorted_cfg, rules=["AP-P006"]) == []
    found = check_plan(sorted_plan, sorted_cfg, smem_budget=1,
                       rules=["AP-P006"])
    assert len(found) == sorted_plan.nmodes
    assert all(f.rule == "AP-P006" and f.severity == "error" for f in found)
    # a tile, rank and ring depth whose block the card cannot hold
    wide = dataclasses.replace(sorted_plan, modes=tuple(
        dataclasses.replace(p, tile=64) for p in sorted_plan.modes))
    big = sorted_cfg.with_overrides({"rank": 128,
                                     "kernel.num_buffers": 4})
    need = variant_smem_bytes("sorted", tile=64, rank=128, nin=2,
                              num_buffers=4)
    assert need > SMEM_LIMIT
    found = check_plan(wide, big, rules=["AP-P006"])
    assert len(found) == 3 and str(need) in found[0].message
    assert check_plan(wide, big, smem_budget=need,
                      rules=["AP-P006"]) == []
    # ref launches no kernel: nothing to model
    ref = sorted_cfg.with_overrides({"kernel.variant": "ref"})
    assert check_plan(sorted_plan, ref, smem_budget=1,
                      rules=["AP-P006"]) == []


def test_ap_p007_streaming_preconditions(sorted_plan, sorted_cfg, jplan):
    cfg = sorted_cfg.with_overrides({"runtime.streaming": True})
    jcfg = jplan[1].with_overrides({"runtime.streaming": True})
    found = _same_as_reference(lambda p: p, ["AP-P007"], sorted_plan,
                               jplan, cfg=cfg, jcfg=jcfg)
    assert any("memory_budget" in f.message for f in found)
    cfg = cfg.with_overrides({"runtime.memory_budget": 2 ** 20})
    jcfg = jcfg.with_overrides({"runtime.memory_budget": 2 ** 20})
    found = _same_as_reference(lambda p: p, ["AP-P007"], sorted_plan,
                               jplan, cfg=cfg, jcfg=jcfg)
    assert any("fully resident" in f.message for f in found)


def test_ap_p008_cache_hygiene(tmp_path, monkeypatch):
    """AP-P008 reads the port's tuner cache (AMPED_TORCH_AUTOTUNE_CACHE),
    never the reference's file."""
    path = tmp_path / "autotune.json"
    path.write_text(json.dumps({
        "_format": 1,
        "cpu|fused|t2048": {"num_buffers": 2},   # pre-v3 key, no device tag
        "3m_r8_float32_gpu_nvidia-h100-80gb-hbm3_sorted": {"tile": 8},
    }))
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("AMPED_AUTOTUNE_CACHE", "")
    found = check_autotune_cache()
    assert any("format" in f.message for f in found)
    stale = [f for f in found if "pre-v3" in f.message]
    assert len(stale) == 1 and "cpu|fused|t2048" in stale[0].message
    assert all(f.severity == "warning" for f in found)
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", "")
    monkeypatch.setenv("AMPED_AUTOTUNE_CACHE", str(path))
    assert check_autotune_cache() == []


def test_ap_p009_degenerate_chunk_rows(sorted_plan, sorted_cfg, jplan):
    over = {"exchange.variant": "overlap", "exchange.chunk_rows": 10 ** 6}
    found = _same_as_reference(
        lambda p: p, ["AP-P009"], sorted_plan, jplan,
        cfg=sorted_cfg.with_overrides(over),
        jcfg=jplan[1].with_overrides(over))
    assert any(f.rule == "AP-P009" and "chunk_rows" in f.message
               for f in found)


def test_ap_c001_config_allowlist(tmp_path):
    from repro.analysis import check_config_modules as jcheck
    (tmp_path / "gemma2_9b.py").write_text("")
    (tmp_path / "amped_paper.py").write_text("")
    assert check_config_modules(str(tmp_path)) == []
    (tmp_path / "rogue_model.py").write_text("")
    found = check_config_modules(str(tmp_path))
    assert [f.rule for f in found] == ["AP-C001"]
    assert _triples(found) == _triples(jcheck(str(tmp_path)))
    # the port's own configs/ is fully classified
    assert check_config_modules() == []


# -- streaming split validation (AP-P007 deep path) --------------------------

@pytest.fixture(scope="module")
def stream_setup(port_tensor, tmp_path_factory, sorted_cfg):
    from repro_torch.store import TensorStore, write_store_from_coo
    path = str(tmp_path_factory.mktemp("astore") / "t.store")
    write_store_from_coo(port_tensor, path, chunk_nnz=256)
    cfg = sorted_cfg.with_overrides({"runtime.streaming": True,
                                     "runtime.memory_budget": 2 ** 20})
    return api.plan(TensorStore(path), cfg, device=CPU), cfg


def test_ap_p007_clean_split(stream_setup):
    plan, cfg = stream_setup
    assert check_plan(plan, cfg, rules=["AP-P007"]) == []
    assert check_plan(plan, cfg, deep=True) == []


def test_stream_plan_validate_against_tampered(stream_setup):
    from repro_torch.store.plan import split_mode_super_shards
    plan, cfg = stream_setup
    part = plan.modes[0]
    splan = split_mode_super_shards(part, cfg.runtime.memory_budget,
                                    buffers=cfg.runtime.stream_buffers)
    assert splan.validate_against(part, nmodes=plan.nmodes) == []
    bad = dataclasses.replace(splan, shard_bytes=splan.shard_bytes + 4)
    msgs = bad.validate_against(part, nmodes=plan.nmodes)
    assert any("byte model" in m for m in msgs)
    bad = dataclasses.replace(splan, budget_bytes=1)
    msgs = bad.validate_against(part, nmodes=plan.nmodes)
    assert any("exceed the budget" in m for m in msgs)
    wins = tuple(((t0 + 1, t1) if k == 0 and t1 > t0 + 1 else (t0, t1)
                  for k, (t0, t1) in enumerate(dev))
                 for dev in splan.windows)
    bad = dataclasses.replace(splan, windows=wins)
    msgs = bad.validate_against(part, nmodes=plan.nmodes)
    assert any("does not continue coverage" in m for m in msgs)


# -- recorded-operation audit (AH-*) -----------------------------------------

def _rec(op, shape=(), **kw):
    return OpRecord(op=op, out_shapes=(shape,) if shape else (), **kw)


def test_gather_free_excludes_copies():
    """Only row gathers count: the collectives' copies and the kernels'
    own reads are not gathered intermediates."""
    assert not gather_free([_rec("aten.index_select.default", (64, 8))])
    assert gather_free([_rec("aten.copy_.default", (64, 8))])
    assert gather_free([_rec("aten.index_select.default", (64, 8))],
                       nnz=64, rank=16)
    assert gather_free([])


def test_donation_and_permute_rules_have_no_counterpart():
    """AH-H003/AH-H004 audit compiler output that the eager port does not
    have: the module says so, no rule claims to check them, and the
    reference's ``donation_aliased`` is not ported."""
    import repro_torch.analysis as analysis
    doc = hlo_audit.__doc__
    assert "AH-H003" in doc and "AH-H004" in doc and "no counterpart" in doc
    assert not hasattr(analysis, "donation_aliased")
    assert not hasattr(hlo_audit, "donation_aliased")


def test_ah_h001_gather_in_fused_path():
    bad = [_rec("aten.index_select.default", (2048, 8),
                where="repro_torch/kernels/ops.py:1")]
    found = audit_ec_kernel("fused", nmodes=3, rank=8, recorded_ops=bad,
                            slots=2048)
    assert [f.rule for f in found] == ["AH-H001"]
    assert found[0].location == "kernel variant=fused"
    assert audit_ec_kernel("ref", nmodes=3, rank=8, recorded_ops=bad,
                           slots=2048) == []
    clean = [_rec("aten.copy_.default", (2048, 8))]
    assert audit_ec_kernel("sorted", nmodes=3, rank=8, recorded_ops=clean,
                           slots=2048) == []


def test_ec_kernel_audit_real_recordings(sorted_plan):
    """The real recordings: ref, fused and sorted are clean (AH-H001
    audits fused and sorted; the kernels' plain versions are not
    recorded), and the detector sees blocked's pre-gather."""
    part = sorted_plan.modes[0]
    for variant in ("ref", "fused", "sorted"):
        found = audit_ec_kernel(variant, nmodes=3, rank=8, tile=part.tile,
                                block_p=part.block_p, device=CPU)
        assert found == [], (variant, found)
    recs, slots = hlo_audit.ec_recorded_ops(
        "blocked", nmodes=3, rank=8, tile=part.tile, block_p=part.block_p,
        device=CPU)
    hits = hlo_audit.gathered_intermediates(recs, nnz=slots, rank=8)
    assert len(hits) == 2
    assert all(h.where.startswith("repro_torch/kernels/ops.py:")
               for h in hits)
    found = audit_ec_kernel("sorted", nmodes=3, rank=8, recorded_ops=recs,
                            slots=slots)
    assert [f.rule for f in found] == ["AH-H001"]


def _spec(plan, cfg):
    from repro_torch.comm.spec import resolve_exchange_spec
    return resolve_exchange_spec(cfg.exchange, plan=plan, rank=cfg.rank)


def test_wire_rule_applies_to_multi_device_only(sorted_plan, sorted_cfg):
    """The reference's expected markers: bf16 on the wire is asked of a
    multi-device update only (one device sends nothing)."""
    cfg = sorted_cfg.with_overrides({"exchange.variant": "overlap",
                                     "exchange.wire_dtype": "bfloat16"})
    spec = _spec(sorted_plan, cfg)
    audit = hlo_audit.audit_update_records
    assert [f.rule for f in audit([], mode=0, exchange_spec=spec,
                                  multi_device=True)] == ["AH-H005"]
    assert audit([], mode=0, exchange_spec=spec, multi_device=False) == []
    f32 = _spec(sorted_plan, sorted_cfg)
    assert audit([], mode=0, exchange_spec=f32, multi_device=True) == []


def test_ah_h002_h005_synthetic_records(sorted_plan, sorted_cfg):
    cfg = sorted_cfg.with_overrides({"exchange.variant": "overlap",
                                     "exchange.wire_dtype": "bfloat16"})
    spec = _spec(sorted_plan, cfg)
    audit = hlo_audit.audit_update_records
    wire = OpRecord("aten.copy_.default", in_dtypes=("bfloat16", "bfloat16"),
                    func="_send_into", where="repro_torch/comm/x.py:1")
    assert audit([wire], mode=0, exchange_spec=spec,
                 multi_device=True) == []
    # a host read of a device value (.item(), int() of a tensor)
    item = OpRecord("aten._local_scalar_dense.default",
                    where="repro_torch/core/als.py:7", func="f")
    found = audit([wire, item, item], mode=2, exchange_spec=spec,
                  multi_device=True)
    assert [f.rule for f in found] == ["AH-H002"]
    assert found[0].location == "mode=2 update"
    assert "repro_torch/core/als.py:7" in found[0].message
    # a sync the card reported inside an op, and a copy to the CPU
    synced = OpRecord("aten._linalg_eigh.default", sync=True,
                      where="repro_torch/core/als.py:100", func="_pinv_psd")
    to_cpu = OpRecord("aten._to_copy.default", in_devices=("cuda",),
                      out_devices=("cpu",), where="repro_torch/a.py:3")
    found = audit([wire, synced, to_cpu], mode=0, exchange_spec=spec,
                  multi_device=True)
    assert [f.rule for f in found] == ["AH-H002", "AH-H002"]
    assert "_pinv_psd" in found[0].message
    # f32 on the wire although bf16 was asked
    f32_wire = dataclasses.replace(wire, in_dtypes=("float32", "float32"))
    found = audit([f32_wire], mode=0, exchange_spec=spec, multi_device=True)
    assert [f.rule for f in found] == ["AH-H005"]


def test_sync_warnings_become_records():
    """Each sync the card reports (a warning raised where the call that
    synchronised returns) becomes a record at that line, named after the
    function the line's operations ran in; other warnings pass on."""
    import warnings
    with pytest.warns(UserWarning, match="unrelated"):
        with hlo_audit.record_ops() as recs:
            torch.ones(2).sum()
            line = __import__("inspect").currentframe().f_lineno + 1
            warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("unrelated", UserWarning)
    syncs = hlo_audit.host_syncs(recs)
    assert len(syncs) == 1 and syncs[0].op == "cuda-sync"
    assert syncs[0].where.endswith(f"test_torch_analysis.py:{line}")


def test_solver_audit_clean_single_device(port_tensor, sorted_cfg):
    plan = api.plan(port_tensor, sorted_cfg, device=CPU)
    with api.compile(plan, sorted_cfg, device=CPU) as solver:
        solver.run(1)
        before = [[f.clone() for f in reps] for reps in solver.state.factors]
        assert solver.audit() == []
        for reps, want in zip(solver.state.factors, before):
            for f, g in zip(reps, want):
                assert torch.equal(f, g)


def test_default_solver_audit_clean(port_tensor):
    cfg = api.DecomposeConfig(rank=8)
    plan = api.plan(port_tensor, cfg, device=CPU)
    with api.compile(plan, cfg, device=CPU) as solver:
        assert solver.audit() == []


def test_solver_audit_clean_multi_device(port_tensor):
    """4 logical CPU devices, overlap exchange on a bf16 wire: the audit
    sees bf16 sent and finds nothing; the exchange's byte counters and the
    state are as they were."""
    from repro_torch import comm
    from repro_torch.core.mttkrp import cp_mesh
    cfg = api.preset("sorted", FIXED).with_overrides({
        "runtime.num_devices": 4, "exchange.variant": "overlap",
        "exchange.wire_dtype": "bfloat16"})
    plan = api.plan(port_tensor, cfg, device=CPU)
    mesh = cp_mesh(4, plan.modes[0].r, devices=[CPU] * 4)
    with api.compile(plan, cfg, mesh=mesh) as solver:
        solver.run(1)
        comm.reset_sent_bytes()
        recs = hlo_audit.update_recorded_ops(solver, 0)
        assert any(r.func == "_send_into" and r.in_dtypes[1] == "bfloat16"
                   for r in recs)
        assert comm.sent_bytes(4)[0]["total_bytes"] == 0
        assert solver.audit() == []


def test_ah_h006_serving_retrace():
    from repro_torch.serve.engine import FactorSnapshot, ServingEngine
    rng = np.random.default_rng(0)
    snap = FactorSnapshot.from_arrays(
        [rng.normal(size=(s, 4)).astype(np.float32)
         for s in (32, 16, 8)],
        np.ones(4, np.float32), version=1, source="test", device=CPU)
    engine = ServingEngine(snap)
    engine.reconstruct_batch(np.zeros((3, 3), np.int64))
    assert audit_serving_engine(engine) == []
    engine._reconstruct_shapes.add(37)
    found = audit_serving_engine(engine)
    assert any(f.rule == "AH-H006" for f in found)


# -- concurrency lint (AC-*) -------------------------------------------------

_GUARDED = '''
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0  # guarded-by: _lock
    def bump(self):
        {body}
'''


def test_ac_l001_unguarded_access():
    found = lint_source(_GUARDED.format(body="self.count += 1"), "f.py")
    assert [f.rule for f in found] == ["AC-L001"]
    assert "f.py:8" in found[0].location


def test_ac_l001_with_block_ok():
    src = _GUARDED.format(
        body="with self._lock:\n            self.count += 1")
    assert lint_source(src, "f.py") == []


def test_ac_l001_holds_annotation_ok():
    src = _GUARDED.format(body="self.count += 1").replace(
        "def bump(self):", "def bump(self):  # holds: _lock")
    assert lint_source(src, "f.py") == []


def test_ac_l001_closure_does_not_inherit_lock():
    src = _GUARDED.format(body="""with self._lock:
            def later():
                return self.count
            return later""")
    found = lint_source(src, "f.py")
    assert [f.rule for f in found] == ["AC-L001"]


def test_ac_l002_l003_unknown_locks():
    src = '''
class C:
    def __init__(self):
        self.x = 0  # guarded-by: _missing
    def get(self):  # holds: _also_missing
        return 1
'''
    rules = sorted(f.rule for f in lint_source(src, "f.py"))
    assert rules == ["AC-L002", "AC-L003"]


def test_ac_l000_syntax_error():
    found = lint_source("def broken(:\n", "f.py")
    assert [f.rule for f in found] == ["AC-L000"]


def test_default_targets_lint_clean():
    """The port's own thread-using modules, the serving batcher among
    them, are clean, and each carries annotations the lint reads."""
    import repro_torch
    from repro_torch.analysis import DEFAULT_TARGETS, lint_default_targets
    assert lint_default_targets() == []
    root = list(repro_torch.__path__)[0]
    assert "serve/batcher.py" in DEFAULT_TARGETS
    for rel in DEFAULT_TARGETS:
        with open(os.path.join(root, rel)) as fh:
            assert "# guarded-by:" in fh.read(), rel


def test_lint_finds_seeded_defect_in_port_batcher():
    import repro_torch.serve.batcher as batcher
    with open(batcher.__file__) as fh:
        src = fh.read()
    bad = src.replace("""        with self._cv:
            stranded, self._queue = self._queue, []""",
                      """        stranded, self._queue = self._queue, []""")
    assert bad != src
    found = lint_source(bad, "batcher.py")
    assert found and {f.rule for f in found} == {"AC-L001"}


def test_subclass_inherits_guards():
    src = _GUARDED.format(body="pass") + '''
class D(C):
    def bump2(self):
        self.count -= 1
'''
    found = lint_source(src, "f.py")
    assert [f.rule for f in found] == ["AC-L001"]


# -- runtime lock assertions -------------------------------------------------

def test_assert_holds_disabled_noop(monkeypatch):
    monkeypatch.delenv(runtime.ENV_ASSERT, raising=False)
    runtime.assert_holds(threading.Lock(), "_lock")


def test_assert_holds_enabled(monkeypatch):
    monkeypatch.setenv(runtime.ENV_ASSERT, "1")
    lock = threading.Lock()
    with pytest.raises(LockNotHeldError):
        runtime.assert_holds(lock, "_lock")
    with lock:
        runtime.assert_holds(lock, "_lock")
    rlock = threading.RLock()
    with pytest.raises(LockNotHeldError):
        runtime.assert_holds(rlock, "_rlock")
    with rlock:
        runtime.assert_holds(rlock, "_rlock")


def test_streamer_trackers_require_stats_lock(monkeypatch):
    from repro_torch.core.mttkrp import cp_mesh
    from repro_torch.sparse import stream
    from repro_torch.sparse.stream import _StreamerBase
    # the streamer takes the one lock check of the analysis package
    assert stream.assert_holds is runtime.assert_holds
    assert stream.LockNotHeldError is LockNotHeldError
    monkeypatch.setenv(runtime.ENV_ASSERT, "1")
    s = _StreamerBase(cp_mesh(1, 1, devices=[CPU]), prefetch=1)
    try:
        with pytest.raises(LockNotHeldError):
            s._track_add("k")
        with s._stats_lock:
            s._track_add("k")
            s._track_drop("k")
    finally:
        s.close()


def test_window_spill_counters(tmp_path):
    from repro_torch.sparse.stream import WindowSpill
    arrs = tuple(np.arange(3, dtype=np.int32) for _ in range(5))
    with WindowSpill(str(tmp_path / "spill")) as sp:
        assert sp.load(0, 0, (0, 0, 2, 6, 2)) is None
        sp.save(0, 0, (0, 0, 2, 6, 2), arrs)
        assert sp.load(0, 0, (0, 0, 2, 6, 2)) is not None
        assert sp.counters() == (1, 1)


def test_batcher_close_rejects_queued():
    from repro_torch.serve.batcher import MicroBatcher, RejectedError
    started, release = threading.Event(), threading.Event()

    def handler(idx):
        started.set()
        release.wait(timeout=10)
        return np.zeros(idx.shape[0], np.float32)

    b = MicroBatcher(handler, max_delay_s=0.0)
    errs = []

    def submit():
        try:
            b.submit(np.zeros((1, 3), np.int64), deadline_s=10.0)
        except RejectedError as e:
            errs.append(e)

    t1 = threading.Thread(target=submit)
    t1.start()
    assert started.wait(timeout=5)
    t2 = threading.Thread(target=submit)
    t2.start()
    for _ in range(500):
        with b._cv:
            if b._queue:
                break
        time.sleep(0.01)
    threading.Timer(0.2, release.set).start()
    b.close()
    t1.join(timeout=5)
    t2.join(timeout=5)
    assert errs, "queued request must fail with RejectedError on close"
    with pytest.raises(RejectedError):
        b.submit(np.zeros((1, 3), np.int64))


def test_checkpoint_async_exception_surfaced(tmp_path, monkeypatch):
    from repro_torch.training.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(mgr, "_save_sync_flat",
                        lambda *a: (_ for _ in ()).throw(IOError("disk")))
    mgr.save(1, {"a": np.zeros(2)}, block=False)
    with pytest.raises(IOError):
        mgr.wait()
    mgr.wait()


def test_mode_histogram_owns_its_data(port_tensor, tmp_path):
    from repro_torch.store import TensorStore, write_store_from_coo
    path = str(tmp_path / "h.store")
    write_store_from_coo(port_tensor, path, chunk_nnz=256)
    hist = TensorStore(path).mode_histogram(0)
    assert not isinstance(hist, np.memmap)
    assert hist.base is None


# -- api wiring --------------------------------------------------------------

def test_plan_analyze_modes(port_tensor, sorted_cfg, monkeypatch, tmp_path):
    assert api.plan(port_tensor, sorted_cfg, analyze="warn",
                    device=CPU) is not None
    with pytest.raises(ValueError):
        api.plan(port_tensor, sorted_cfg, analyze="nope", device=CPU)
    import repro_torch.analysis as analysis
    monkeypatch.setattr(
        analysis, "check_plan",
        lambda p, c, **kw: [Finding("AP-TEST", "error", "seeded")])
    with pytest.raises(AnalysisError) as ei:
        api.plan(port_tensor, sorted_cfg, analyze="strict", device=CPU)
    assert "AP-TEST" in str(ei.value)
    assert api.plan(port_tensor, sorted_cfg, analyze="warn",
                    device=CPU) is not None
    # a cache hit is analysed too
    cache = str(tmp_path / "plans")
    monkeypatch.undo()
    api.plan(port_tensor, sorted_cfg, cache_dir=cache, device=CPU)
    monkeypatch.setattr(
        analysis, "check_plan",
        lambda p, c, **kw: [Finding("AP-TEST", "error", "seeded")])
    with pytest.raises(AnalysisError):
        api.plan(port_tensor, sorted_cfg, cache_dir=cache,
                 analyze="strict", device=CPU)


def test_api_exports_analysis_types():
    from repro_torch.analysis import model
    assert api.AnalysisError is model.AnalysisError
    assert api.Finding is model.Finding


def test_solver_import_loads_only_model_and_runtime():
    """``repro_torch.api`` and the streamer need only the findings' types
    and the lock helper: the package loads its passes on first use, and
    every name of ``__all__`` still resolves."""
    import subprocess
    import sys
    code = (
        "import sys, repro_torch.api, repro_torch.sparse.stream\n"
        "got = sorted(m for m in sys.modules\n"
        "             if m.startswith('repro_torch.analysis.'))\n"
        "assert got == ['repro_torch.analysis.model',\n"
        "               'repro_torch.analysis.runtime'], got\n"
        "import repro_torch.analysis as a\n"
        "ns = {}\n"
        "exec('from repro_torch.analysis import *', ns)\n"
        "assert set(a.__all__) <= set(ns), set(a.__all__) - set(ns)\n"
        "print('lazy')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "lazy" in out.stdout


def test_launcher_analyze_strict(capsys, monkeypatch):
    from repro_torch.launch.decompose import main
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", "")
    main(["--preset", "sorted", "--scale", "2e-5", "--rank", "8",
          "--iters", "1", "--device", "cpu", "--analyze", "strict"])
    out = capsys.readouterr().out
    assert "analysis:" not in out and "1 sweeps" in out


def test_variant_smem_model():
    kw = dict(tile=8, nin=2, num_buffers=2)
    assert variant_smem_bytes("ref", rank=32, **kw) == 0
    blocked = variant_smem_bytes("blocked", rank=32, **kw)
    fused = variant_smem_bytes("fused", rank=32, **kw)
    srt = variant_smem_bytes("sorted", rank=32, **kw)
    # blocked and fused stage the same words; sorted adds its descriptors
    assert 0 < blocked == fused < srt
    assert variant_smem_bytes("fused", rank=64, **kw) > fused


# -- baseline + CLI contract -------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    f1 = Finding("AC-L001", "error", "msg", "f.py:8")
    f2 = Finding("AP-P001", "error", "msg", "mode=0")
    path = str(tmp_path / "b.json")
    save_baseline(path, [f1])
    kept, suppressed = apply_baseline([f1, f2], load_baseline(path))
    assert kept == [f2] and suppressed == [f1]


def test_cli_usage_error_exits_2():
    with pytest.raises(SystemExit) as ei:
        analysis_main(["--preset", "sorted", "--all-presets"])
    assert ei.value.code == 2


def test_cli_clean_fast_run(capsys, monkeypatch):
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", "")
    rc = analysis_main(["--skip-compile", "--preset", "paper",
                        "--scale", "2e-5", "--rank", "8", "--device", "cpu"])
    assert rc == 0
    assert "analysis: clean" in capsys.readouterr().out


def test_cli_full_scenarios_clean(capsys, monkeypatch):
    """The sorted preset compiled and audited, with the streaming and
    serving scenarios, on the CPU."""
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", "")
    rc = analysis_main(["--preset", "sorted", "--scale", "2e-5", "--rank",
                        "8", "--device", "cpu", "--streaming", "--serving"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "serving bucket scenario" in out and "analysis: clean" in out


def test_cli_seeded_defect_and_baseline(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("AMPED_TORCH_AUTOTUNE_CACHE", "")
    bad = tmp_path / "bad.py"
    bad.write_text(_GUARDED.format(body="self.count += 1"))
    args = ["--skip-compile", "--scale", "2e-5", "--rank", "8",
            "--device", "cpu", "--lint-file", str(bad)]
    rc = analysis_main(args)
    out = capsys.readouterr().out
    assert rc == 1 and "AC-L001" in out
    base = str(tmp_path / "base.json")
    assert analysis_main(args + ["--write-baseline", base]) == 0
    rc = analysis_main(args + ["--baseline", base])
    out = capsys.readouterr().out
    assert rc == 0 and "baselined" in out
