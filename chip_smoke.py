#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # amazon profile at scale 3e-2, rank 32

Phases, each of which exits non-zero on failure:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles the EC kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and prints the ``-Xptxas -v``
   register / shared-memory / spill lines.
3. Data: generates the ``amazon`` profile (seed 0) and plans it with the
   ``sorted`` preset at rank 32, tile 8, block_p 128 on one device; prints
   per mode the largest tile run, and the work items that all three kernels
   launch over (``_build.tile_chunks``: their number and the largest in
   blocks, which must be at most ``CHUNK_BLOCKS``).
4. Kernel parity: for every mode, runs ``ec_sorted``, ``ec_fused`` and
   ``ec_blocked`` on that mode's shard and holds each against its plain
   PyTorch version on the card, run under
   ``torch.use_deterministic_algorithms(True)`` so that its ``index_add_``
   sums in index order as the kernels do: slot order, and on runs longer
   than ``CHUNK_BLOCKS`` blocks the fixed two-level order (per-chunk
   partials, then the chunks in order), which the plain versions follow
   too. Every kernel must match bitwise, and ``ec_blocked`` must give
   ``ec_fused``'s bits (one kernel body, one order). The default atomic
   ``index_add_`` sums in an order that changes from run to run and
   differs by a few 1e-5 of max|plain| on this profile's hot rows of ~3 M
   terms; it is timed, and its difference recorded. Each kernel is also
   held against the slot-order ``ref`` (the semantic oracle,
   deterministic) to 1e-4·max|ref|: the two-level order regroups those
   rows' sums. Each kernel's arguments come from ``ops.kernel_args``, as on
   the main path, and the same launch through ``ops.mttkrp_local`` (with
   its unvisited-tile masking) must give the same bits. On mode 0 each
   kernel must also equal the plain version on the CPU bitwise. A 5-mode
   ``twitch`` case covers nin = 4. Each kernel and plain version (default,
   atomic mode) is timed with CUDA events (warm-up, then the median of 20
   runs), and so are the main path's whole EC for the mode
   (``ops.mttkrp_local``) and its argument building (``ops.kernel_args``).
   On mode 0 each kernel is also timed at every ring depth of its item
   kernel (2-4 stages), each bitwise equal to the first launch.
5. Main path: ``api.compile(plan, cfg).run(5)`` with ``kernel.variant``
   ``sorted``, then 2 sweeps each with ``fused`` and ``blocked`` on the same
   plan. Launch counters are set to 0 just before each run and read just
   after; fits must be finite and non-decreasing, ``blocked``'s must equal
   ``fused``'s, and both must agree with ``sorted``'s to 1e-4 (``sorted``
   regroups the hot rows' sums otherwise than the one-hot variants).
6. Multi-device path: the same tensor planned for 4 devices with the
   ``sorted`` preset (prints the ``r`` its auto replication picks, and
   plans again at r = 2 when that is 1, so that the merge runs), each plan
   compiled on ``cp_mesh(4, r, devices=["cuda:0"] * 4)``: four logical
   devices on ONE card, whose exchange is device-to-device copies in one
   card's memory, not NVLink. (``--cards 4`` puts logical device k on
   ``cuda:k`` instead, on a machine with four cards.) 3 sweeps with the
   default exchange (``ring``, fp32), then 2 each with ``allgather``,
   ``overlap`` and ``overlap`` on a bf16 wire, and 2 each of ``fused``
   and ``blocked``. Counts are set to 0 just before each run and read
   just after: the kernel must have launched once per mode, device and
   sweep; fits finite, non-decreasing and within 1e-4 of the one-device
   run (bf16: within 0.08 of fp32); every replica bitwise equal; the fp32
   gathers' factors bitwise equal to ``ring``'s; ``blocked``'s fits equal
   to ``fused``'s; the bytes that each logical device sent equal to
   ``modelled_exchange_bytes``. Device 0's shard of mode 0 must give
   ``ec_sorted``'s plain bits on the card. Per run it prints the steady
   sweep time, per mode the EC and the exchange (merge + gather) ms from
   CUDA events, the peak allocation and the plan seconds.
7. Rebalance: the dynamic load balancer on 4 logical devices of one card
   (``--cards 4``: on ``cuda:k``), ``sorted`` preset, rank 32, with
   ``cadence=1``, ``imbalance_threshold=1.1``, ``migration_budget=0.4`` and
   ``probe_repeats=2``. (a) The multi-device phase's r = 2 amazon plan;
   (b) the hot-index tensor of tests/test_schedule_multidevice.py scaled
   25x in nonzeros and mode-0 size (and 5x in modes 1-2, so that its 3 hot
   indices keep 30 % of the nonzeros after duplicates merge), planned
   ``equal_nnz`` (one group of 4). Each case runs ``"off"`` for 6 sweeps,
   ``"measure"`` for 4 (factors and fits bitwise those of ``"off"`` after 4)
   and ``"on"`` for 6 (fits within 1e-4 of ``"off"``, and for (a) of the
   one-device run). Counts are set to 0 just before each run and read
   just after; the solver counts each rebalance point's probe launches
   as they run. The probes must have launched ``ec_sorted`` once per mode
   and device for the warm-up and each repeat, and nothing else; the rest
   of the run once per mode, device and sweep. Replicas stay bitwise equal. Per rebalance point it prints the
   per-mode, per-device probe ms, the max/mean imbalance measured (EWMA
   and raw) and modelled, migrations, moved nnz, the epoch after, and the
   host seconds of the probes, the apply and the re-placement. Where
   nonzeros moved, the placed shards must be the new plan's arrays, each
   group must hold the same nonzeros in the same order member after member
   (so each is covered once), and device 0's shard must give
   ``ec_sorted``'s plain bits on the card. (b) must migrate; (a) records
   whether it did.
8. Summary: one JSON line ``{"kernels": [...]}`` (``ms``, ``plain_ms`` and
   ``bound_ms`` summed over the three modes, i.e. one sweep's launches;
   ``launches`` from the main-path run, ``multi_device_launches`` from the
   multi-device path's, ``rebalance_launches`` from the rebalance phase's
   ``"measure"`` and ``"on"`` runs, of which ``rebalance_probe_launches``
   were counted around the probes), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``. With ``--out PATH`` every per-mode
   number also goes to a JSON file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way per card
RTOL = 1e-5
REF_RTOL = 1e-4  # kernel vs the slot-order ref: long runs are regrouped
SWEEPS = 5
AB_SWEEPS = 2
FIT_TOL = 1e-4
KERNELS = ("ec_sorted", "ec_fused", "ec_blocked")
REPLACES = {
    "ec_sorted": "src/repro/kernels/mttkrp_sorted.py:133",
    "ec_fused": "src/repro/kernels/mttkrp_fused.py:128",
    "ec_blocked": "src/repro/kernels/mttkrp_pallas.py:66",
}
SOURCE = {
    "ec_sorted": "src/repro_torch/kernels/csrc/ec_sorted.cu",
    "ec_fused": "src/repro_torch/kernels/csrc/ec_fused.cu",
    "ec_blocked": "src/repro_torch/kernels/csrc/ec_blocked.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_START = time.perf_counter()


def phase(name: str) -> None:
    """Print a phase's header with the seconds since the smoke started."""
    print(f"== {name} (t={time.perf_counter() - _START:.1f} s)", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def largest_run(b2t: np.ndarray) -> int:
    """Blocks in the longest run of equal block_to_tile (the hot tile)."""
    starts = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    return int(np.diff(starts).max())


def work_items(b2t: np.ndarray) -> tuple[int, int]:
    """(number of work items, blocks in the largest) of the three kernels,
    from the bookkeeping their wrappers launch over, on the card."""
    import torch
    from repro_torch.kernels import _build
    starts = _build.tile_chunks(torch.from_numpy(b2t).cuda()).item_starts
    starts = starts.cpu().numpy()
    n = int((starts < b2t.size).sum())
    return n, int(np.diff(starts[:n + 1]).max())


def kernel_cases(dev, part, factors, mode):
    """The three kernels' wrappers and plain versions, bound to one mode's
    arrays by ``ops.kernel_args`` (what the main path's dispatch feeds
    them), plus the bytes each must move at least (every input read once —
    distinct factor rows only — and the output written once) and its f32
    operations."""
    import torch
    from repro_torch.kernels import (mttkrp_blocked, mttkrp_fused,
                                     mttkrp_sorted, ops)
    arrays = (dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
              factors)
    kw = dict(mode=mode, tile=part.tile, seg_starts=dev.seg_starts,
              seg_rows=dev.seg_rows)
    sargs = ops.kernel_args("sorted", *arrays, **kw)
    fargs = ops.kernel_args("fused", *arrays, **kw)
    bargs = ops.kernel_args("blocked", *arrays, **kw)
    idx = sargs[4]
    nin = idx.shape[1]
    nnz = dev.values.numel()
    nb = dev.block_to_tile.numel()
    rank = factors[0].shape[1]
    geo = dict(num_rows=part.rows_max, tile=part.tile, block_p=part.block_p)
    distinct = sum(int(torch.unique(idx[:, j]).numel())
                   for j in range(nin)) * rank * 4
    common = nnz * 4 + nb * 4 + (nb + 1) * 4 + part.rows_max * rank * 4
    flops = nnz * rank * (nin + 1)
    return {
        "ec_sorted": (mttkrp_sorted.ec_sorted, mttkrp_sorted.ec_sorted_plain,
                      sargs, geo,
                      common + idx.numel() * 4 + dev.seg_starts.numel() * 4
                      + dev.seg_rows.numel() * 4 + distinct, flops),
        "ec_fused": (mttkrp_fused.ec_fused, mttkrp_fused.ec_fused_plain,
                     fargs, geo,
                     common + idx.numel() * 4 + nnz * 4 + distinct, flops),
        "ec_blocked": (mttkrp_blocked.ec_blocked,
                       mttkrp_blocked.ec_blocked_plain, bargs, geo,
                       common + nnz * 4 + nin * nnz * rank * 4, flops),
    }


def ring_depths(name, kern, args, geo, got) -> dict:
    """The kernel's ms at every ring depth its item kernel takes (2 to
    ``MAX_NUM_BUFFERS``; ``ec_blocked``'s wrapper fixes one, so its launch
    function is called), each launch bitwise equal to ``got``."""
    import torch
    from repro_torch.kernels import _build, mttkrp_blocked
    ms = {}
    for depth in range(2, _build.MAX_NUM_BUFFERS + 1):
        launch = mttkrp_blocked._launch if name == "ec_blocked" else kern

        def run():
            return launch(*args, num_buffers=depth, **geo)

        if not torch.equal(run(), got):
            fail(f"{name}: ring depth {depth} changes the bits")
        ms[depth] = time_ms(run)
    return ms


@contextlib.contextmanager
def slot_order():
    """CUDA ``index_add_`` in slot order (its deterministic algorithm)."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def check_close(name: str, got, ref) -> float:
    import torch
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got, ref, rtol=RTOL, atol=RTOL * scale):
        fail(f"{name}: max |kernel - plain| = {err:.3e} exceeds rtol "
             f"{RTOL} / atol {RTOL * scale:.3e}")
    return err


def parity(plan, rank: int, *, timed: bool, bitwise_mode: int | None,
           label: str):
    """Phase 4 on one plan: every kernel on every mode against its plain
    version. Returns per-kernel, per-mode records."""
    import torch
    from repro_torch.core import als, mttkrp
    from repro_torch.kernels import ops
    mesh = mttkrp.cp_mesh(1, 1, devices=["cuda"])
    factors = [f[0] for f in als.init_factors(plan, rank, seed=1,
                                              devices=mesh.devices)]
    recs = {k: [] for k in KERNELS}
    for mode, part in enumerate(plan.modes):
        outs = {}
        dev = mttkrp.shard_plan_mode(part, mesh)[0]
        cases = kernel_cases(dev, part, factors, mode)
        # the semantic oracle: slot-order ref, deterministic on the card
        with slot_order():
            slot_ref = ops.mttkrp_local(
                dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
                factors, mode=mode, variant="ref", num_rows=part.rows_max,
                tile=part.tile, block_p=part.block_p)
        for name, (kern, plain, args, geo, nbytes, flops) in cases.items():
            got = kern(*args, **geo)
            # the same launch through the main path's dispatch, with its
            # unvisited-tile masking: the kernels are deterministic, and
            # the tiles no run visits are 0 either way
            variant = name[len("ec_"):]
            arrays = (dev.indices, dev.values, dev.local_rows,
                      dev.block_to_tile, factors)
            seg = dict(seg_starts=dev.seg_starts, seg_rows=dev.seg_rows)

            def dispatch():
                return ops.mttkrp_local(*arrays, mode=mode, variant=variant,
                                        tile_mask=dev.tile_visited, **seg,
                                        **geo)

            via = dispatch()
            if not torch.equal(via, got):
                fail(f"{label} {name} mode {mode}: mttkrp_local differs from "
                     f"the wrapper on the same inputs")
            del via
            with slot_order():
                ref = plain(*args, **geo)
            torch.cuda.synchronize()
            err = check_close(f"{label} {name} mode {mode}", got, ref)
            bitwise_on_card = bool(torch.equal(got, ref))
            if not bitwise_on_card:
                fail(f"{label} {name} mode {mode} is not bitwise equal to "
                     f"its deterministic plain version on the card")
            outs[name] = got
            if name == "ec_blocked" and not torch.equal(got,
                                                        outs["ec_fused"]):
                fail(f"{label} ec_blocked mode {mode} differs from ec_fused")
            d_slot = float((got - slot_ref).abs().max())
            scale = float(slot_ref.abs().max())
            if d_slot > REF_RTOL * scale:
                fail(f"{label} {name} mode {mode}: max |kernel - ref| = "
                     f"{d_slot:.3e} exceeds {REF_RTOL} * max|ref| = "
                     f"{REF_RTOL * scale:.3e}")
            rec = {"mode": mode, "max_abs_err": err,
                   "max_abs_ref": float(ref.abs().max()),
                   "bitwise_on_card": bitwise_on_card,
                   "max_abs_diff_slot_order": d_slot,
                   "rel_diff_slot_order": d_slot / scale if scale else 0.0,
                   "bytes": nbytes, "flops": flops,
                   "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         flops / F32_FLOPS_PER_S),
                   "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / F32_FLOPS_PER_S
                                else "operations")}
            if mode == bitwise_mode:
                cpu_args = [[a.cpu() for a in x] if isinstance(x, list)
                            else x.cpu() for x in args]
                ref_cpu = plain(*cpu_args, **geo)
                rec["bitwise"] = bool(torch.equal(got.cpu(), ref_cpu))
                if not rec["bitwise"]:
                    d = float((got.cpu() - ref_cpu).abs().max())
                    fail(f"{name} mode {mode} is not bitwise equal to the "
                         f"CPU plain version (max diff {d:.3e})")
                del ref_cpu, cpu_args
            if timed:
                rec["ms"] = time_ms(lambda: kern(*args, **geo))
                rec["plain_ms"] = time_ms(lambda: plain(*args, **geo))
                # the main path's whole EC for this mode, and the argument
                # building (index compaction, pre-gather) inside it
                rec["dispatch_ms"] = time_ms(dispatch)
                rec["args_ms"] = time_ms(lambda: ops.kernel_args(
                    variant, *arrays, mode=mode, tile=part.tile, **seg))
                # recorded, not checked: the default (atomic) plain path
                rec["max_abs_diff_atomic"] = float(
                    (got - plain(*args, **geo)).abs().max())
            if timed and mode == bitwise_mode:
                rec["ring_ms"] = ring_depths(name, kern, args, geo, got)
            recs[name].append(rec)
            print(f"{label} {name} mode {mode}: max_abs_err={err:.3e} "
                  f"(max|plain|={rec['max_abs_ref']:.3e}, bitwise on card "
                  f"{rec['bitwise_on_card']}; max|kernel - slot-order ref| "
                  f"= {rec['rel_diff_slot_order']:.2e} of max|ref|)"
                  + (f" bitwise={rec['bitwise']}" if "bitwise" in rec else "")
                  + (f" ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.3f}"
                     f" bound_ms={rec['bound_ms']:.3f} |kernel - atomic "
                     f"plain|={rec['max_abs_diff_atomic']:.3e} "
                     f"mttkrp_local_ms={rec['dispatch_ms']:.3f} "
                     f"kernel_args_ms={rec['args_ms']:.3f}"
                     if timed else "")
                  + (f" ring_ms={rec['ring_ms']}" if "ring_ms" in rec
                     else ""),
                  flush=True)
            del got, ref
        del dev, cases, slot_ref, outs
        torch.cuda.empty_cache()
    return recs


def run_solver(api, plan, cfg, sweeps: int, label: str):
    import torch
    from repro_torch.kernels import _build
    solver = api.compile(plan, cfg)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    wall = []
    for k in range(1, sweeps + 1):  # run() resumes: one more sweep each
        t0 = time.perf_counter()
        res = solver.run(k)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    counts = dict(_build.LAUNCHES)
    fits = np.asarray(res.fits)
    print(f"{label}: sweep wall times {[round(w, 4) for w in wall]} s; "
          f"fits {[round(float(f), 6) for f in fits]}; launches {counts}",
          flush=True)
    if fits.shape != (sweeps,) or not np.isfinite(fits).all():
        fail(f"{label}: fits {fits} are not {sweeps} finite values")
    del solver
    torch.cuda.empty_cache()
    return fits, counts, wall


MD_DEVICES = 4
MD_SWEEPS = 3       # the default exchange (ring, fp32)
MD_AB_SWEEPS = 2    # each other exchange
MD_KERNEL_SWEEPS = 2  # ec_fused and ec_blocked on the same plan
BF16_FIT_TOL = 0.08  # the reference's own bf16-vs-fp32 bound
EXCHANGES = {
    "ring": {"exchange.variant": "ring"},
    "allgather": {"exchange.variant": "allgather"},
    "overlap": {"exchange.variant": "overlap"},
    "overlap_bf16": {"exchange.variant": "overlap",
                     "exchange.wire_dtype": "bfloat16"},
}


def sync_all() -> None:
    import torch
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def time_host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn`` with every card synchronised before
    and after: work spread over several cards has no one stream whose
    events bracket it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def stage_ms(solver) -> list[dict]:
    """Per mode, on the solver's current factors: the EC of every logical
    device (``MTTKRPFn.local``) and the merge plus gather
    (``MTTKRPFn.exchange``), each timed with CUDA events on one card, with
    the host clock across cards."""
    one_card = len({d.index for d in solver.mesh.devices}) == 1
    timer = time_ms if one_card else time_host_ms
    out = []
    for d, upd in enumerate(solver.updates):
        fn, dev = upd.mttkrp_fn, solver.dev_arrays[d]
        factors = solver.state.factors
        partials = fn.local(dev, factors)
        out.append({"ec_ms": timer(lambda: fn.local(dev, factors), reps=10),
                    "exchange_ms": timer(lambda: fn.exchange(partials),
                                         reps=10)})
    return out


def multi_device_run(api, plan, cfg, mesh, sweeps: int, label: str, *,
                     variant: str = "sorted") -> dict:
    """One 4-logical-device run: counts set to 0 just before it, read just
    after; checks launches, fits, replicas and the counted exchange bytes;
    then times the stages."""
    import torch
    from repro_torch import comm
    from repro_torch.kernels import _build
    cards = sorted({d.index for d in mesh.devices})
    torch.cuda.empty_cache()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    solver = api.compile(plan, cfg, mesh=mesh)
    sync_all()
    _build.reset_launch_counts()
    comm.reset_sent_bytes()
    wall, snap = [], {}
    for k in range(1, sweeps + 1):  # run() resumes: one more sweep each
        t0 = time.perf_counter()
        res = solver.run(k)
        sync_all()
        wall.append(time.perf_counter() - t0)
        if k == MD_AB_SWEEPS:
            snap = {"factors": res.factors, "fits": list(res.fits)}
    counts = dict(_build.LAUNCHES)
    sent = [s["total_bytes"] for s in comm.sent_bytes(mesh.num_devices)]
    peak = max(torch.cuda.max_memory_allocated(c) for c in cards)
    fits = np.asarray(res.fits)
    name = f"ec_{variant}"
    want = plan.nmodes * mesh.num_devices * sweeps
    if counts[name] != want:
        fail(f"{label}: {name} launched {counts[name]} times, expected "
             f"{plan.nmodes} modes x {mesh.num_devices} devices x {sweeps} "
             f"sweeps = {want}")
    if fits.shape != (sweeps,) or not np.isfinite(fits).all():
        fail(f"{label}: fits {fits} are not {sweeps} finite values")
    if (np.diff(fits) < -FIT_TOL).any():
        fail(f"{label}: fits decrease: {fits}")
    st = solver.state
    for reps in st.factors + st.grams + [st.lam, st.replica_fits]:
        if not all(torch.equal(reps[0], x.to(reps[0].device))
                   for x in reps[1:]):
            fail(f"{label}: the replicas hold different bits")
    spec = solver.exchange_spec
    modelled = comm.modelled_exchange_bytes(plan, cfg.rank,
                                            wire_dtype=spec.wire_dtype)
    if sent != [modelled["sweep_total_bytes"] * sweeps] * mesh.num_devices:
        fail(f"{label}: the logical devices sent {sent} B, the model says "
             f"{modelled['sweep_total_bytes']} B x {sweeps} sweeps each")
    stages = stage_ms(solver)
    bounds = [exchange_bound_ms(mesh, m["total_bytes"])
              for m in modelled["per_mode"]]
    rec = {"label": label, "variant": variant, "r": mesh.r,
           "exchange": {"variant": spec.variant, "merge": spec.merge,
                        "chunk_rows": spec.chunk_rows,
                        "wire_dtype": spec.wire_dtype},
           "fits": fits.tolist(), "sweep_wall_s": wall,
           "steady_sweep_s": float(np.median(wall[1:] or wall)),
           "launches": counts[name], "sent_bytes_per_device": sent,
           "modelled_bytes_per_sweep": modelled["sweep_total_bytes"],
           "modelled_per_mode": modelled["per_mode"],
           "stages_per_mode": stages, "exchange_bound_ms": bounds,
           "ec_ms_sum": sum(x["ec_ms"] for x in stages),
           "exchange_ms_sum": sum(x["exchange_ms"] for x in stages),
           "peak_alloc_bytes": peak}
    print(f"{label}: r={mesh.r} {spec.variant}/{spec.merge} wire="
          f"{spec.wire_dtype}: sweep wall times "
          f"{[round(w, 4) for w in wall]} s (steady "
          f"{rec['steady_sweep_s']:.4f} s); fits "
          f"{[round(float(f), 6) for f in fits]}; {name} launches "
          f"{counts[name]}; each device sent {sent} B = "
          f"model {modelled['sweep_total_bytes']} B x {sweeps}; per mode "
          f"EC ms {[round(x['ec_ms'], 3) for x in stages]}, exchange ms "
          f"{[round(x['exchange_ms'], 3) for x in stages]}, its bound "
          f"{[round(b, 3) for b in bounds]} ({where(mesh)}); peak alloc "
          f"per card {peak / 2**30:.2f} GiB", flush=True)
    del solver
    torch.cuda.empty_cache()
    return rec, snap


def exchange_bound_ms(mesh, sent_per_device: int) -> float:
    """The least time of one mode's exchange: on one card every byte sent
    is read and written once in its memory; across cards each card sends
    its bytes over its own NVLink at once."""
    if len({d.index for d in mesh.devices}) == 1:
        return (1e3 * 2 * sent_per_device * mesh.num_devices
                / HBM_BYTES_PER_S)
    return 1e3 * sent_per_device / NVLINK_BYTES_PER_S


def where(mesh) -> str:
    """Where the mesh's logical devices lie, and so what its copies are."""
    cards = sorted({d.index for d in mesh.devices})
    if len(cards) == 1:
        return (f"{mesh.num_devices} logical devices on one card: "
                f"device-to-device copies, not NVLink")
    return (f"{mesh.num_devices} logical devices on {len(cards)} cards: "
            f"peer copies between cards")


def multi_device(api, tensor, cfg, one_dev_fits, cards: int) -> dict:
    """The multi-device path: the same tensor planned for 4 devices (the
    ``sorted`` preset's auto replication, and r = 2 besides when that picks
    r = 1), each plan run on 4 logical devices (logical device k on
    ``cuda:0`` or, with 4 cards, on ``cuda:k``) with every exchange
    schedule, and ``ec_fused``/``ec_blocked`` for two sweeps."""
    import torch
    from repro_torch.core import als, mttkrp
    from repro_torch.kernels import mttkrp_sorted
    mcfg = cfg.with_overrides({"runtime.num_devices": MD_DEVICES,
                               "partition.replication": None})
    t0 = time.perf_counter()
    mplan = api.plan(tensor, mcfg)
    plans = [(mcfg, mplan, time.perf_counter() - t0)]
    r_auto = mplan.modes[0].r
    print(f"auto replication for {MD_DEVICES} devices picked r={r_auto} "
          f"(plan {plans[0][2]:.1f} s)", flush=True)
    if r_auto == 1:
        rcfg = mcfg.with_overrides({"partition.replication": 2})
        t0 = time.perf_counter()
        plans.append((rcfg, api.plan(tensor, rcfg),
                      time.perf_counter() - t0))
        print(f"planned again at r=2 so that the merge runs "
              f"(plan {plans[1][2]:.1f} s)", flush=True)
    out = {"r_auto": r_auto, "plans": []}
    # the rebalance phase migrates inside groups: it takes the r = 2 plan
    # (or the auto plan, where that replicates)
    kept = next(((c, p) for c, p, _ in plans if p.modes[0].r == 2),
                next(((c, p) for c, p, _ in plans if p.modes[0].r > 1),
                     None))
    for pcfg, plan, plan_s in plans:
        r = plan.modes[0].r
        mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
            f"cuda:{k % cards}" for k in range(MD_DEVICES)])
        print(f"-- {where(mesh)} ({[str(d) for d in mesh.devices]}), "
              f"(group, sub) = {mesh.shape}; rows_max per mode "
              f"{[p.rows_max for p in plan.modes]}; nnz_max per shard "
              f"{[p.nnz_max for p in plan.modes]}", flush=True)
        # device 0's shard of mode 0: the kernel against its plain version
        part = plan.modes[0]
        dev0 = mttkrp.shard_plan_mode(part, mesh)[0]
        f0 = [f[0] for f in als.init_factors(plan, pcfg.rank, seed=1,
                                             devices=mesh.devices[:1])]
        args, geo = kernel_cases(dev0, part, f0, 0)["ec_sorted"][2:4]
        got = mttkrp_sorted.ec_sorted(*args, **geo)
        with slot_order():
            ref = mttkrp_sorted.ec_sorted_plain(*args, **geo)
        if not torch.equal(got, ref):
            fail(f"r={r}: ec_sorted on device 0's shard of mode 0 is not "
                 f"bitwise equal to its deterministic plain version")
        shard_err = float((got - ref).abs().max())
        print(f"r={r}: ec_sorted on device 0's shard of mode 0 is bitwise "
              f"equal to its plain version", flush=True)
        del dev0, f0, args, got, ref
        runs, snaps = {}, {}
        for ename, ov in EXCHANGES.items():
            sweeps = MD_SWEEPS if ename == "ring" else MD_AB_SWEEPS
            rec, snap = multi_device_run(
                api, plan, pcfg.with_overrides(ov), mesh, sweeps,
                f"r={r} {ename}")
            diff = np.abs(np.asarray(rec["fits"])
                          - one_dev_fits[:sweeps]).max()
            if ename == "overlap_bf16":
                if np.abs(np.asarray(rec["fits"])
                          - runs["ring"]["fits"][:sweeps]).max() \
                        > BF16_FIT_TOL:
                    fail(f"r={r} bf16 fits {rec['fits']} are more than "
                         f"{BF16_FIT_TOL} from fp32's")
            elif diff > FIT_TOL:
                fail(f"r={r} {ename}: fits {rec['fits']} differ from the "
                     f"one-device run's {one_dev_fits[:sweeps]} by "
                     f"{diff:.2e}")
            rec["max_abs_diff_one_device_fits"] = float(diff)
            runs[ename], snaps[ename] = rec, snap
        for ename in ("allgather", "overlap"):
            if snaps[ename]["fits"] != snaps["ring"]["fits"] or not all(
                    np.array_equal(a, b) for a, b in
                    zip(snaps[ename]["factors"], snaps["ring"]["factors"])):
                fail(f"r={r} {ename}: factors after {MD_AB_SWEEPS} sweeps "
                     f"are not ring's bits")
        for variant in ("fused", "blocked"):
            vcfg = pcfg.with_overrides({"kernel.variant": variant})
            rec, _ = multi_device_run(api, plan, vcfg, mesh,
                                      MD_KERNEL_SWEEPS, f"r={r} {variant}",
                                      variant=variant)
            diff = np.abs(np.asarray(rec["fits"])
                          - one_dev_fits[:MD_KERNEL_SWEEPS]).max()
            if diff > FIT_TOL:
                fail(f"r={r} {variant}: fits {rec['fits']} differ from the "
                     f"one-device run's by {diff:.2e}")
            rec["max_abs_diff_one_device_fits"] = float(diff)
            runs[variant] = rec
        if runs["blocked"]["fits"] != runs["fused"]["fits"]:
            fail(f"r={r}: blocked fits {runs['blocked']['fits']} are not "
                 f"fused's {runs['fused']['fits']}")
        out["plans"].append({"r": r, "plan_s": plan_s,
                             "rows_max": [p.rows_max for p in plan.modes],
                             "nnz_max": [p.nnz_max for p in plan.modes],
                             "shard0_max_abs_err": shard_err,
                             "runs": runs})
        del plan
    return out, kept


RB_SETTINGS = {"schedule.cadence": 1, "schedule.imbalance_threshold": 1.1,
               "schedule.migration_budget": 0.4, "schedule.probe_repeats": 2}
RB_MEASURE_SWEEPS = 4
RB_SWEEPS = 6          # the "off" and "on" runs
HOT_NNZ = 2_000_000
HOT_SHAPE = (1_638_400, 1280, 1280)


def hot_index_tensor(seed: int = 0):
    """tests/test_schedule_multidevice.py's hot-index tensor (30 % of the
    nonzeros on 3 indices of mode 0, the rest scattered) scaled 25x in
    nonzeros and mode-0 size. Its modes 1-2 grow 5x as well (256 to 1280):
    at 256 the 600 k hot draws fall on only 3 x 256 x 256 cells, and after
    duplicates merge the hot indices hold 12 % of the nonzeros instead of
    30 % (equal-nnz members then differ by 1.13x in blocks, not ~18x)."""
    from repro_torch.core.coo import SparseTensor
    rng = np.random.default_rng(seed)
    hot = HOT_NNZ * 3 // 10
    i0 = np.concatenate([rng.integers(0, 3, hot),
                         rng.integers(3, HOT_SHAPE[0], HOT_NNZ - hot)])
    ind = np.stack([i0, rng.integers(0, HOT_SHAPE[1], HOT_NNZ),
                    rng.integers(0, HOT_SHAPE[2], HOT_NNZ)], 1)
    return SparseTensor(ind.astype(np.int32),
                        rng.standard_normal(HOT_NNZ).astype(np.float32),
                        HOT_SHAPE).deduplicated()


def group_entries(part, group: int) -> list[np.ndarray]:
    """A group's stored nonzeros, member after member: local rows, value
    bits and indices. A migration only moves the boundaries between the
    members of a row-sorted run, so this sequence must not change: then
    every nonzero is still covered exactly once (an O(nnz) check, where
    sorting the multiset of 20 M entries takes minutes of host time)."""
    devs = range(group * part.r, (group + 1) * part.r)
    masks = [part.values[d] != 0 for d in devs]
    return [np.concatenate([a[d][m] for d, m in zip(devs, masks)])
            for a in (part.local_rows, part.values.view(np.int32),
                      part.indices)]


def rebalance_run(api, plan, cfg, mesh, rebalance: str, sweeps: int,
                  label: str):
    """One run under ``schedule.rebalance=rebalance``: counts set to 0
    just before it and read just after; checks the launches (sweeps and
    probes), the fits and the replicas; prints every rebalance point."""
    import torch
    from repro_torch.kernels import _build
    rcfg = cfg.with_overrides({**RB_SETTINGS,
                               "schedule.rebalance": rebalance})
    solver = api.compile(plan, rcfg, mesh=mesh)
    sync_all()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = solver.run(sweeps)
    sync_all()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    fits = np.asarray(res.fits)
    points = len(solver.schedule_events)
    cells = plan.nmodes * mesh.num_devices
    per_point = cells * (1 + RB_SETTINGS["schedule.probe_repeats"])
    if points != sweeps - 1:
        fail(f"{label}: {points} rebalance points in {sweeps} sweeps at "
             f"cadence 1, expected {sweeps - 1}")
    # the probes' launches, counted by the solver around each probe
    probe_counts = [tm["probe_launches"] for tm in solver.rebalance_timings]
    for c in probe_counts:
        if c != {**{k: 0 for k in c}, "ec_sorted": per_point}:
            fail(f"{label}: a rebalance point's probes launched {c}, "
                 f"expected {per_point} of ec_sorted (warm-up + repeats "
                 f"per mode and device) and nothing else")
    probes = sum(c["ec_sorted"] for c in probe_counts)
    if counts["ec_sorted"] - probes != sweeps * cells:
        fail(f"{label}: the sweeps launched ec_sorted "
             f"{counts['ec_sorted'] - probes} times ({counts['ec_sorted']} "
             f"in all, {probes} by the probes), expected {sweeps} sweeps "
             f"x {cells}")
    if fits.shape != (sweeps,) or not np.isfinite(fits).all():
        fail(f"{label}: fits {fits} are not {sweeps} finite values")
    if (np.diff(fits) < -FIT_TOL).any():
        fail(f"{label}: fits decrease: {fits}")
    st = solver.state
    for reps in st.factors + st.grams + [st.lam, st.replica_fits]:
        if not all(torch.equal(reps[0], x.to(reps[0].device))
                   for x in reps[1:]):
            fail(f"{label}: the replicas hold different bits")
    recs = []
    for ev, tm in zip(solver.schedule_events, solver.rebalance_timings):
        probe_ms = [[1e3 * x for x in tm["probe_s"][m]]
                    for m in range(plan.nmodes)]
        raw = [max(p) / (sum(p) / len(p)) for p in probe_ms]
        rec = {"sweep": ev["sweep"], "probe_ms": probe_ms,
               "imbalance_ewma": [ev["imbalance"][m]
                                  for m in range(plan.nmodes)],
               "imbalance_raw": raw,
               "modelled_imbalance": [ev["modelled_imbalance"][m]
                                      for m in range(plan.nmodes)],
               "migrations": ev["migrations"], "moved_nnz": ev["moved_nnz"],
               "applied": ev.get("applied", []),
               "epoch_after": ev.get("epoch_after"),
               "probe_host_s": tm["observe_s"], "apply_s": tm["apply_s"],
               "replace_s": tm["replace_s"], "moved_modes": tm["moved_modes"]}
        recs.append(rec)
        print(f"{label} sweep {rec['sweep']}: probe ms per mode and device "
              f"{[[round(x, 3) for x in p] for p in probe_ms]}; max/mean "
              f"measured {[round(x, 3) for x in rec['imbalance_ewma']]} "
              f"(EWMA), {[round(x, 3) for x in raw]} (this probe), "
              f"modelled {[round(x, 3) for x in rec['modelled_imbalance']]}"
              f"; {rec['migrations']} migration(s), {rec['moved_nnz']} nnz "
              f"moved, epoch after {rec['epoch_after']}; host s: probes "
              f"{rec['probe_host_s']:.3f}, apply {rec['apply_s']:.3f}, "
              f"re-place {rec['replace_s']:.3f}", flush=True)
    print(f"{label}: {sweeps} sweeps in {wall:.2f} s; fits "
          f"{[round(float(f), 6) for f in fits]}; ec_sorted launches "
          f"{counts['ec_sorted']} ({probes} by the probes); epoch "
          f"{solver.plan.rebalance_epoch}", flush=True)
    out = {"fits": fits.tolist(), "wall_s": wall,
           "launches": counts["ec_sorted"], "probe_launches": probes,
           "epoch": solver.plan.rebalance_epoch, "points": recs,
           "trajectory": [max(r["imbalance_ewma"]) for r in recs]}
    return solver, res, out


def rebalance_case(api, plan, cfg, mesh, label: str, *, must_migrate: bool,
                   one_dev_fits=None) -> dict:
    """``"off"``, ``"measure"`` and ``"on"`` on one plan (see phase 7)."""
    import torch
    from repro_torch.kernels import mttkrp_sorted
    torch.cuda.empty_cache()
    for c in {d.index for d in mesh.devices}:
        torch.cuda.reset_peak_memory_stats(c)
    off = api.compile(plan, cfg.with_overrides(RB_SETTINGS), mesh=mesh)
    for k in range(1, RB_SWEEPS + 1):  # run() resumes: one more sweep each
        res = off.run(k)
        if k == RB_MEASURE_SWEEPS:
            snap = res
    off_fits = np.asarray(res.fits)
    del off, res
    torch.cuda.empty_cache()
    out = {"off_fits": off_fits.tolist()}
    solver, res, out["measure"] = rebalance_run(
        api, plan, cfg, mesh, "measure", RB_MEASURE_SWEEPS,
        f"{label} measure")
    if res.fits != snap.fits or not all(
            np.array_equal(a, b) for a, b in zip(res.factors, snap.factors)):
        fail(f"{label}: measure-only factors or fits are not off's bits")
    del solver, res
    torch.cuda.empty_cache()
    solver, res, out["on"] = rebalance_run(api, plan, cfg, mesh, "on",
                                           RB_SWEEPS, f"{label} on")
    diff = float(np.abs(np.asarray(res.fits) - off_fits).max())
    if diff > FIT_TOL:
        fail(f"{label}: on fits {res.fits} differ from off's {off_fits} by "
             f"{diff:.2e}")
    out["max_abs_diff_off_fits"] = diff
    if one_dev_fits is not None:
        n = min(len(one_dev_fits), RB_SWEEPS)
        d1 = float(np.abs(np.asarray(res.fits[:n]) - one_dev_fits[:n]).max())
        if d1 > FIT_TOL:
            fail(f"{label}: on fits {res.fits} differ from the one-device "
                 f"run's {one_dev_fits} by {d1:.2e}")
        out["max_abs_diff_one_device_fits"] = d1
    moved = sorted({m for r in out["on"]["points"] for m in r["moved_modes"]})
    out["moved_nnz"] = sum(r["moved_nnz"] for r in out["on"]["points"])
    out["moved_modes"] = moved
    if must_migrate and not (moved and solver.plan.rebalance_epoch >= 1):
        fail(f"{label}: no migration was applied (epoch "
             f"{solver.plan.rebalance_epoch})")
    for mode in moved:
        part = solver.plan.modes[mode]
        for k, dev in enumerate(solver.dev_arrays[mode]):
            for name in ("indices", "values", "local_rows", "block_to_tile",
                         "tile_visited"):
                if not torch.equal(getattr(dev, name).cpu(),
                                   torch.from_numpy(getattr(part, name)[k])):
                    fail(f"{label} mode {mode}: device {k}'s placed {name} "
                         f"are not the rebalanced plan's")
        for g in range(part.n_groups):
            before = group_entries(plan.modes[mode], g)
            if not all(np.array_equal(x, y) for x, y in
                       zip(group_entries(part, g), before)):
                fail(f"{label} mode {mode} group {g}: the migrated shards do "
                     f"not hold the group's nonzeros in their run's order, "
                     f"each once")
        dev0 = solver.dev_arrays[mode][0]
        f0 = [f[0] for f in solver.state.factors]
        args, geo = kernel_cases(dev0, part, f0, mode)["ec_sorted"][2:4]
        got = mttkrp_sorted.ec_sorted(*args, **geo)
        with slot_order():
            ref = mttkrp_sorted.ec_sorted_plain(*args, **geo)
        if not torch.equal(got, ref):
            fail(f"{label} mode {mode}: ec_sorted on device 0's migrated "
                 f"shard is not bitwise equal to its plain version")
        print(f"{label} mode {mode}: migrated shards placed as planned, "
              f"each group's nonzeros in order and once, device 0's "
              f"ec_sorted = plain bits; "
              f"blocks per device {part.blocks_true.tolist()} (were "
              f"{plan.modes[mode].blocks_true.tolist()})", flush=True)
        del dev0, f0, args, got, ref
    out["peak_alloc_bytes"] = max(torch.cuda.max_memory_allocated(c)
                                  for c in {d.index for d in mesh.devices})
    print(f"{label}: max/mean trajectory measure "
          f"{[round(x, 3) for x in out['measure']['trajectory']]}, on "
          f"{[round(x, 3) for x in out['on']['trajectory']]}; moved nnz "
          f"{out['moved_nnz']} in modes {moved}; peak alloc per card "
          f"{out['peak_alloc_bytes'] / 2**30:.2f} GiB", flush=True)
    del solver, res
    torch.cuda.empty_cache()
    return out


def rebalance_phase(api, cfg, kept, one_dev_fits, cards: int) -> dict:
    """Phase 7: (a) amazon at r = 2 (the multi-device phase's plan), (b)
    the hot-index tensor, ``equal_nnz``."""
    from repro_torch.core import mttkrp
    out = {}
    devices = [f"cuda:{k % cards}" for k in range(MD_DEVICES)]
    if kept is None:
        fail("the multi-device phase planned no r > 1 plan to rebalance")
    acfg, aplan = kept
    r = aplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=devices)
    print(f"-- (a) amazon, r={r}, {where(mesh)}", flush=True)
    out["amazon"] = rebalance_case(api, aplan, acfg, mesh,
                                   f"(a) amazon r={r}", must_migrate=False,
                                   one_dev_fits=one_dev_fits)
    out["amazon"]["r"] = r
    t0 = time.perf_counter()
    hot = hot_index_tensor()
    gen_s = time.perf_counter() - t0
    hcfg = cfg.with_overrides({"runtime.num_devices": MD_DEVICES,
                               "partition.strategy": "equal_nnz",
                               "partition.replication": None})
    t0 = time.perf_counter()
    hplan = api.plan(hot, hcfg)
    plan_s = time.perf_counter() - t0
    part = hplan.modes[0]
    print(f"-- (b) hot-index tensor: shape={hot.shape} nnz={hot.nnz} (hot "
          f"indices {int((hot.indices[:, 0] < 3).sum())}); generate "
          f"{gen_s:.1f} s, plan {plan_s:.1f} s; r={part.r}; mode 0 blocks "
          f"per device {part.blocks_true.tolist()}, nnz_max per mode "
          f"{[p.nnz_max for p in hplan.modes]}", flush=True)
    mesh = mttkrp.cp_mesh(MD_DEVICES, part.r, devices=devices)
    out["hot_index"] = rebalance_case(api, hplan, hcfg, mesh,
                                      "(b) hot-index", must_migrate=True)
    out["hot_index"].update(
        shape=list(hot.shape), nnz=hot.nnz, generate_s=gen_s, plan_s=plan_s,
        blocks_true=[p.blocks_true.tolist() for p in hplan.modes],
        nnz_max=[p.nnz_max for p in hplan.modes])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=3e-2,
                    help="amazon profile scale (3e-2: 20.2 M nonzeros)")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="cards the multi-device path's 4 logical devices "
                         "lie on (default 1: all on cuda:0)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write every per-mode number to this JSON "
                         "file")
    args = ap.parse_args()

    phase("device")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {smi}", flush=True)

    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch.api as api
    from repro_torch.kernels import _build
    from repro_torch.sparse.io import make_profile_tensor

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"  [{name}] {line.strip()}")

    phase("data")
    cfg = api.preset("sorted", {
        "rank": 32, "kernel.autotune": False, "partition.tile": 8,
        "partition.block_p": 128, "runtime.num_devices": 1,
        "runtime.tol": 0.0})
    t0 = time.perf_counter()
    tensor = make_profile_tensor("amazon", scale=args.scale, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = api.plan(tensor, cfg)
    t_plan = time.perf_counter() - t0
    runs = [largest_run(p.block_to_tile[0]) for p in plan.modes]
    items = [work_items(p.block_to_tile[0]) for p in plan.modes]
    nblocks = [p.nblocks for p in plan.modes]
    print(f"amazon @ {args.scale}: shape={tensor.shape} nnz={tensor.nnz} "
          f"rank={cfg.rank} tile={plan.modes[0].tile} "
          f"block_p={plan.modes[0].block_p} | generate {t_gen:.1f} s, "
          f"plan {t_plan:.1f} s")
    for d, p in enumerate(plan.modes):
        print(f"  mode {d}: rows_max={p.rows_max} nblocks={p.nblocks} "
              f"largest run {runs[d]} blocks ({runs[d] * p.block_p} slots, "
              f"{runs[d] / p.nblocks:.1%} of the mode's blocks); "
              f"ec_sorted/ec_fused/ec_blocked work items {items[d][0]}, "
              f"largest {items[d][1]} blocks (CHUNK_BLOCKS "
              f"{_build.CHUNK_BLOCKS})")
        if items[d][1] > _build.CHUNK_BLOCKS:
            fail(f"mode {d}: a work item of {items[d][1]} blocks exceeds "
                 f"CHUNK_BLOCKS = {_build.CHUNK_BLOCKS}")

    phase("kernel parity")
    recs = parity(plan, cfg.rank, timed=True, bitwise_mode=0, label="amazon")
    small = api.plan(make_profile_tensor("twitch", scale=1e-4, seed=0),
                     cfg.with_overrides({"partition.block_p": 64}))
    parity(small, cfg.rank, timed=False, bitwise_mode=None,
           label="twitch(5-mode)")

    phase("main path")
    from repro_torch.core.mttkrp import cp_mesh, shard_plan_mode
    cpu1 = cp_mesh(1, 1, devices=["cpu"])
    shard_bytes = [shard_plan_mode(p, cpu1)[0].nbytes() for p in plan.modes]
    print(f"device bytes of the shards per mode: {shard_bytes}")
    torch.cuda.reset_peak_memory_stats()
    fits, counts, wall = run_solver(api, plan, cfg, SWEEPS, "sorted")
    peak = torch.cuda.max_memory_allocated()
    if counts["ec_sorted"] != plan.nmodes * SWEEPS:
        fail(f"ec_sorted launched {counts['ec_sorted']} times in "
             f"{SWEEPS} sweeps, expected {plan.nmodes * SWEEPS}")
    if (np.diff(fits) < -FIT_TOL).any():
        fail(f"sorted fits decrease: {fits}")
    launches = {"ec_sorted": counts["ec_sorted"]}
    walls = {"sorted": wall}
    vfits_of = {}
    for variant in ("fused", "blocked"):
        vcfg = cfg.with_overrides({"kernel.variant": variant})
        vfits, vcounts, vwall = run_solver(api, plan, vcfg, AB_SWEEPS,
                                           variant)
        name = f"ec_{variant}"
        if vcounts[name] != plan.nmodes * AB_SWEEPS:
            fail(f"{name} launched {vcounts[name]} times, expected "
                 f"{plan.nmodes * AB_SWEEPS}")
        diff = np.abs(vfits - fits[:AB_SWEEPS]).max()
        if diff > FIT_TOL:
            fail(f"{variant} fits {vfits} differ from sorted's "
                 f"{fits[:AB_SWEEPS]} by {diff:.2e}")
        vfits_of[variant] = vfits
        launches[name] = vcounts[name]
        walls[variant] = vwall
    if not np.array_equal(vfits_of["blocked"], vfits_of["fused"]):
        fail(f"blocked fits {vfits_of['blocked']} are not fused's "
             f"{vfits_of['fused']}")

    phase("multi-device path")
    md, kept = multi_device(api, tensor, cfg, fits, args.cards)
    md_launches = {name: sum(run["launches"] for p in md["plans"]
                             for run in p["runs"].values()
                             if f"ec_{run['variant']}" == name)
                   for name in KERNELS}

    phase("rebalance")
    rb = rebalance_phase(api, cfg, kept, fits, args.cards)
    del kept
    rb_runs = [rb[c][m] for c in ("amazon", "hot_index")
               for m in ("measure", "on")]

    phase("summary")
    kernels = []
    for name in KERNELS:
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            # per-shard launches of the multi-device path (4 per mode)
            "multi_device_launches": md_launches[name],
            # the rebalance phase's measure and on runs, probes included
            "rebalance_launches": sum(r["launches"] for r in rb_runs)
            if name == "ec_sorted" else 0,
            "rebalance_probe_launches": sum(r["probe_launches"]
                                            for r in rb_runs)
            if name == "ec_sorted" else 0,
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r),
            "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in r)
            else "operations",
            # no single PyTorch call computes the EC (a gather, a Hadamard
            # product and a scatter-add), so there is no library yardstick
            "library_ms": None,
            "bitwise": r[0]["bitwise"],
            "max_rel_diff_slot_order": max(x["rel_diff_slot_order"]
                                           for x in r),
        })
    detail = {"device": kind, "smi": smi, "scale": args.scale,
              "nnz": tensor.nnz, "shape": list(tensor.shape),
              "rank": cfg.rank, "generate_s": t_gen, "plan_s": t_plan,
              "nblocks": nblocks, "largest_run_blocks": runs,
              "work_items": [n for n, _ in items],
              "largest_item_blocks": [b for _, b in items],
              "shard_bytes": shard_bytes, "peak_alloc_bytes": peak,
              "host_peak_rss_bytes":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
              "sorted_fits": fits.tolist(),
              "ab_fits": {k: v.tolist() for k, v in vfits_of.items()},
              "sweep_wall_s": walls,
              "per_mode": recs, "multi_device": md, "rebalance": rb,
              "kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
