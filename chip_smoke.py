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
   blocks, which must be at most ``CHUNK_BLOCKS``). Then writes the tensor
   to a tensor store with the port's ``write_store_from_coo`` in a
   temporary directory (write seconds, size on disk); every later plan of
   it is made from the store's manifest statistics
   (``api.plan(TensorStore(...), cfg)``), which must read no chunk.
4. Kernel parity: for every mode, runs ``ec_sorted``, ``ec_fused`` and
   ``ec_blocked`` on that mode's shard and holds each against its plain
   PyTorch version on the card, whose ``index_add_`` sums in slot order
   (``ref.slot_order_index_add``; no flag is set here) as the kernels do:
   slot order, and on runs longer than ``CHUNK_BLOCKS`` blocks the fixed
   two-level order (per-chunk partials, then the chunks in order), which
   the plain versions follow too. Every kernel must match bitwise, and
   ``ec_blocked`` must give ``ec_fused``'s bits (one kernel body, one
   order). Each kernel is also held against the slot-order ``ref`` (the
   semantic oracle): bitwise on every tile whose run is at most
   ``CHUNK_BLOCKS`` blocks, and to 1e-4·max|ref| elsewhere (the two-level
   order regroups those rows' sums). Each kernel's arguments come from
   ``ops.kernel_args``, as on the main path, and the same launch through
   ``ops.mttkrp_local`` (with its unvisited-tile masking) must give the
   same bits. On mode 0 each kernel must also equal the plain version on
   the CPU bitwise. A 5-mode ``twitch`` case covers nin = 4. Each kernel
   and plain version is timed with CUDA events (warm-up, then the median
   of 20 runs), and so are the main path's whole EC for the mode
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
   ``sorted`` preset from its store, every shard read into host arrays
   (``StoreModePartition.materialize``: the in-memory plan, bitwise; prints
   the ``r`` its auto replication picks, and plans again at r = 2 when
   that is 1, so that the merge runs), each plan
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
   ``equal_nnz`` (one group of 4). Each case runs ``"off"`` for 4 sweeps,
   ``"measure"`` for 3 (factors and fits bitwise those of ``"off"`` after 3)
   and ``"on"`` for 4 (fits within 1e-4 of ``"off"``, and for (a) of the
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
8. Ref order: the ``ref`` EC (the paper preset's) sums in slot order on
   the card with no flag set by the caller: the paper preset on its store
   plan (one device, resident) run twice from the same seed gives the same
   factor, lam and fit bits after 2 sweeps (the first run goes on to 4,
   the resident run of phase 10); and on 4 logical devices on phase 6's
   r = 2 plan, ``schedule.rebalance="measure"`` is bitwise ``"off"`` under
   the paper preset over 2 sweeps (replicas equal).
9. Presets: ``api.preset("fused")`` and ``api.preset("sorted")``,
   unmodified apart from rank 32 and one device. The EC autotuner runs on
   the card (its cache in the temporary directory): the tuner's seconds,
   winner and every candidate's ms are printed, the winner's plan is made
   (the main path's plan when the winner is its geometry, else from the
   store), and the tuner's counters must show one miss and memo hits for
   the second plan and the compile. 3 sweeps each; fits within 1e-4 of
   the main path's fixed-geometry run. Then on phase 6's r = 2 plan, 4
   logical devices: ``allgather`` and ``overlap`` with
   ``exchange.autotune_chunk=true``, 2 sweeps each; the tuned chunk and
   each candidate's ms are printed, and the factors must be ``allgather``'s
   bits.
10. Streaming: the ``sorted`` (tile 8, block_p 128) and ``paper`` store
   plans on one device, under one ``runtime.memory_budget`` sized from the
   densest padded tile of either plan (the least a split at tile
   boundaries allows), which must split every mode into at least 3
   super-shards; ``stream_buffers=2``, spill on, 4 sweeps; then the same
   lazy plans resident (the paper one is phase 8's run). Fits, lam and
   factors must be bitwise equal. Then the ``sorted`` store plan for 4
   devices (auto r) on 4 logical devices, 2 sweeps, streamed against
   resident, bitwise, replicas too. Per run it prints the super-shards per
   mode, the window build seconds of sweep 1 and the spill reload seconds
   after, the host-to-device bytes per sweep, the exposed transfer, the
   steady sweep ms streamed and resident, and the peak allocations: on one
   device the streamed peak must stay within the two resident windows
   (the stream plan's ``resident_bound_bytes``) plus their descriptors,
   the factors, two mode outputs (the accumulator and the previous
   mode's, which the sweep keeps for the fit), the fit's one factor-sized
   product and one EC's measured workspace; on 4 logical devices below
   the resident peak. ``ec_sorted`` must have
   launched once per window, device and sweep.
11. Operations, on the main path's plan (R 32, ``sorted``, tile 8,
   block_p 128, one device). (a) Plan cache: the plan saved with
   ``api.save_plan`` under its ``plan_signature`` and loaded back by
   ``api.plan(..., cache_dir=)`` (one hit), every array bitwise equal,
   save and load seconds; then the lazy store plan of phase 3, whose load
   reads no chunk. (b) Checkpoints: 4 sweeps with
   ``runtime.checkpoint_dir``; a fresh solver restores sweep 2 and runs
   to 4, within 1e-6 (fits) and 1e-5 (factors) of the uninterrupted run
   (the reference's resume tolerances); then phase 6's r = 2 plan on 4
   logical devices checkpoints 2 sweeps, which a one-device solver
   restores — factors and lam bitwise those saved — and the next fit
   does not fall. (c) The BLCO-style baseline (``core/baselines.py``):
   per mode, the tensor streamed from the host in chunks of 65,536
   nonzeros through one card, its H2D and EC seconds (CUDA events) beside
   the mode's ``ec_sorted`` ms of phase 4, within 1e-4·max of the plain
   MTTKRP of the whole tensor on the card. (d) 4 sweeps with
   ``runtime.trace=True``: fits bitwise the main path's, the trace valid
   (``repro_torch.obs.validate_trace``, 95 % coverage) with 1 run, 4
   sweeps and 12 each of ``mode_update``, ``ec`` and ``exchange``; each
   span's total and median ms over sweeps 2-4. (e) Sweeps 2-4 of an
   untraced run under ``torch.profiler`` (CPU and CUDA): the device's
   busy share of the window (the union of kernel and copy intervals), the
   five longest device operations and the five longest idle gaps with the
   host scopes open during each; if the profiler shows no device time it
   says so and times the stages with CUDA events instead, and prints no
   busy share. Then the traced against the untraced steady sweep. Counts
   are set to 0 just before each run and read just after: ``ec_sorted``
   once per mode, device and sweep.
12. Serve + analysis, at the main path's size (R 32, ``sorted``, tile 8,
   block_p 128, one card). (a) ``CPService.boot`` from phase 11(b)'s
   checkpoint directory over a copy of phase 3's store, with the main
   path's config. (b) 8 client threads x 200 ``reconstruct`` requests of
   16 coordinates through the batcher, then requests of 1, 7, 9, 100 and
   257, each within rtol 1e-4 / atol 1e-5 of the float64 numpy model
   (tests/test_serve.py's tolerance); then 20 ``topk`` slices of mode 0
   with k = 10: scores within 1e-4 of numpy's dense scores, indices equal
   at every position whose dense score is more than 1e-5 relative from its
   neighbours' (``torch.topk`` orders ties otherwise than ``lax.top_k``).
   (c) 1 % of the store's nonzeros appended at a seeded sample of the
   stored coordinates, with fresh seeded values; ``refresh(sweeps=3,
   wait=False)`` while 4 client threads query (one also ``topk``) until it
   ends and once more: every answer bitwise v1's or v2's, each client with
   a v1 answer and a last answer (begun after the publish) of v2's bits,
   v2 published, and the refit
   launched ``ec_sorted`` 3 x 3 times and nothing else (counts set to 0
   just before the refresh, read just after); the refresh's seconds split
   into plan, compile (placement), sweeps, freeze-blend, ``store_fit`` and
   ``sample_fit``. (d) A checkpoint of random factors: ``deploy_checkpoint``
   rolls back on the held-out sample fit, the engine stays at v2. (e)
   ``check_plan`` (deep) on the main plan and ``api.plan(store, cfg,
   analyze="strict")``: no AP error; AH-H001 clean for ``sorted`` and
   ``fused`` and finding ``blocked``'s pre-gather; ``CPSolver.audit()`` of
   the main path's solver leaves its state bitwise unchanged, and every
   AH-H002 finding is printed with its source line (``_pinv_psd``'s eigh is
   expected); AH-H005 clean on phase 6's r = 2 plan on 4 logical devices
   with the ``overlap`` exchange on a bf16 wire; AH-H006 clean after (b);
   the concurrency lint clean. Prints p50/p99 per operation, rows/s,
   ``topk`` ms and the bucket counts.
13. Summary: one JSON line ``{"kernels": [...]}`` (``ms``, ``plain_ms`` and
   ``bound_ms`` summed over the three modes, i.e. one sweep's launches;
   ``launches`` from the main-path run, ``multi_device_launches`` from the
   multi-device path's, ``rebalance_launches`` from the rebalance phase's
   ``"measure"`` and ``"on"`` runs, of which ``rebalance_probe_launches``
   were counted around the probes; ``tuner_launches`` the EC autotuner's
   candidate runs, ``preset_launches`` the tuned presets' runs,
   ``stream_launches`` the streamed windows', ``operations_launches``
   phase 11's runs and ``serve_launches`` phase 12's refit), the card's
   name and power
   limit, and last ``{"ok": true, "device": {...}}``. With ``--out PATH``
   every per-mode number also goes to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
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


CHUNK_BLOCKS = 16  # _build.CHUNK_BLOCKS, checked against it in main()


def short_run_rows(b2t: np.ndarray, tile: int, num_rows: int):
    """A mask of the output rows whose tile's run is at most
    ``CHUNK_BLOCKS`` blocks: there every kernel sums in slot order, the
    ``ref`` EC's order, and must give its bits."""
    import torch
    starts = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    mask = np.zeros(num_rows // tile, bool)
    for a, b in zip(starts[:-1], starts[1:]):
        mask[b2t[a]] = b - a <= CHUNK_BLOCKS
    return torch.from_numpy(np.repeat(mask, tile)).cuda()


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
        # the semantic oracle: slot-order ref (its index_add_ runs in slot
        # order on the card without any flag set here)
        slot_ref = ops.mttkrp_local(
            dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
            factors, mode=mode, variant="ref", num_rows=part.rows_max,
            tile=part.tile, block_p=part.block_p)
        short = short_run_rows(part.block_to_tile[0], part.tile,
                               part.rows_max)
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
            if not torch.equal(got[short], slot_ref[short]):
                fail(f"{label} {name} mode {mode}: differs from the "
                     f"slot-order ref on a tile whose run is at most "
                     f"{CHUNK_BLOCKS} blocks")
            d_slot = float((got - slot_ref).abs().max())
            scale = float(slot_ref.abs().max())
            if d_slot > REF_RTOL * scale:
                fail(f"{label} {name} mode {mode}: max |kernel - ref| = "
                     f"{d_slot:.3e} exceeds {REF_RTOL} * max|ref| = "
                     f"{REF_RTOL * scale:.3e}")
            rec = {"mode": mode, "max_abs_err": err,
                   "short_run_rows_equal_ref": int(short.sum()),
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


def materialized_plan(api, store, cfg):
    """The store's plan for ``cfg`` with every mode's shards read into host
    arrays (``StoreModePartition.materialize``): the in-memory plan of the
    same tensor, bitwise (tests/test_torch_store.py), at the cost of one
    pass over the chunks per mode and device instead of a sort of the
    whole tensor."""
    import dataclasses
    plan = api.plan(store, cfg)
    return dataclasses.replace(plan, modes=tuple(p.materialize()
                                                 for p in plan.modes))


def multi_device(api, store, cfg, one_dev_fits, cards: int) -> dict:
    """The multi-device path: the same tensor planned for 4 devices from
    its store (the ``sorted`` preset's auto replication, and r = 2 besides
    when that picks r = 1; both materialized, see
    :func:`materialized_plan`), each plan run on 4 logical devices (logical device k on
    ``cuda:0`` or, with 4 cards, on ``cuda:k``) with every exchange
    schedule, and ``ec_fused``/``ec_blocked`` for two sweeps."""
    import torch
    from repro_torch.core import als, mttkrp
    from repro_torch.kernels import mttkrp_sorted
    mcfg = cfg.with_overrides({"runtime.num_devices": MD_DEVICES,
                               "partition.replication": None})
    t0 = time.perf_counter()
    mplan = materialized_plan(api, store, mcfg)
    plans = [(mcfg, mplan, time.perf_counter() - t0)]
    r_auto = mplan.modes[0].r
    print(f"auto replication for {MD_DEVICES} devices picked r={r_auto} "
          f"(plan {plans[0][2]:.1f} s)", flush=True)
    if r_auto == 1:
        rcfg = mcfg.with_overrides({"partition.replication": 2})
        t0 = time.perf_counter()
        plans.append((rcfg, materialized_plan(api, store, rcfg),
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
RB_MEASURE_SWEEPS = 3
RB_SWEEPS = 4          # the "off" and "on" runs
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


STREAM_SWEEPS = 4      # each streamed run, and the resident run beside it
MD_STREAM_SWEEPS = 2   # the 4-logical-device streamed and resident runs
REF_REPEAT_SWEEPS = 2  # the second paper run, held against the first's
PAPER_MD_SWEEPS = 2    # paper "off" and "measure" on 4 logical devices
PRESET_SWEEPS = 3
MIN_SHARDS = 3         # super-shards per mode the one-device budget forces


def all_cards(mesh) -> list[int]:
    return sorted({d.index for d in mesh.devices})


def same_result(a, b) -> bool:
    """Fits, factors and lam of two CPResults, bitwise."""
    return (a.fits == b.fits and np.array_equal(a.lam, b.lam) and all(
        np.array_equal(x, y) for x, y in zip(a.factors, b.factors)))


def replicas_equal(state) -> bool:
    import torch
    return all(torch.equal(reps[0], x.to(reps[0].device))
               for reps in state.factors + state.grams
               + [state.lam, state.replica_fits] for x in reps[1:])


def store_phase(tensor, tmp: str):
    """The end of phase 3: the data tensor written to a tensor store with
    the port's writer, in chunks of 2^20 nonzeros — or, for a tensor of
    fewer than 16 of those (a small ``--scale``), of the largest power of
    two under nnz/16, so that phase 10's budget still holds one chunk's
    staging."""
    from repro_torch.store import TensorStore, write_store_from_coo
    path = os.path.join(tmp, "amazon.store")
    chunk_nnz = 1 << min(20, max(12, int(np.log2(max(tensor.nnz // 16,
                                                         1)))))
    t0 = time.perf_counter()
    write_store_from_coo(tensor, path, chunk_nnz=chunk_nnz)
    write_s = time.perf_counter() - t0
    store = TensorStore(path)
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    print(f"store: {store.nnz} nonzeros in {store.num_chunks} chunks of "
          f"{store.chunk_nnz}, {size / 2**20:.1f} MiB on disk, written in "
          f"{write_s:.1f} s ({store.nnz / write_s / 1e6:.2f} M nnz/s)",
          flush=True)
    return store, {"write_s": write_s, "disk_bytes": size,
                   "chunks": store.num_chunks, "chunk_nnz": store.chunk_nnz}


def plan_store(api, store, cfg, label: str):
    """``api.plan`` of the store: manifest statistics only, no chunk read
    (checked)."""
    store.reset_access_stats()
    t0 = time.perf_counter()
    plan = api.plan(store, cfg)
    plan_s = time.perf_counter() - t0
    if store.access_stats["chunk_reads"]:
        fail(f"{label}: planning from the store read "
             f"{store.access_stats['chunk_reads']} chunks")
    print(f"{label}: planned from the store in {plan_s:.2f} s (0 chunk "
          f"reads); r={plan.modes[0].r} tile={plan.modes[0].tile} "
          f"block_p={plan.modes[0].block_p} layout="
          f"{plan.modes[0].block_layout}", flush=True)
    return plan, plan_s


def timed_run(api, plan, cfg, sweeps: int, label: str, *, mesh=None,
              kernel: str | None = None, snap_at: int | None = None):
    """Compile and run ``sweeps`` sweeps, one at a time: counts set to 0
    after the compile and read after the last sweep; the peak allocation
    above what was allocated before the compile. Returns the result, the
    per-sweep wall seconds, the launches, the peak and the open solver
    (and with ``snap_at``, the result after that sweep as well)."""
    import torch
    from repro_torch.kernels import _build
    kw = {"mesh": mesh} if mesh is not None else {}
    sync_all()
    torch.cuda.empty_cache()
    cards = all_cards(mesh) if mesh is not None else [0]
    base = sum(torch.cuda.memory_allocated(c) for c in cards)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t0 = time.perf_counter()
    solver = api.compile(plan, cfg, **kw)
    sync_all()
    compile_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    wall = []
    for k in range(1, sweeps + 1):  # run() resumes: one more sweep each
        t0 = time.perf_counter()
        res = solver.run(k)
        sync_all()
        wall.append(time.perf_counter() - t0)
        if k == snap_at:
            snap = res
    counts = dict(_build.LAUNCHES)
    peak = max(torch.cuda.max_memory_allocated(c) for c in cards) - \
        (base if len(cards) == 1 else 0)
    fits = np.asarray(res.fits)
    if fits.shape != (sweeps,) or not np.isfinite(fits).all():
        fail(f"{label}: fits {fits} are not {sweeps} finite values")
    if kernel is not None and counts[kernel] == 0:
        fail(f"{label}: {kernel} was never launched")
    print(f"{label}: compile {compile_s:.2f} s; sweep wall times "
          f"{[round(w, 4) for w in wall]} s; fits "
          f"{[round(float(f), 6) for f in fits]}; launches {counts}; peak "
          f"alloc {peak / 2**20:.1f} MiB", flush=True)
    if snap_at is not None:
        return res, wall, counts, peak, compile_s, solver, snap
    return res, wall, counts, peak, compile_s, solver


def ref_order_phase(api, store, kept, cards: int):
    """Phase 8: the ``ref`` EC (the paper preset's) in slot order on the
    card, with no flag set by the caller: two runs of the paper preset on
    its store plan give the same bits, and ``"measure"`` is bitwise
    ``"off"`` under the paper preset on 4 logical devices."""
    import torch
    from repro_torch.core import mttkrp
    from repro_torch.kernels import _build
    cfg = api.preset("paper", {"rank": 32, "runtime.num_devices": 1,
                               "runtime.tol": 0.0})
    plan, plan_s = plan_store(api, store, cfg, "paper (1 device)")
    res, wall, counts, peak, compile_s, solver, snap = timed_run(
        api, plan, cfg, STREAM_SWEEPS, "paper resident, run 1",
        snap_at=REF_REPEAT_SWEEPS)
    if any(counts.values()):
        fail(f"the paper preset launched {counts}: its EC is ref")
    solver.reset()
    t0 = time.perf_counter()
    res2 = solver.run(REF_REPEAT_SWEEPS)
    sync_all()
    run2_s = time.perf_counter() - t0
    solver.close()
    del solver
    if torch.are_deterministic_algorithms_enabled():
        fail("a run left torch.use_deterministic_algorithms on")
    if not same_result(snap, res2):
        fail("two paper runs on one device gave different bits")
    print(f"paper: run 2 ({REF_REPEAT_SWEEPS} sweeps in {run2_s:.2f} s) "
          f"gives run 1's factor, lam and fit bits after "
          f"{REF_REPEAT_SWEEPS} sweeps", flush=True)
    out = {"plan_s": plan_s, "compile_s": compile_s, "sweep_wall_s": wall,
           "fits": list(res.fits), "peak_alloc_bytes": peak,
           "two_runs_bitwise": True}
    acfg, aplan = kept
    r = aplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
        f"cuda:{k % cards}" for k in range(MD_DEVICES)])
    pcfg = api.preset("paper", {"rank": 32, "runtime.tol": 0.0,
                                "runtime.num_devices": MD_DEVICES,
                                **RB_SETTINGS})
    runs = {}
    for mode in ("off", "measure"):
        with api.compile(aplan, pcfg.with_overrides(
                {"schedule.rebalance": mode}), mesh=mesh) as solver:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            runs[mode] = solver.run(PAPER_MD_SWEEPS)
            sync_all()
            run_s = time.perf_counter() - t0
            if any(_build.LAUNCHES.values()):
                fail(f"paper {mode}: launched {dict(_build.LAUNCHES)}")
            if not replicas_equal(solver.state):
                fail(f"paper {mode}: the replicas hold different bits")
            points = len(solver.schedule_events)
        print(f"paper r={r} {mode} on {where(mesh)}: {PAPER_MD_SWEEPS} "
              f"sweeps in {run_s:.2f} s, {points} rebalance points; fits "
              f"{[round(float(f), 6) for f in runs[mode].fits]}",
              flush=True)
    if not same_result(runs["measure"], runs["off"]):
        fail("paper: measure-only factors or fits are not off's bits")
    print(f"paper r={r}: measure is bitwise off over {PAPER_MD_SWEEPS} "
          f"sweeps", flush=True)
    out["measure_bitwise_off"] = True
    out["md_fits"] = list(runs["off"].fits)
    resident = {"res": res, "wall": wall, "peak": peak,
                "compile_s": compile_s}
    return plan, resident, out


def xchg_timings(rows_key: str):
    from repro_torch.kernels import autotune
    with open(autotune.cache_path()) as f:
        cache = json.load(f)
    return next(v for k, v in cache.items() if k.startswith(rows_key))


def presets_phase(api, store, plan_main, main_fits, kept, cards: int):
    """Phase 9: the ``fused`` and ``sorted`` presets, unmodified: the EC
    autotuner on the card picks the geometry and the ring depth; then the
    overlap chunk autotuner on 4 logical devices."""
    from repro_torch.api.planning import resolve_geometry
    from repro_torch.core import mttkrp
    from repro_torch.kernels import _build, autotune
    out, tuner_launches = {}, {k: 0 for k in KERNELS}
    for name in ("fused", "sorted"):
        cfg = api.preset(name, {"rank": 32, "runtime.num_devices": 1,
                                "runtime.tol": 0.0})
        autotune.reset_counters()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        tile, block_p = resolve_geometry(plan_main.nmodes, cfg)
        tune_s = time.perf_counter() - t0
        for k, v in _build.LAUNCHES.items():
            tuner_launches[k] += v
        tuned = autotune.autotune_ec(plan_main.nmodes, cfg.rank,
                                     variant=name)
        grid_ms = {k: 1e3 * v for k, v in tuned.timings.items()}
        print(f"{name}: tuner {tune_s:.2f} s, winner tile={tuned.tile} "
              f"block_p={tuned.block_p} num_buffers={tuned.num_buffers}; "
              f"grid ms {json.dumps({k: round(v, 4) for k, v in grid_ms.items()})}; "
              f"launches {dict(_build.LAUNCHES)}", flush=True)
        layout = cfg.partition.layout
        if (tile, block_p, layout) == (plan_main.modes[0].tile,
                                       plan_main.modes[0].block_p,
                                       plan_main.modes[0].block_layout):
            plan, plan_s, how = plan_main, 0.0, "the main path's plan"
            resolve_geometry(plan_main.nmodes, cfg)  # a second plan's tuning
        else:
            plan, plan_s = plan_store(api, store, cfg, f"{name} preset")
            how = "planned from the store"
        res, wall, counts, peak, compile_s, solver = timed_run(
            api, plan, cfg, PRESET_SWEEPS, f"{name} preset ({how})",
            kernel=f"ec_{name}")
        solver.close()
        del solver
        memo = dict(autotune.COUNTERS)
        if memo["misses"] != 1 or memo["memo_hits"] < 2:
            fail(f"{name}: the tuner answered {memo}; expected one miss and "
                 f"memo hits for the second plan and the compile")
        diff = float(np.abs(np.asarray(res.fits)
                            - main_fits[:PRESET_SWEEPS]).max())
        if diff > FIT_TOL:
            fail(f"{name} preset fits {res.fits} differ from the fixed "
                 f"geometry's {main_fits[:PRESET_SWEEPS]} by {diff:.2e}")
        print(f"{name}: tuner counters {memo} (the second plan and the "
              f"compile were memo hits); steady sweep "
              f"{1e3 * float(np.median(wall[1:])):.2f} ms; fits within "
              f"{diff:.2e} of the fixed-geometry run", flush=True)
        # the grid once more: the spread over the grid against the
        # candidate-to-candidate change between the two sweeps of it
        again = autotune.autotune_ec(plan_main.nmodes, cfg.rank,
                                     variant=name, force=True)
        ratio = [again.timings[k] / tuned.timings[k] for k in tuned.timings]
        spread = max(tuned.timings.values()) / min(tuned.timings.values())
        print(f"{name}: grid spread (slowest / fastest) {spread:.3f}; a "
              f"second sweep of the grid picks tile={again.tile} "
              f"block_p={again.block_p} num_buffers={again.num_buffers}, "
              f"each candidate at {min(ratio):.3f}-{max(ratio):.3f}x its "
              f"first time", flush=True)
        out[name] = {"tune_s": tune_s, "winner": [tuned.tile, tuned.block_p,
                                                   tuned.num_buffers],
                     "grid_spread": spread,
                     "second_winner": [again.tile, again.block_p,
                                       again.num_buffers],
                     "second_grid_ms": {k: 1e3 * v
                                        for k, v in again.timings.items()},
                     "grid_ms": grid_ms, "counters": memo, "plan": how,
                     "plan_s": plan_s, "compile_s": compile_s,
                     "sweep_wall_s": wall, "fits": list(res.fits),
                     "max_abs_diff_fixed_fits": diff,
                     "launches": counts[f"ec_{name}"],
                     "peak_alloc_bytes": peak}
    out["tuner_launches"] = tuner_launches
    acfg, aplan = kept
    r = aplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
        f"cuda:{k % cards}" for k in range(MD_DEVICES)])
    recs, snaps = {}, {}
    for ename, ov in (("allgather", {"exchange.variant": "allgather"}),
                      ("overlap_tuned", {"exchange.variant": "overlap",
                                         "exchange.autotune_chunk": True})):
        recs[ename], snaps[ename] = multi_device_run(
            api, aplan, acfg.with_overrides(ov), mesh, MD_AB_SWEEPS,
            f"presets r={r} {ename}")
    if snaps["overlap_tuned"]["fits"] != snaps["allgather"]["fits"] or \
            not all(np.array_equal(a, b) for a, b in zip(
                snaps["overlap_tuned"]["factors"],
                snaps["allgather"]["factors"])):
        fail("overlap with a tuned chunk: factors are not allgather's bits")
    chunk = recs["overlap_tuned"]["exchange"]["chunk_rows"]
    entry = xchg_timings(f"xchg_overlap_rows"
                         f"{max(p.rows_max // p.r for p in aplan.modes)}_")
    print(f"overlap chunk tuner on {where(mesh)}: chunk_rows={chunk}; "
          f"ms per candidate "
          f"{ {k: round(1e3 * v, 4) for k, v in entry['timings'].items()} }"
          f"; factors bitwise allgather's", flush=True)
    out["overlap"] = {"chunk_rows": chunk, "timings_s": entry["timings"],
                      "runs": recs}
    return out


def stream_budget(parts, min_slots: int = 0, buffers: int = 2) -> int:
    """The per-device budget whose super-shards hold the densest padded
    tile of any of ``parts`` (the least a tile-boundary split allows) or
    ``min_slots``, whichever is more, plus one block of slack."""
    from repro_torch.store import budget_slot_cap, stream_shard_nbytes
    nmodes = parts[0].nmodes
    bp = parts[0].block_p
    cap = max(min_slots, max(int(p._dev_tc_pad.max()) for p in parts))
    cap = -(-cap // bp) * bp
    n_tiles = max(p.layout.n_tiles for p in parts)
    budget = buffers * (stream_shard_nbytes(cap, cap // bp, n_tiles, nmodes)
                        + (4 * nmodes + 9) * bp)
    for p in parts:
        if budget_slot_cap(budget, nmodes=nmodes, n_tiles=p.layout.n_tiles,
                           block_p=bp, buffers=buffers) < cap:
            fail("stream_budget: the budget does not hold its own cap")
    return budget


def ec_workspace(solver, part, rank: int) -> int:
    """Bytes one super-shard's EC allocates beyond its inputs on device 0
    (the kernel's argument building, the work-item buffers, its output and
    the masked output), measured once on window (0, 0)."""
    import torch
    from repro_torch.kernels import ops
    dev = solver.streamer.get(0, 0)[0]
    facs = [f[0] for f in solver.state.factors]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.mttkrp_local(
        dev.indices, dev.values, dev.local_rows, dev.block_to_tile, facs,
        mode=0, num_rows=part.rows_max, tile=part.tile, block_p=part.block_p,
        tile_mask=dev.tile_visited, seg_starts=dev.seg_starts,
        seg_rows=dev.seg_rows, **solver._kernel_kw)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def stream_case(api, plan, cfg, budget: int, sweeps: int, label: str, *,
                resident=None, mesh=None, kernel: str | None = None) -> dict:
    """One streamed run of a store plan and the resident run of the same
    plan (``resident``: one already made): fits and factors bitwise, and on
    4 logical devices every replica's bits. Prints the window build and
    spill reload seconds, the host-to-device bytes per sweep, the exposed
    transfer, the steady sweeps and the peak allocations."""
    import torch
    from repro_torch.store import split_mode_super_shards
    scfg = cfg.with_overrides({"runtime.streaming": True,
                               "runtime.memory_budget": budget,
                               "runtime.stream_buffers": 2,
                               "runtime.stream_spill": True})
    m = plan.num_devices
    sps = [split_mode_super_shards(p, budget) for p in plan.modes]
    shards = [sp.num_shards for sp in sps]
    print(f"{label}: budget {budget} B ({budget / 2**20:.1f} MiB) per "
          f"device; super-shards per mode {shards}; shard bytes per mode "
          f"{[sp.shard_bytes for sp in sps]}; resident shard bytes per mode "
          f"{[store_resident_bytes(p) for p in plan.modes]}", flush=True)
    if m == 1 and min(shards) < MIN_SHARDS:
        fail(f"{label}: the budget splits a mode into fewer than "
             f"{MIN_SHARDS} super-shards: {shards}")
    if min(shards) < 2:
        fail(f"{label}: a mode is not split: {shards}")
    sres, swall, scounts, speak, scompile, solver = timed_run(
        api, plan, scfg, sweeps, f"{label} streamed", mesh=mesh,
        kernel=kernel)
    report = solver.overlap_report()
    if kernel is not None and scounts[kernel] != sweeps * sum(shards) * m:
        fail(f"{label}: {kernel} launched {scounts[kernel]} times, expected "
             f"{sweeps} sweeps x {sum(shards)} windows x {m} devices")
    if m > 1 and not replicas_equal(solver.state):
        fail(f"{label}: the streamed replicas hold different bits")
    ws = ec_workspace(solver, plan.modes[0], cfg.rank) if m == 1 else None
    solver.close()
    del solver
    if report["peak_resident_bytes"] > budget:
        fail(f"{label}: {report['peak_resident_bytes']} B of windows were "
             f"resident at once, over the budget {budget} B")
    if resident is None:
        rres, rwall, _, rpeak, rcompile, rsolver = timed_run(
            api, plan, cfg, sweeps, f"{label} resident", mesh=mesh,
            kernel=kernel)
        if m > 1 and not replicas_equal(rsolver.state):
            fail(f"{label}: the resident replicas hold different bits")
        rsolver.close()
        del rsolver
    else:
        rres, rwall, rpeak, rcompile = resident
    torch.cuda.empty_cache()
    if not same_result(sres, rres):
        fail(f"{label}: streamed fits or factors are not the resident "
             f"run's bits ({sres.fits} vs {rres.fits})")
    events = report["per_sweep"]
    sweep_bytes = sum(n * sp.shard_bytes for n, sp in zip(shards, sps))
    rank = cfg.rank
    factor_bytes = sum(p.padded_rows for p in plan.modes) * rank * 4 * m
    # the accumulator, and the previous mode's output the sweep keeps for
    # the fit until the next mode's finish replaces it
    acc_bytes = 2 * max(p.rows_max for p in plan.modes) * rank * 4 * m
    # the fit's product of the last mode's output and factor
    fit_bytes = max(p.padded_rows for p in plan.modes) * rank * 4 * m
    nb = max(sp.nblocks for sp in sps)
    desc_bytes = 2 * nb * (2 * plan.modes[0].tile + 3) * 4 * m
    rec = {"budget_bytes": budget, "shards_per_mode": shards,
           "shard_bytes": [sp.shard_bytes for sp in sps],
           "resident_bound_bytes": max(sp.resident_bound_bytes()
                                       for sp in sps),
           "compile_s": scompile, "resident_compile_s": rcompile,
           "sweep_wall_s": swall, "resident_sweep_wall_s": rwall,
           "steady_ms": 1e3 * float(np.median(swall[1:])),
           "resident_steady_ms": 1e3 * float(np.median(rwall[1:])),
           "build_s_sweep1": events[0]["transfer_s"],
           "reload_s_later": [e["transfer_s"] for e in events[1:]],
           "exposed_ms": [1e3 * e["exposed_s"] for e in events],
           "h2d_bytes_per_sweep_per_device": sweep_bytes,
           "bytes_streamed_per_sweep": [e["bytes_streamed"] for e in events],
           "peak_alloc_bytes": speak, "resident_peak_alloc_bytes": rpeak,
           "factor_bytes": factor_bytes, "acc_bytes": acc_bytes,
           "fit_bytes": fit_bytes,
           "descriptor_bytes": desc_bytes, "ec_workspace_bytes": ws,
           "spill_hits": report["spill_hits"],
           "spill_saves": report["spill_saves"],
           "peak_resident_window_bytes": report["peak_resident_bytes"],
           "fits": list(sres.fits), "launches": scounts}
    if m == 1:
        bound = (rec["resident_bound_bytes"] + desc_bytes + factor_bytes
                 + acc_bytes + fit_bytes + ws + 2**20)
        rec["peak_bound_bytes"] = bound
        if speak > bound:
            fail(f"{label}: streamed peak {speak} B exceeds the windows' "
                 f"bound {rec['resident_bound_bytes']} + descriptors "
                 f"{desc_bytes} + factors {factor_bytes} + two outputs "
                 f"{acc_bytes} + the fit's product {fit_bytes} + one EC's "
                 f"workspace {ws} + 1 MiB = {bound} B")
    elif speak >= rpeak:
        fail(f"{label}: streamed peak {speak} B is not below the resident "
             f"run's {rpeak} B")
    print(f"{label}: streamed = resident bitwise over {sweeps} sweeps"
          + (" (every replica too)" if m > 1 else "")
          + f"; window builds {rec['build_s_sweep1']:.2f} s in sweep 1, "
          f"spill reloads {[round(x, 2) for x in rec['reload_s_later']]} s "
          f"after; H2D {sweep_bytes / 2**20:.1f} MiB per sweep and device "
          f"(counted {[round(b / 2**20, 1) for b in rec['bytes_streamed_per_sweep']]}"
          f" MiB); exposed transfer ms "
          f"{[round(x, 1) for x in rec['exposed_ms']]}; steady sweep "
          f"{rec['steady_ms']:.1f} ms streamed, "
          f"{rec['resident_steady_ms']:.1f} ms resident; peak alloc "
          f"{speak / 2**20:.1f} MiB streamed"
          + (f" (bound {rec['peak_bound_bytes'] / 2**20:.1f} MiB: windows "
             f"{rec['resident_bound_bytes'] / 2**20:.1f} + factors "
             f"{factor_bytes / 2**20:.1f} + two outputs "
             f"{acc_bytes / 2**20:.1f} + fit product {fit_bytes / 2**20:.1f}"
             f" + EC workspace {ws / 2**20:.1f} + "
             f"descriptors {desc_bytes / 2**20:.1f})" if m == 1 else "")
          + f", {rpeak / 2**20:.1f} MiB resident", flush=True)
    return rec


def store_resident_bytes(part) -> int:
    from repro_torch.store import resident_shard_nbytes
    return resident_shard_nbytes(part, part.nmodes)


def streaming_phase(api, store, paper_plan, paper_res, cards: int) -> dict:
    """Phase 10: epoch streaming of the store plans under a budget that
    splits every mode into at least ``MIN_SHARDS`` super-shards."""
    from repro_torch.core import mttkrp
    out = {}
    scfg = api.preset("sorted", {"rank": 32, "kernel.autotune": False,
                                 "partition.tile": 8,
                                 "partition.block_p": 128,
                                 "runtime.num_devices": 1,
                                 "runtime.tol": 0.0})
    splan, splan_s = plan_store(api, store, scfg, "sorted (1 device)")
    pcfg = api.preset("paper", {"rank": 32, "runtime.num_devices": 1,
                                "runtime.tol": 0.0})
    total = max(p.nnz_max for p in splan.modes + paper_plan.modes)
    budget = stream_budget(list(splan.modes) + list(paper_plan.modes),
                           min_slots=0)
    out["sorted"] = stream_case(api, splan, scfg, budget, STREAM_SWEEPS,
                                "stream sorted", kernel="ec_sorted")
    out["sorted"]["plan_s"] = splan_s
    del splan
    out["paper"] = stream_case(
        api, paper_plan, pcfg, budget, STREAM_SWEEPS, "stream paper",
        resident=(paper_res["res"], paper_res["wall"], paper_res["peak"],
                  paper_res["compile_s"]))
    out["budget_over_nnz_max"] = budget / total
    mcfg = scfg.with_overrides({"runtime.num_devices": MD_DEVICES,
                                "partition.replication": None})
    mplan, mplan_s = plan_store(api, store, mcfg,
                                f"sorted ({MD_DEVICES} devices)")
    r = mplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
        f"cuda:{k % cards}" for k in range(MD_DEVICES)])
    mbudget = stream_budget(mplan.modes)
    print(f"-- {where(mesh)}", flush=True)
    out["md"] = stream_case(api, mplan, mcfg, mbudget, MD_STREAM_SWEEPS,
                            f"stream sorted r={r} x{MD_DEVICES}",
                            mesh=mesh, kernel="ec_sorted")
    out["md"].update(plan_s=mplan_s, r=r)
    return out


OPS_SWEEPS = 4          # checkpoint, traced and profiled runs
OPS_RESTORE_AT = 2      # the sweep a fresh solver restores
CKPT_FIT_TOL = 1e-6     # the reference's resume tolerances
CKPT_FACTOR_TOL = 1e-5  # (tests/test_mttkrp_als.py)
BASELINE_CHUNK = 1 << 16  # blco_like_streaming's default
BASELINE_RTOL = 1e-4
TRACE_COVERAGE = 0.95
TOP = 5
DEVICE_WORK = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_SCOPES = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def counted_run(solver, sweeps: int, devices: int, label: str,
                launched: dict) -> object:
    """``solver.run(sweeps)`` with the launch counts set to 0 just before
    and read just after: ``ec_sorted`` must have launched once per mode,
    device and sweep run; the counts are added to ``launched``."""
    from repro_torch.kernels import _build
    nmodes = solver.plan.nmodes
    before = solver.state.sweep
    sync_all()
    _build.reset_launch_counts()
    res = solver.run(sweeps)
    sync_all()
    want = nmodes * devices * (sweeps - before)
    if _build.LAUNCHES["ec_sorted"] != want:
        fail(f"{label}: ec_sorted launched {_build.LAUNCHES['ec_sorted']} "
             f"times, expected {want}")
    for k, n in _build.LAUNCHES.items():
        launched[k] += n
    return res


def plan_arrays_equal(a, b) -> bool:
    from repro_torch.core.partition import ModePartition
    if tuple(a.shape) != tuple(b.shape) or a.norm != b.norm or \
            a.num_devices != b.num_devices:
        return False
    for d, (pa, pb) in enumerate(zip(a.modes, b.modes)):
        if any(getattr(pa, k) != getattr(pb, k)
               for k in ModePartition.META_FIELDS):
            return False
        arrays = [(a.global_to_padded[d], b.global_to_padded[d]),
                  (a.padded_to_global[d], b.padded_to_global[d])]
        if getattr(pa, "lazy", False):
            arrays.append((pa.rows_owned, pb.rows_owned))
        else:
            arrays += [(getattr(pa, k), getattr(pb, k))
                       for k in ModePartition.ARRAY_FIELDS]
        if not all(x.dtype == y.dtype and np.array_equal(x, y)
                   for x, y in arrays):
            return False
    return True


def plan_cache_case(api, tensor, plan, cfg, store, tmp: str) -> dict:
    """(a) The main path's plan saved into a plan cache and loaded back by
    ``api.plan(..., cache_dir=)``; then the lazy store plan of phase 3."""
    from repro_torch.store import TensorStore
    out = {}
    for label, src, p in (("in-memory", tensor, plan),
                          ("lazy store", store, None)):
        cache = os.path.join(tmp, f"plans-{label.replace(' ', '-')}")
        if p is None:
            p = api.plan(src, cfg)
        sig = api.plan_signature(src, cfg)
        t0 = time.perf_counter()
        api.save_plan(p, os.path.join(cache, sig[:32]), signature=sig)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(root, f))
                   for root, _, files in os.walk(cache) for f in files)
        if p is not plan:
            src = TensorStore(store.path)  # fresh counts of chunk reads
        api.reset_cache_stats()
        t0 = time.perf_counter()
        back = api.plan(src, cfg, cache_dir=cache)
        load_s = time.perf_counter() - t0
        hit = api.CACHE_STATS == {"hits": 1, "misses": 0}
        if not hit:
            fail(f"plan cache ({label}): {api.CACHE_STATS}, expected one hit")
        if not plan_arrays_equal(back, p):
            fail(f"plan cache ({label}): the loaded plan is not the saved "
                 f"one, bitwise")
        reads = None
        if p is not plan:
            reads = back.modes[0].store.access_stats["chunk_reads"]
            if reads:
                fail(f"plan cache ({label}): loading read {reads} chunks")
        print(f"plan cache ({label}): saved in {save_s:.3f} s "
              f"({disk / 2**20:.1f} MiB on disk), loaded through "
              f"api.plan(cache_dir=) in {load_s:.3f} s (cache hit); every "
              f"array bitwise equal"
              + ("; 0 chunk reads" if reads is not None else ""),
              flush=True)
        out[label] = {"save_s": save_s, "load_s": load_s, "disk_bytes": disk}
        del back
        shutil.rmtree(cache, ignore_errors=True)
    return out


def checkpoint_case(api, plan, cfg, kept, tmp: str, cards: int,
                    launched: dict) -> dict:
    """(b) 4 checkpointed sweeps; a fresh solver restored at sweep 2 and
    run to 4; then the r = 2 checkpoint from 4 logical devices restored
    into a one-device solver."""
    from repro_torch.core import mttkrp
    from repro_torch.training import CheckpointManager
    ck = os.path.join(tmp, "ckpt")
    ccfg = cfg.with_overrides({"runtime.checkpoint_dir": ck})
    with api.compile(plan, ccfg) as solver:
        full = counted_run(solver, OPS_SWEEPS, 1, "checkpointed run",
                           launched)
        t0 = time.perf_counter()
        solver.checkpoint()  # sweep 4 again: the save alone, timed
        save_s = time.perf_counter() - t0
    with api.compile(plan, ccfg) as solver:
        t0 = time.perf_counter()
        if not solver.restore(OPS_RESTORE_AT):
            fail(f"no checkpoint of sweep {OPS_RESTORE_AT} in {ck}")
        restore_s = time.perf_counter() - t0
        resumed = counted_run(solver, OPS_SWEEPS, 1, "resumed run", launched)
    fit_err = float(np.abs(np.asarray(resumed.fits)
                           - np.asarray(full.fits)).max())
    factor_err = max(float(np.abs(a - b).max())
                     for a, b in zip(resumed.factors, full.factors))
    print(f"checkpoint: {OPS_SWEEPS} sweeps checkpointed (save "
          f"{save_s:.3f} s); a fresh solver restored sweep "
          f"{OPS_RESTORE_AT} in {restore_s:.3f} s and ran to {OPS_SWEEPS}: "
          f"max |fit diff| {fit_err:.2e}, max |factor diff| "
          f"{factor_err:.2e}", flush=True)
    if fit_err > CKPT_FIT_TOL or factor_err > CKPT_FACTOR_TOL:
        fail(f"resumed run off the uninterrupted one: fits {fit_err:.2e} "
             f"(limit {CKPT_FIT_TOL}), factors {factor_err:.2e} (limit "
             f"{CKPT_FACTOR_TOL})")
    kcfg, kplan = kept
    r = kplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
        f"cuda:{k % cards}" for k in range(MD_DEVICES)])
    ck4 = os.path.join(tmp, "ckpt4")
    with api.compile(kplan, kcfg.with_overrides(
            {"runtime.checkpoint_dir": ck4}), mesh=mesh) as solver:
        counted_run(solver, OPS_RESTORE_AT, MD_DEVICES,
                    f"r={r} x{MD_DEVICES} checkpointed run", launched)
    saved = CheckpointManager(ck4).restore(OPS_RESTORE_AT)
    with api.compile(plan, cfg.with_overrides(
            {"runtime.checkpoint_dir": ck4})) as solver:
        t0 = time.perf_counter()
        if not solver.restore(OPS_RESTORE_AT):
            fail(f"the {MD_DEVICES}-device checkpoint did not restore")
        elastic_s = time.perf_counter() - t0
        got = solver.result()
        if not all(np.array_equal(a, b) for a, b in
                   zip(got.factors, saved["factors"])) or \
                not np.array_equal(got.lam, saved["lam"]):
            fail("the restored factors are not the saved ones, bitwise")
        nxt = counted_run(solver, OPS_RESTORE_AT + 1, 1,
                          "one-device run after the elastic restore",
                          launched)
    before, after = float(saved["fits"][-1]), float(nxt.fits[-1])
    print(f"elastic restore: the r={r} checkpoint of {MD_DEVICES} logical "
          f"devices (sweep {OPS_RESTORE_AT}) restored into a one-device "
          f"solver in {elastic_s:.3f} s, factors and lam bitwise those "
          f"saved; fit {before:.6f} -> {after:.6f} after one more sweep",
          flush=True)
    if after < before - FIT_TOL:
        fail(f"the fit fell after the elastic restore: {before} -> {after}")
    return {"save_s": save_s, "restore_s": restore_s,
            "elastic_restore_s": elastic_s, "max_fit_diff": fit_err,
            "max_factor_diff": factor_err, "elastic_fits": [before, after]}


def baseline_case(tensor, recs) -> list[dict]:
    """(c) ``blco_like_streaming`` per mode at its default chunk, held
    against the plain MTTKRP of the whole tensor on the card."""
    import torch
    from repro_torch.core.baselines import blco_like_streaming
    from repro_torch.kernels.ref import mttkrp_local_ref
    rng = np.random.default_rng(2)
    factors = [torch.from_numpy(rng.uniform(0.1, 1.0, size=(s, 32)).astype(
        np.float32)).cuda() for s in tensor.shape]
    indices = torch.from_numpy(tensor.indices).cuda()
    values = torch.from_numpy(tensor.values).cuda()
    out = []
    for mode in range(tensor.nmodes):
        t0 = time.perf_counter()
        got, times = blco_like_streaming(tensor, factors, mode,
                                         chunk=BASELINE_CHUNK)
        sync_all()
        wall = time.perf_counter() - t0
        plain = mttkrp_local_ref(indices, values, indices[:, mode], factors,
                                 mode, tensor.shape[mode])
        err = float((got - plain).abs().max() / plain.abs().max())
        ec_ms = recs["ec_sorted"][mode]["ms"]
        print(f"baseline mode {mode}: {times['chunks']} chunks of "
              f"{BASELINE_CHUNK}; h2d {times['h2d_s']:.3f} s, EC "
              f"{times['ec_s']:.3f} s (CUDA events), wall {wall:.2f} s "
              f"(host sort and pads included); ec_sorted on the resident "
              f"shard {ec_ms:.3f} ms; max|baseline - plain| / max|plain| "
              f"{err:.2e}", flush=True)
        if err > BASELINE_RTOL:
            fail(f"baseline mode {mode}: relative error {err:.2e} > "
                 f"{BASELINE_RTOL}")
        out.append({**times, "wall_s": wall, "rel_err": err,
                    "ec_sorted_ms": ec_ms})
        del got, plain
    del indices, values, factors
    torch.cuda.empty_cache()
    return out


def span_sweep(records) -> dict:
    """Each record's id → the ``sweep`` attribute of its sweep span (None
    outside a sweep)."""
    by_id = {r["id"]: r for r in records}

    def sweep_of(r):
        while r is not None:
            if r["name"] == "sweep":
                return r["attrs"]["sweep"]
            r = by_id.get(r["parent"])
        return None

    return {r["id"]: sweep_of(r) for r in records}


def traced_case(api, plan, cfg, fits, tmp: str, launched: dict) -> dict:
    """(d) 4 traced sweeps: fits bitwise the main path's, the trace valid
    at 95 % coverage with the expected span counts; per span name the
    total and median ms over sweeps 2-4."""
    from repro_torch import obs
    from repro_torch.obs.export import validate_trace
    obs.reset()
    tcfg = cfg.with_overrides({"runtime.trace": True})
    try:
        with api.compile(plan, tcfg) as solver:
            res = counted_run(solver, OPS_SWEEPS, 1, "traced run", launched)
            trace = solver.dump_trace(os.path.join(tmp, "trace.json"))
        records = obs.trace.get_tracer().records()
    finally:
        obs.reset()  # the tracer is process-wide: off for what follows
    if not np.array_equal(np.asarray(res.fits), fits[:OPS_SWEEPS]):
        fail(f"traced fits {res.fits} are not the untraced "
             f"{fits[:OPS_SWEEPS].tolist()}, bitwise")
    check = validate_trace(trace, min_coverage=TRACE_COVERAGE)
    counts = check["span_counts"]
    want = {"run": 1, "sweep": OPS_SWEEPS,
            **{n: plan.nmodes * OPS_SWEEPS
               for n in ("mode_update", "ec", "exchange")}}
    if not check["ok"] or any(counts.get(k) != v for k, v in want.items()):
        fail(f"trace: {check['problems']}; span counts {counts}, expected "
             f"{want}")
    sweep_of = span_sweep(records)
    steady = {}
    for r in records:
        if (sweep_of[r["id"]] or 0) >= 2:
            steady.setdefault(r["name"], []).append(1e3 * (r["t1"] - r["t0"]))
    stats = {n: {"total_ms": float(sum(v)), "median_ms": float(np.median(v)),
                 "count": len(v)} for n, v in sorted(steady.items())}
    print(f"traced run: fits bitwise the untraced run's; trace valid, "
          f"coverage {check['coverage']:.1%}, spans {counts}", flush=True)
    for n, st in stats.items():
        print(f"  span {n}: {st['count']} over sweeps 2-{OPS_SWEEPS}, total "
              f"{st['total_ms']:.3f} ms, median {st['median_ms']:.3f} ms",
              flush=True)
    return {"coverage": check["coverage"], "span_counts": counts,
            "steady_spans": stats,
            "traced_sweep_ms": stats["sweep"]["median_ms"]}


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def is_device_work(category) -> bool:
    """Kernels and copies on the card, by their category in the
    profiler's Chrome trace (device-side annotation ranges and
    synchronisation records are not work)."""
    return category in DEVICE_WORK


def _device_time_total(prof) -> float:
    return sum(getattr(e, "device_time_total", 0)
               or getattr(e, "cuda_time_total", 0)
               for e in prof.key_averages())


def profiled_events(solver, first: int, sweeps: int, tmp: str, *,
                    with_stack: bool = False):
    """Sweeps ``first`` .. ``first + sweeps - 1`` of ``solver`` under
    ``torch.profiler`` (CPU and CUDA activities), each in a
    ``record_function`` scope, all in one ``profiled_window`` that ends in
    a synchronise. Returns ``(events, None)`` — ``(name, start_ns,
    end_ns, category)`` from the profiler's Chrome trace, whose CPU and
    device times share one clock — or ``(None, why)`` when the profiler
    shows no device time or fails."""
    from torch.profiler import ProfilerActivity, profile, record_function
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=with_stack) as prof:
            with record_function("profiled_window"):
                for k in range(first, first + sweeps):
                    with record_function(f"sweep {k}"):
                        solver.sweep()
                sync_all()
    except RuntimeError as e:
        return None, f"torch.profiler failed: {e}"
    if _device_time_total(prof) <= 0:
        return None, "key_averages() shows no device time"
    path = os.path.join(tmp, "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and "dur" in e]
    os.remove(path)
    print(f"profiler: event categories "
          f"{sorted({str(e.get('cat')) for e in spans})}; counted as busy "
          f"{sorted(DEVICE_WORK)}", flush=True)
    return [(e["name"], int(1e3 * float(e["ts"])),
             int(1e3 * (float(e["ts"]) + float(e["dur"]))), e.get("cat"))
            for e in spans], None


def timeline(events, host_scopes) -> dict:
    """The device's busy share of the ``profiled_window`` (the union of
    kernel and copy intervals), the longest device operations by name, the
    longest idle gaps with the host scopes open at their midpoints, and
    all idle time summed by scope: the innermost ``repro_torch`` frame
    when the trace has Python stacks, else the innermost host scope."""
    cpu = [e for e in events if e[3] in host_scopes]
    dev = [e for e in events if is_device_work(e[3])]
    w0, w1 = next((a, b) for n, a, b, _ in cpu if n == "profiled_window")
    busy = _merged([(max(a, w0), min(b, w1))
                    for _, a, b, _ in dev if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)
    ops = {}
    for n, a, b, _ in dev:
        o = ops.setdefault(n, [0.0, 0])
        o[0] += (b - a) / 1e6
        o[1] += 1
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)

    def scopes(t):
        """The host scopes open at time ``t``, innermost first."""
        return [n for _, n in sorted((b - a, n) for n, a, b, _ in cpu
                                     if a <= t <= b
                                     and n != "profiled_window")]

    idle = {}
    for g, a, b in gaps:
        open_ = scopes((a + b) // 2)
        key = next((n for n in open_ if "repro_torch" in n),
                   open_[0] if open_ else "(no host op)")
        idle[key] = idle.get(key, 0.0) + g / 1e6
    return {
        "window_ms": (w1 - w0) / 1e6, "busy_ms": busy_ns / 1e6,
        "busy_share": busy_ns / (w1 - w0), "gap_count": len(gaps),
        "top_ops": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in
                    sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "gaps": [{"ms": g / 1e6,
                  "scope": " < ".join(scopes((a + b) // 2)[:3])
                  or "(no host op)"} for g, a, b in gaps[:TOP]],
        "idle_by_scope": [{"scope": k, "ms": v} for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def print_idle(t: dict, label: str) -> None:
    for g in t["gaps"]:
        print(f"  idle gap {g['ms']:8.3f} ms under {g['scope'][:160]}",
              flush=True)
    print(f"  idle time by {label} ({t['gap_count']} gaps, "
          f"{t['window_ms'] - t['busy_ms']:.3f} ms in all):", flush=True)
    for g in t["idle_by_scope"]:
        print(f"    {g['ms']:8.3f} ms  {g['scope'][:160]}", flush=True)


def profile_case(api, plan, cfg, tmp: str, launched: dict) -> dict:
    """(e) Sweeps 2-4 of an untraced run under ``torch.profiler``: the
    device's busy share, the longest device operations and idle gaps, and
    the idle time by host scope; then sweep 5 with Python stacks, for the
    ``repro_torch`` function each idle gap falls under (stack sampling
    slows the host, so that sweep gives no busy share). Then the traced
    against the untraced sweep on this one solver, tracing switched per
    sweep in turns (plain, traced, traced, plain, twice over), each sweep
    timed by the host clock to a synchronise."""
    from repro_torch import obs
    from repro_torch.kernels import _build
    out = {}
    with api.compile(plan, cfg) as solver:
        counted_run(solver, 1, 1, "untraced run (sweep 1)", launched)
        _build.reset_launch_counts()
        events, why = profiled_events(solver, 2, OPS_SWEEPS - 1, tmp)
        swept = OPS_SWEEPS - 1
        if why is None:
            t = timeline(events, HOST_SCOPES)
            out.update(method="torch.profiler", **t)
            print(f"method: torch.profiler (CPU + CUDA activities); device "
                  f"busy share of sweeps 2-{OPS_SWEEPS} = "
                  f"{t['busy_share']:.1%} ({t['busy_ms']:.3f} ms busy in a "
                  f"{t['window_ms']:.3f} ms window: the union of kernel and "
                  f"copy intervals)", flush=True)
            for o in t["top_ops"]:
                print(f"  device op {o['ms']:9.3f} ms x{o['count']:4d}  "
                      f"{o['name'][:100]}", flush=True)
            print_idle(t, "innermost host scope")
            events, _ = profiled_events(solver, OPS_SWEEPS + 1, 1, tmp,
                                        with_stack=True)
            swept += 1
            if events is not None:
                st = timeline(events, HOST_SCOPES | {"python_function"})
                out["stacks"] = {k: st[k] for k in
                                 ("window_ms", "busy_ms", "gap_count",
                                  "gaps", "idle_by_scope")}
                print(f"sweep {OPS_SWEEPS + 1} with Python stacks (a slower "
                      f"host): {st['window_ms']:.3f} ms, "
                      f"{st['busy_ms']:.3f} ms busy", flush=True)
                print_idle(st, "innermost repro_torch function")
        else:
            print(f"profiler: {why}; device busy share not measured; "
                  f"falling back to CUDA-event stage times", flush=True)
            stages = stage_ms(solver)
            print(f"method: CUDA events per stage; per mode EC ms "
                  f"{[round(x['ec_ms'], 3) for x in stages]}, exchange ms "
                  f"{[round(x['exchange_ms'], 3) for x in stages]}",
                  flush=True)
            out.update(method="cuda events", reason=why, stages=stages)
        walls = {"plain": [], "traced": []}
        try:
            for mode in ("plain", "traced", "traced", "plain") * 2:
                (obs.trace.enable if mode == "traced"
                 else obs.trace.disable)()
                sync_all()
                t0 = time.perf_counter()
                solver.sweep()
                sync_all()
                walls[mode].append(1e3 * (time.perf_counter() - t0))
        finally:
            obs.reset()
        swept += 8
        want = plan.nmodes * swept
        if _build.LAUNCHES["ec_sorted"] != want:
            fail(f"phase (e) launched ec_sorted "
                 f"{_build.LAUNCHES['ec_sorted']} times in {swept} sweeps")
        for k, n in _build.LAUNCHES.items():
            launched[k] += n
    out["sweep_ms"] = walls
    print(f"sweeps in turns on one solver (host clock to a synchronise): "
          f"untraced {[round(w, 3) for w in walls['plain']]} ms, traced "
          f"{[round(w, 3) for w in walls['traced']]} ms", flush=True)
    return out


def operations_phase(api, tensor, plan, cfg, store, kept, fits, recs,
                     tmp: str, cards: int) -> dict:
    """Phase 11: the plan cache, checkpoints and an elastic restore, the
    BLCO-style baseline, traced sweeps and the device's busy share, on the
    main path's amazon plan (R 32, ``sorted``, tile 8, block_p 128)."""
    launched = {k: 0 for k in KERNELS}
    out = {"plan_cache": plan_cache_case(api, tensor, plan, cfg, store,
                                         tmp)}
    out["checkpoint"] = checkpoint_case(api, plan, cfg, kept, tmp, cards,
                                        launched)
    out["baseline"] = baseline_case(tensor, recs)
    out["traced"] = traced_case(api, plan, cfg, fits, tmp, launched)
    out["profile"] = profile_case(api, plan, cfg, tmp, launched)
    walls = out["profile"]["sweep_ms"]
    print(f"steady sweep: traced {np.median(walls['traced']):.3f} ms vs "
          f"untraced {np.median(walls['plain']):.3f} ms (medians of 4, in "
          f"turns); the traced run's sweep spans "
          f"{out['traced']['traced_sweep_ms']:.3f} ms (median, sweeps "
          f"2-{OPS_SWEEPS})", flush=True)
    out["launches"] = launched
    return out


# -- phase 12: serve + analysis ----------------------------------------------

SERVE_CLIENTS = 8           # client threads of the query load
SERVE_REQUESTS = 200        # reconstruct requests per client
SERVE_BATCH = 16            # coordinates per request
SERVE_EDGES = (1, 7, 9, 100, 257)  # bucket-boundary request sizes
SERVE_TOPK = 20             # top-k slices on mode 0
SERVE_K = 10
SERVE_APPEND = 0.01         # appended share of the store's nonzeros
SERVE_SWEEPS = 3            # sweeps of the refit
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5  # tests/test_serve.py's tolerance
TOPK_TIE_RTOL = 1e-5        # dense scores this close may swap places


def model_at(factors, lam, ind) -> np.ndarray:
    """The float64 numpy model at ``(k, nmodes)`` coordinates."""
    acc = np.ones((ind.shape[0], lam.shape[0]), np.float64)
    for w, f in enumerate(factors):
        acc *= np.asarray(f, np.float64)[ind[:, w]]
    return acc @ np.asarray(lam, np.float64)


def coords_of(rng, shape, n) -> np.ndarray:
    return np.stack([rng.integers(0, s, size=n) for s in shape], axis=1)


def query_load(svc, factors, lam) -> dict:
    """(b) SERVE_CLIENTS threads x SERVE_REQUESTS batched reconstructs,
    the bucket-boundary sizes, then SERVE_TOPK top-k slices on mode 0,
    each held against the float64 numpy model."""
    import threading
    shape = svc.engine.snapshot.shape
    results, errors = [], []

    def client(c):
        rng = np.random.default_rng(100 + c)
        try:
            for _ in range(SERVE_REQUESTS):
                ind = coords_of(rng, shape, SERVE_BATCH)
                results.append((ind, svc.reconstruct(ind, deadline_s=30.0)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"a query failed under load: {errors[0]!r}")
    rng = np.random.default_rng(7)
    for n in SERVE_EDGES:
        ind = coords_of(rng, shape, n)
        results.append((ind, svc.reconstruct(ind, deadline_s=30.0)))
    worst = 0.0  # the largest |diff| as a share of its allowance
    for ind, got in results:
        want = model_at(factors, lam, ind)
        share = np.abs(got - want) / (SERVE_ATOL + SERVE_RTOL * np.abs(want))
        worst = max(worst, float(share.max()))
    if worst > 1.0:
        fail(f"reconstruct off the float64 model beyond rtol {SERVE_RTOL} "
             f"/ atol {SERVE_ATOL} ({worst:.2f} of the allowance)")
    rows = SERVE_CLIENTS * SERVE_REQUESTS * SERVE_BATCH
    topk_ms, score_err, checked = [], 0.0, 0
    f0 = np.asarray(factors[0], np.float64)
    for _ in range(SERVE_TOPK):
        fixed = coords_of(rng, shape, 1)[0]
        t0 = time.perf_counter()
        scores, idx = svc.topk(fixed, mode=0, k=SERVE_K)
        topk_ms.append((time.perf_counter() - t0) * 1e3)
        w = np.asarray(lam, np.float64).copy()
        for u in range(1, len(shape)):
            w *= np.asarray(factors[u], np.float64)[fixed[u]]
        dense = f0 @ w
        order = np.argsort(-dense, kind="stable")[:SERVE_K + 1]
        top = dense[order]
        score_err = max(score_err, float(np.abs(scores - top[:SERVE_K])
                                         .max()))
        if not np.allclose(scores, top[:SERVE_K], rtol=0, atol=1e-4):
            fail(f"top-k scores off numpy's dense scores by "
                 f"{np.abs(scores - top[:SERVE_K]).max():.3e} (limit 1e-4)")
        gap = np.abs(np.diff(top)) > TOPK_TIE_RTOL * np.abs(top[:-1])
        for j in range(SERVE_K):  # a position clear of both neighbours
            if gap[j] and (j == 0 or gap[j - 1]):
                checked += 1
                if idx[j] != order[j]:
                    fail(f"top-k position {j}: index {idx[j]}, numpy's "
                         f"dense order has {order[j]}")
    print(f"serve (b): {SERVE_CLIENTS} clients x {SERVE_REQUESTS} "
          f"reconstructs of {SERVE_BATCH} in {wall:.3f} s "
          f"({rows / wall:.0f} rows/s), within rtol {SERVE_RTOL} / atol "
          f"{SERVE_ATOL} of the float64 model (worst {worst:.3f} of the "
          f"limit); sizes {list(SERVE_EDGES)} too; {SERVE_TOPK} top-{SERVE_K}"
          f" slices of mode 0 ({shape[0]} rows): median "
          f"{np.median(topk_ms):.3f} ms, scores within {score_err:.2e} of "
          f"numpy's, {checked} positions clear of ties equal", flush=True)
    return {"rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
            "topk_ms": topk_ms, "topk_score_err": score_err,
            "worst_of_limit": worst}


def refresh_during_queries(svc, tensor, store_path) -> dict:
    """(c) Append SERVE_APPEND of the store's nonzeros at a seeded sample
    of the stored coordinates with fresh seeded values (standard normal,
    as the profile generator draws them), refresh in the
    background and query until it ends: every answer bitwise v1's or
    v2's, v2 published, ``ec_sorted`` launched SERVE_SWEEPS x nmodes times
    by the refit."""
    import threading
    from repro_torch.kernels import _build
    from repro_torch.store import append_to_store
    shape = svc.engine.snapshot.shape
    rng = np.random.default_rng(11)
    n_app = int(round(SERVE_APPEND * svc.store.nnz))
    pos = rng.choice(tensor.nnz, size=n_app, replace=False)
    ind = tensor.indices[np.sort(pos)].astype(np.int64)
    # the profile generator's value distribution (core/coo.py)
    val = rng.standard_normal(n_app).astype(np.float32)
    t0 = time.perf_counter()
    append_to_store(store_path, ind, val)
    append_s = time.perf_counter() - t0
    batches = [coords_of(np.random.default_rng(200 + c), shape, 64)
               for c in range(4)]
    fixed = coords_of(rng, shape, 1)[0]
    v1 = [svc.reconstruct(b) for b in batches]
    top1 = svc.topk(fixed, mode=0, k=SERVE_K)
    answers, errors = [[] for _ in batches], []
    tops = []
    sync_all()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    event = svc.refresh(sweeps=SERVE_SWEEPS, wait=False)
    if not event.get("background"):
        fail(f"the refresh did not start in the background: {event}")

    def client(c):
        # refresh() raised the gauge before it returned; the last query
        # starts after the gauge fell, so after v2 was published
        try:
            while True:
                running = svc.metrics.gauge("refit_in_progress", 0) == 1
                answers[c].append(svc.reconstruct(batches[c],
                                                  deadline_s=30.0))
                if c == 0:
                    tops.append(svc.topk(fixed, mode=0, k=SERVE_K))
                if not running:
                    break
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(batches))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    done = svc.wait_refresh()
    wall = time.perf_counter() - t0
    sync_all()
    launches = dict(_build.LAUNCHES)
    if errors:
        fail(f"a query failed during the refit: {errors[0]!r}")
    if not done or not done.get("published") or svc.engine.version != 2:
        fail(f"the refit did not publish v2: {done}")
    want = SERVE_SWEEPS * len(shape)
    if launches["ec_sorted"] != want or \
            launches["ec_fused"] or launches["ec_blocked"]:
        fail(f"the refit launched {launches}, expected ec_sorted {want} "
             f"times and nothing else")
    v2 = [svc.reconstruct(b) for b in batches]
    top2 = svc.topk(fixed, mode=0, k=SERVE_K)
    n_v1 = n_v2 = 0
    for c, got in enumerate(answers):
        c_v1 = 0
        for a in got:
            if np.array_equal(a, v1[c]):
                c_v1 += 1
            elif not np.array_equal(a, v2[c]):
                fail(f"client {c}: an answer during the refit is neither "
                     f"v1's nor v2's bits")
        # v1 answers were served while the refit ran; the last query
        # started after the publish
        if c_v1 == 0 or not np.array_equal(got[-1], v2[c]):
            fail(f"client {c}: {c_v1} v1 answers of {len(got)}, last "
                 f"{'v2' if np.array_equal(got[-1], v2[c]) else 'v1'}: "
                 f"the queries did not span the refit")
        n_v1 += c_v1
        n_v2 += len(got) - c_v1
    for sc, ix in tops:
        if not (np.array_equal(sc, top1[0]) and np.array_equal(ix, top1[1])
                or np.array_equal(sc, top2[0])
                and np.array_equal(ix, top2[1])):
            fail("a top-k answer during the refit is neither v1's nor "
                 "v2's bits")
    if not (np.array_equal(tops[-1][0], top2[0])
            and np.array_equal(tops[-1][1], top2[1])):
        fail("the last top-k answer, begun after the publish, is not v2's")
    if all(np.array_equal(a, b) for a, b in zip(v1, v2)):
        fail("v2 answers as v1 does: the bitwise check means nothing")
    refit = done["refit"]
    sec = dict(refit["seconds"], sample_fit=done["sample_fit_s"])
    print(f"serve (c): appended {n_app} nonzeros in {append_s:.2f} s; "
          f"background refresh of {SERVE_SWEEPS} sweeps in {wall:.2f} s "
          f"(plan {sec['plan']:.2f} | compile {sec['compile']:.2f} | "
          f"sweeps {sec['sweeps']:.3f} | freeze-blend "
          f"{sec['freeze_blend']:.2f} | store_fit {sec['store_fit']:.2f} | "
          f"sample_fit {sec['sample_fit']:.2f} s); sweep fits "
          f"{[round(f, 6) for f in refit['sweep_fits']]}, store fit "
          f"{refit['fit']:.6f}, sample fit {done['sample_fit_current']:.6f}"
          f" -> {done['sample_fit_candidate']:.6f}; v2 published; "
          f"{n_v1} answers v1's and {n_v2} v2's bits ({len(tops)} top-k "
          f"too); the refit launched ec_sorted {launches['ec_sorted']} "
          f"times", flush=True)
    return {"appended": n_app, "append_s": append_s, "wall_s": wall,
            "seconds": sec, "sweep_fits": refit["sweep_fits"],
            "fit": refit["fit"], "answers_v1": n_v1, "answers_v2": n_v2,
            "topk_during": len(tops), "launches": launches,
            "affected_rows": refit["affected_rows"]}


def rollback_case(svc, ck: str, shape, rank: int) -> dict:
    """(d) A checkpoint of random factors must roll back on the held-out
    sample fit; the engine stays at v2."""
    from repro_torch.training import CheckpointManager
    rng = np.random.default_rng(6)
    CheckpointManager(ck).save(99, {
        "factors": [rng.standard_normal((s, rank)).astype(np.float32)
                    for s in shape],
        "lam": np.ones(rank, np.float32), "fits": np.array([0.0])})
    t0 = time.perf_counter()
    event = svc.deploy_checkpoint()
    wall = time.perf_counter() - t0
    if not event["rolled_back"] or event["published"] or \
            svc.engine.version != 2 or \
            svc.metrics.counter("rollbacks_total") != 1:
        fail(f"the random checkpoint was not rolled back: {event}")
    print(f"serve (d): a checkpoint of random factors rolled back in "
          f"{wall:.2f} s (sample fit {event['sample_fit_current']:.6f} vs "
          f"{event['sample_fit_candidate']:.6f}); the engine stays at v2",
          flush=True)
    return {"wall_s": wall, "sample_fit_s": event["sample_fit_s"],
            "sample_fit_current": event["sample_fit_current"],
            "sample_fit_candidate": event["sample_fit_candidate"]}


def analysis_case(api, plan, cfg, store, kept, svc, cards: int) -> dict:
    """(e) The plan rules on the main plan and at plan time, the audit of
    the main path's solver and of a bf16-wire run on 4 logical devices,
    the serving bucket bound and the concurrency lint."""
    import torch
    from repro_torch.analysis import (audit_ec_kernel, audit_serving_engine,
                                      check_plan, errors, hlo_audit,
                                      lint_default_targets)
    from repro_torch.core import mttkrp
    out = {}
    t0 = time.perf_counter()
    bad = errors(check_plan(plan, cfg, deep=True))
    out["check_plan_s"] = time.perf_counter() - t0
    if bad:
        fail(f"check_plan on the main plan: {bad}")
    t0 = time.perf_counter()
    api.plan(store, cfg, analyze="strict")  # raises on an AP error
    out["plan_strict_s"] = time.perf_counter() - t0
    part = plan.modes[0]
    for variant in ("sorted", "fused"):
        found = audit_ec_kernel(variant, nmodes=plan.nmodes, rank=cfg.rank,
                                tile=part.tile, block_p=part.block_p)
        if found:
            fail(f"AH-H001 on {variant}: {found}")
    recs, slots = hlo_audit.ec_recorded_ops(
        "blocked", nmodes=plan.nmodes, rank=cfg.rank, tile=part.tile,
        block_p=part.block_p)
    pre = audit_ec_kernel("sorted", nmodes=plan.nmodes, rank=cfg.rank,
                          recorded_ops=recs, slots=slots)
    if [f.rule for f in pre] != ["AH-H001"]:
        fail(f"AH-H001 did not see blocked's pre-gather: {pre}")
    with api.compile(plan, cfg) as solver:
        solver.run(1)
        before = [[f.clone() for f in reps] for reps in solver.state.factors]
        lam = [x.clone() for x in solver.state.lam]
        grams = [[g.clone() for g in reps] for reps in solver.state.grams]
        t0 = time.perf_counter()
        found = solver.audit()
        out["audit_s"] = time.perf_counter() - t0
        same = all(torch.equal(a, b) for x, y in
                   zip(solver.state.factors + solver.state.grams,
                       before + grams) for a, b in zip(x, y)) and \
            all(torch.equal(a, b) for a, b in zip(solver.state.lam, lam))
    if not same:
        fail("the audit changed the solver's state")
    h002 = [f for f in found if f.rule == "AH-H002"]
    other = [f for f in found if f.rule != "AH-H002"]
    if other:
        fail(f"the audit of the main path's solver: {other}")
    for f in h002:
        print(f"  audit: {f}")
    if not any("_pinv_psd" in f.message for f in h002):
        print("  audit: no AH-H002 finding names _pinv_psd (eigh's sync "
              "was expected)")
    kcfg, kplan = kept
    r = kplan.modes[0].r
    mesh = mttkrp.cp_mesh(MD_DEVICES, r, devices=[
        f"cuda:{k % cards}" for k in range(MD_DEVICES)])
    bcfg = kcfg.with_overrides({"exchange.variant": "overlap",
                                "exchange.wire_dtype": "bfloat16"})
    with api.compile(kplan, bcfg, mesh=mesh) as solver:
        t0 = time.perf_counter()
        mfound = solver.audit(modes=[0])
        out["audit_bf16_s"] = time.perf_counter() - t0
    if [f for f in mfound if f.rule == "AH-H005"]:
        fail(f"AH-H005 on the bf16-wire run: {mfound}")
    buckets = audit_serving_engine(svc.engine)
    if buckets:
        fail(f"AH-H006: {buckets}")
    lint = lint_default_targets()
    if lint:
        fail(f"the concurrency lint: {lint}")
    print(f"serve (e): check_plan (deep) on the main plan in "
          f"{out['check_plan_s']:.2f} s and api.plan(store, "
          f"analyze='strict') in {out['plan_strict_s']:.2f} s: no AP error;"
          f" AH-H001 clean for sorted and fused, blocked's pre-gather "
          f"found; the solver's audit in {out['audit_s']:.2f} s, state "
          f"unchanged, {len(h002)} AH-H002 finding(s) above; AH-H005 clean"
          f" on the r={r} x{MD_DEVICES} bf16-wire run (audit "
          f"{out['audit_bf16_s']:.2f} s, mode 0; "
          f"{len([f for f in mfound if f.rule == 'AH-H002'])} AH-H002); "
          f"AH-H006 clean; concurrency lint clean", flush=True)
    out["h002"] = [str(f) for f in h002]
    out["h002_bf16"] = [str(f) for f in mfound if f.rule == "AH-H002"]
    return out


def serve_phase(api, tensor, plan, cfg, store, kept, tmp: str,
                cards: int) -> dict:
    """Phase 12: ``CPService`` booted from phase 11(b)'s checkpoints over a
    copy of phase 3's store, under load, through a background refit that
    launches ``ec_sorted``, a rollback, then the analysis passes."""
    from repro_torch.serve import CPService
    from repro_torch.store import TensorStore
    ck = os.path.join(tmp, "ckpt")
    path = os.path.join(tmp, "serve.store")
    t0 = time.perf_counter()
    shutil.copytree(store.path, path)
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = CPService.boot(ck, store=TensorStore(path), config=cfg)
    boot_s = time.perf_counter() - t0
    out = {"copy_s": copy_s, "boot_s": boot_s}
    try:
        snap = svc.engine.snapshot
        print(f"serve (a): booted v{snap.version} ({snap.source}, shape "
              f"{snap.shape}, R {snap.rank}, on {snap.device}) in "
              f"{boot_s:.2f} s over a copy of the store ({copy_s:.2f} s)",
              flush=True)
        out["load"] = query_load(svc, snap.host_factors(), snap.host_lam())
        out["refresh"] = refresh_during_queries(svc, tensor, path)
        out["rollback"] = rollback_case(svc, ck, snap.shape, snap.rank)
        rep = svc.metrics_report()
        for op, lat in sorted(rep["latency"].items()):
            print(f"  latency {op}: {lat['count']} samples, p50 "
                  f"{lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms")
        g = rep["gauges"]
        print(f"  buckets: reconstruct {g.get('reconstruct_buckets')}, topk"
              f" {g.get('topk_buckets')}; counters {rep['counters']}",
              flush=True)
        out["latency"] = rep["latency"]
        out["gauges"] = g
        out["counters"] = rep["counters"]
        out["analysis"] = analysis_case(api, plan, cfg, store, kept, svc,
                                        cards)
    finally:
        svc.close()
    out["launches"] = out["refresh"]["launches"]
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
    if _build.CHUNK_BLOCKS != CHUNK_BLOCKS:
        fail(f"CHUNK_BLOCKS is {_build.CHUNK_BLOCKS} in the kernels, "
             f"{CHUNK_BLOCKS} here")

    phase("build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"  [{name}] {line.strip()}")

    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        run_phases(args, api, kind, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(args, api, kind: str, smi: str, tmp: str) -> None:
    import torch
    from repro_torch.kernels import _build, autotune
    from repro_torch.sparse.io import make_profile_tensor
    # the tuners' winners go to a file of this run, not to ~/.cache
    os.environ[autotune.ENV_CACHE] = os.path.join(tmp, "autotune.json")

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
    store, st = store_phase(tensor, tmp)

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
    md, kept = multi_device(api, store, cfg, fits, args.cards)
    md_launches = {name: sum(run["launches"] for p in md["plans"]
                             for run in p["runs"].values()
                             if f"ec_{run['variant']}" == name)
                   for name in KERNELS}

    phase("rebalance")
    rb = rebalance_phase(api, cfg, kept, fits, args.cards)
    rb_runs = [rb[c][m] for c in ("amazon", "hot_index")
               for m in ("measure", "on")]

    phase("ref order")
    paper_plan, paper_res, ref_rec = ref_order_phase(api, store, kept,
                                                     args.cards)

    phase("presets")
    presets = presets_phase(api, store, plan, fits, kept, args.cards)

    phase("streaming")
    stream = streaming_phase(api, store, paper_plan, paper_res,
                             args.cards)
    del paper_plan, paper_res

    phase("operations")
    ops = operations_phase(api, tensor, plan, cfg, store, kept, fits, recs,
                           tmp, args.cards)

    phase("serve + analysis")
    serve = serve_phase(api, tensor, plan, cfg, store, kept, tmp,
                        args.cards)
    del kept, store

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
            # the EC autotuner's candidate runs (presets phase), and the
            # fused and sorted presets' runs with the tuned geometry
            "tuner_launches": presets["tuner_launches"][name],
            "preset_launches": sum(presets[p]["launches"]
                                   for p in ("fused", "sorted")
                                   if f"ec_{p}" == name),
            # every window of the streamed runs (one and four devices)
            "stream_launches": sum(stream[c]["launches"][name]
                                   for c in ("sorted", "paper", "md")),
            # the operations phase's checkpointed, restored, traced and
            # profiled runs
            "operations_launches": ops["launches"][name],
            # the serving refit's sweeps (phase 12)
            "serve_launches": serve["launches"][name],
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
              "store": st, "ref_order": ref_rec, "presets": presets,
              "streaming": stream, "operations": ops, "serve": serve,
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
