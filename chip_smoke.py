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
6. Summary: one JSON line ``{"kernels": [...]}`` (``ms``, ``plain_ms`` and
   ``bound_ms`` summed over the three modes, i.e. one sweep's launches;
   ``launches`` from the main-path run), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``. With ``--out PATH``
   every per-mode number also goes to a JSON file.
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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
    factors = als.init_factors(plan, rank, seed=1, device="cuda")
    recs = {k: [] for k in KERNELS}
    for mode, part in enumerate(plan.modes):
        outs = {}
        dev = mttkrp.shard_plan_mode(part, "cuda")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=3e-2,
                    help="amazon profile scale (3e-2: 20.2 M nonzeros)")
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
    from repro_torch.core.mttkrp import shard_plan_mode
    shard_bytes = [shard_plan_mode(p, "cpu").nbytes() for p in plan.modes]
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

    phase("summary")
    kernels = []
    for name in KERNELS:
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
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
              "per_mode": recs, "kernels": kernels}
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
