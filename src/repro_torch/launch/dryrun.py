"""Multi-pod dry-run: every (arch × shape × mesh) cell on the ``meta`` device.

The port's counterpart of the reference package's ``launch/dryrun.py``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_1b \\
        --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch cp --cp-exchange-ab

The reference lowers and compiles each cell for 512 placeholder devices
and reads its memory, FLOPs and collectives from XLA. The port has no
compiler to ask. It runs each cell's function (``launch.shapes``) on
tensors of the ``meta`` device, which carry shapes and dtypes and no
storage, so nothing is allocated and no card is needed:

* FLOPs are counted under ``FlopCounterMode`` while the function runs
  (``launch.roofline.count_flops``) at two depths of the layer pattern,
  one cycle apart, that cycle weighted by the cycle count
  (:func:`counted_work`); the whole cell is divided over the chips;
* ``memory_analysis`` holds the bytes of the cell's arguments that one
  device holds under their placements (``argument_size_in_bytes``); the
  reference's other memory keys and ``t_compile_s``, ``hlo_bytes`` and the
  raw HLO costs have nothing to read and hold ``null``;
* collective bytes are the MoE all-to-all's, counted where a cell runs the
  ``a2a`` dispatch, and the CP cell's exchange from the exchange model;
  the GSPMD collectives of a sharded LM layer are ``null``, with a reason.

``run_cp_cell`` builds one device's ``DeviceArrays`` of the billion-scale
CP step on ``meta`` and takes the EC's operations and bytes from its slot
count, as the kernels' bound does: a kernel cannot run on meta tensors.

Records go to ``experiments/dryrun_torch/`` (``--out-dir`` elsewhere),
never over the reference's ``experiments/dryrun/``. A failed cell is a
record with ``ok: false`` and makes the command exit non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.comm import volume
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import (make_cp_production_mesh,
                                     make_production_mesh)
from repro_torch.launch.shapes import SHAPE_CELLS, input_specs, supports_cell

__all__ = ["run_cell", "run_cp_cell", "run_cp_exchange_ab", "main",
           "counted_work", "OUT_DIR"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the reference reads these from compiled HLO; a one-controller port
# inserts no collective of its own around a sharded LM layer
GSPMD_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                     "collective-permute")
GSPMD_NULL_REASON = (
    "GSPMD's collectives of the TP/DP layout (all-gather, all-reduce, "
    "reduce-scatter, collective-permute) have no counterpart: the port "
    "runs one controller and lowers no HLO")

_MEM_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes",
             "alias_size_in_bytes")


def _mem_dict(arg_bytes: int) -> dict:
    out = {k: None for k in _MEM_KEYS}
    out["argument_size_in_bytes"] = int(arg_bytes)
    return out


def _save(rec: dict, name: str, out_dir: str | None) -> None:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _a2a_bytes_per_chip(chips: int) -> float:
    """The most all-to-all bytes one logical device sent (each shard sends
    the same buckets)."""
    return float(max((volume.sent_by_kind(d).get("all_to_all", 0)
                      for d in range(chips)), default=0))


def counted_work(arch: str, cell: str, mesh, *, variant: str = "full",
                 **kw) -> tuple[float, float]:
    """(FLOPs of the whole cell, all-to-all bytes one device sends), run
    on ``meta``. Every cycle of a config's layer pattern has the same
    shapes, so the cell runs at two depths, ``c0`` and ``c0 + 1`` cycles,
    and the cycle's difference counts for the rest: the reference's HLO
    count weights a scan body by its trip count the same way. (At full
    depth a cell makes ``n_cycles`` times the Python calls, and an
    attention layer at S 32,768 makes ~75 k of them.) ``c0`` is 0, but 1
    for an encoder-decoder's training step: with no decoder layer nothing
    takes the encoder's output, and its backward would drop out."""
    cfg = get_config(arch, variant)
    chips = math.prod(mesh.shape[a] for a in mesh.axis_names)
    c0 = int(SHAPE_CELLS[cell]["kind"] == "train" and cfg.encoder is not None)
    depths = (c0, c0 + 1) if cfg.n_cycles > c0 + 1 else (cfg.n_cycles,)
    out = []
    for c in depths:
        spec = input_specs(arch, cell, mesh, variant=variant,
                           n_layers=c * len(cfg.pattern), **kw)
        volume.reset_sent_bytes()
        _, flops = rf.count_flops(spec.fn, *spec.args)
        out.append((flops, _a2a_bytes_per_chip(chips)))
        volume.reset_sent_bytes()
    if len(out) == 1:
        return out[0]
    (f0, a0), (f1, a1) = out
    rest = cfg.n_cycles - c0
    return f0 + rest * (f1 - f0), a0 + rest * (a1 - a0)


def run_cell(arch: str, cell: str, *, multi_pod: bool, remat: str | None = None,
             microbatches: int = 1, save: bool = True,
             keep_hlo: bool = False, kv_layout: str = "auto",
             moe_dispatch: str | None = None, tag_extra: str = "",
             mesh=None, variant: str = "full", seq: int | None = None,
             batch: int | None = None, out_dir: str | None = None) -> dict:
    """One LM cell. ``mesh`` (default: the production mesh), ``variant``,
    ``seq`` and ``batch`` run the same path at a small size."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    spec = input_specs(arch, cell, mesh, remat=remat,
                       microbatches=microbatches, kv_layout=kv_layout,
                       moe_dispatch=moe_dispatch, variant=variant, seq=seq,
                       batch=batch)
    rec: dict = {"arch": arch, "cell": cell,
                 "mesh": [mesh.shape[a] for a in mesh.axis_names],
                 "multi_pod": multi_pod, "meta": spec.meta,
                 "remat": remat, "microbatches": microbatches,
                 "kv_layout": kv_layout, "moe_dispatch": moe_dispatch}
    try:
        chips = spec.meta["chips"]
        flops, a2a = counted_work(
            arch, cell, mesh, remat=remat, microbatches=microbatches,
            kv_layout=kv_layout, moe_dispatch=moe_dispatch, variant=variant,
            seq=seq, batch=batch)
        t_run = time.time() - t0
        coll = {k: None for k in GSPMD_COLLECTIVES}
        coll["all-to-all"] = a2a
        coll["total"] = a2a
        abytes = rf.analytic_memory_bytes(spec.meta)
        terms = rf.roofline_terms({}, coll, dot_flops=flops / chips,
                                  analytic_bytes=abytes)
        terms["raw_hlo_flops"] = terms["raw_hlo_bytes"] = None
        if not all(math.isfinite(terms[k]) for k in
                   ("t_compute", "t_memory", "t_collective")):
            raise ValueError(f"non-finite roofline terms {terms}")
        rec.update(
            ok=True,
            t_lower_s=round(t_run, 2), t_compile_s=None,
            memory_analysis=_mem_dict(spec.arg_bytes_per_device()),
            cost={"flops": flops / chips, "bytes accessed": None,
                  "optimal_seconds": None},
            collectives=coll, collectives_null_reason=GSPMD_NULL_REASON,
            roofline=terms, hlo_bytes=None,
        )
        if keep_hlo:
            rec["hlo_head"] = None
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug, record it
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    if save:
        tag = "pod2" if multi_pod else "pod1"
        extra = f"_{remat}" if remat else ""
        extra += f"_mb{microbatches}" if microbatches > 1 else ""
        extra += tag_extra
        _save(rec, f"{arch}__{cell}__{tag}{extra}.json", out_dir)
    return rec


def cp_step_shapes(prof, *, total: int, replication: int, rank: int = 32,
                   mode: int = 0, tile: int = 8, block_p: int = 128) -> dict:
    """The balanced-partition shapes of one distributed MTTKRP mode step
    (the reference's: nnz evenly split, CDF split ⇒ ±1 index), and one
    device's ``DeviceArrays`` and the replicated factors on ``meta``."""
    from repro_torch.core.mttkrp import DeviceArrays
    from repro_torch.kernels._build import item_words
    r = replication
    g = total // r
    n = len(prof.shape)
    nnz_dev = int(np.ceil(prof.nnz / total / block_p) * block_p)
    rows_max = int(np.ceil(prof.shape[mode] / g / tile) * tile)
    rows_max = int(np.ceil(rows_max / r) * r)
    padded = [int(np.ceil(s / g / tile) * tile * g) for s in prof.shape]
    padded[mode] = rows_max * g
    nb = nnz_dev // block_p

    def st(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    dev = DeviceArrays(
        indices=st((nnz_dev, n), torch.int32),
        values=st((nnz_dev,), torch.float32),
        local_rows=st((nnz_dev,), torch.int32),
        block_to_tile=st((nb,), torch.int32),
        seg_starts=st((nb, tile + 2), torch.int32),
        seg_rows=st((nb, tile + 1), torch.int32),
        items=st((item_words(nb),), torch.int32),
    )
    factors = [st((padded[w], rank), torch.float32) for w in range(n)]
    return {"nnz_dev": nnz_dev, "rows_max": rows_max, "padded": padded,
            "n_groups": g, "dev": dev, "factors": factors, "tile": tile,
            "block_p": block_p, "mode": mode, "rank": rank}


def ec_work(shapes: dict, variant: str) -> tuple[float, float]:
    """(f32 operations, bytes) of one device's EC: ``nnz·R·(nin+1)``
    operations; every input read once and the output written once, with
    each input factor's rows read at most once (at most one row per slot
    or the factor's rows, whichever is fewer: the data decides which rows
    a shard touches, and the dry-run has none). ``sorted`` reads the
    segment descriptors; the plain EC (``ref``) and ``blocked`` read the
    ``(nnz, R)`` rows gathered before the EC."""
    dev, rank, mode = shapes["dev"], shapes["rank"], shapes["mode"]
    nnz = shapes["nnz_dev"]
    nb = dev.block_to_tile.numel()
    n = dev.indices.shape[1]
    nin = n - 1
    flops = float(nnz * rank * (nin + 1))
    common = nnz * 4 + nb * 4 + (nb + 1) * 4 + shapes["rows_max"] * rank * 4
    distinct = sum(min(nnz, shapes["padded"][w]) for w in range(n)
                   if w != mode) * rank * 4
    if variant == "sorted":
        byts = (common + nnz * nin * 4 + dev.seg_starts.numel() * 4
                + dev.seg_rows.numel() * 4 + distinct)
    elif variant == "fused":
        byts = common + nnz * nin * 4 + nnz * 4 + distinct
    else:
        byts = common + nnz * 4 + nin * nnz * rank * 4
    return flops, float(byts)


def run_cp_cell(*, multi_pod: bool, profile: str = "amazon",
                replication: int = 1, use_kernel: bool = False,
                ring: bool = True, exchange_variant: str | None = None,
                wire_dtype: str = "float32", chunk_rows: int | None = None,
                save: bool = True, config=None,
                out_dir: str | None = None) -> dict:
    """Dry-run of the paper's own workload: one distributed MTTKRP mode step
    (EC + exchange) on the production chips at billion-scale shapes.

    ``config`` (a :class:`repro_torch.api.DecomposeConfig`) supersedes the
    scalar kwargs, as in the reference: replication, kernel and exchange
    settings are read off its sections (``replication=None`` there means
    auto, so the kwarg stands), and explicit exchange kwargs beat the
    config's exchange section."""
    from types import SimpleNamespace

    from repro_torch import comm
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse.io import DATASET_PROFILES

    if config is not None:
        if config.partition.replication is not None:
            replication = config.partition.replication
        spec = comm.resolve_exchange_spec(config.exchange)
        if exchange_variant is not None:
            spec = dataclasses.replace(spec, variant=exchange_variant)
        if chunk_rows is not None:
            spec = dataclasses.replace(spec, chunk_rows=chunk_rows)
        if wire_dtype != "float32":
            spec = dataclasses.replace(spec, wire_dtype=wire_dtype,
                                       merge="ring_rs")
        variant = config.kernel.resolved_variant()
        use_kernel = variant != "ref"
    else:
        spec = comm.ExchangeSpec(
            variant=comm.resolve_variant(exchange_variant, ring),
            merge="ring_rs" if wire_dtype != "float32" else
            comm.resolve_merge(None),
            chunk_rows=chunk_rows, wire_dtype=wire_dtype)
        variant = kops.resolve_variant(None, use_kernel)

    prof = DATASET_PROFILES[profile]
    total = 512 if multi_pod else 256
    r = replication
    mesh = make_cp_production_mesh(multi_pod=multi_pod, replication=r)
    xtag = spec.variant + ("" if spec.wire_dtype == "float32" else "_bf16w")
    rec = {"arch": f"cp_{profile}", "cell": f"mttkrp_r{r}_{xtag}",
           "mesh": [mesh.shape[a] for a in mesh.axis_names],
           "multi_pod": multi_pod,
           "exchange": {"variant": spec.variant, "merge": spec.merge,
                        "chunk_rows": spec.chunk_rows,
                        "wire_dtype": spec.wire_dtype},
           "ec_variant": variant}
    t0 = time.time()
    try:
        sh = cp_step_shapes(prof, total=total, replication=r)
        rec["meta"] = {"arch": f"cp_{profile}", "cell": f"mttkrp_r{r}",
                       "nnz": prof.nnz, "rank": sh["rank"],
                       "nnz_per_dev": sh["nnz_dev"],
                       "rows_max": sh["rows_max"]}
        part = SimpleNamespace(mode=sh["mode"], num_devices=total, r=r,
                               n_groups=sh["n_groups"],
                               rows_max=sh["rows_max"], tile=sh["tile"],
                               block_p=sh["block_p"], nnz_max=sh["nnz_dev"])
        ex = volume.mode_exchange_bytes(part, sh["rank"],
                                        wire_dtype=spec.wire_dtype)
        coll: dict[str, float] = {}
        for kind, key in (("gather", "gather_bytes"),
                          ("merge", "merge_bytes")):
            if ex[key]:
                name = volume.collective_kind(kind, spec)
                coll[name] = coll.get(name, 0.0) + float(ex[key])
        coll["total"] = float(ex["total_bytes"])
        flops, ec_bytes = ec_work(sh, variant)
        # each exchanged byte is read once and written once on the card
        byts = ec_bytes + 2.0 * ex["total_bytes"]
        arg_bytes = sh["dev"].nbytes() + sum(
            f.numel() * f.element_size() for f in sh["factors"])
        terms = rf.roofline_terms({}, coll, dot_flops=flops,
                                  analytic_bytes=byts)
        terms["raw_hlo_flops"] = terms["raw_hlo_bytes"] = None
        rec.update(ok=True, t_total_s=round(time.time() - t0, 2),
                   memory_analysis=_mem_dict(arg_bytes),
                   cost={"flops": flops, "bytes accessed": byts},
                   collectives=coll, roofline=terms)
    except Exception as e:  # noqa: BLE001
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    if save:
        tag = "pod2" if multi_pod else "pod1"
        kern = "_kern" if use_kernel else ""
        _save(rec, f"cp_{profile}__r{r}{kern}_{xtag}__{tag}.json", out_dir)
    return rec


def run_cp_exchange_ab(*, multi_pod: bool, profile: str = "amazon",
                       replication: int = 1, use_kernel: bool = False,
                       wire_dtype: str = "float32", save: bool = True,
                       out_dir: str | None = None) -> dict:
    """The same MTTKRP mode step under the blocking ring and the chunked
    ``overlap`` schedule (same wire dtype), side by side: per-device
    collective bytes and the roofline's exchange term per variant.
    ``collective_bytes`` is each variant's ``collectives["total"]`` (the
    reference sums every entry of its record, ``total`` included, so its
    file holds twice the bytes)."""
    cells = {}
    for variant in ("ring", "overlap"):
        cells[variant] = run_cp_cell(
            multi_pod=multi_pod, profile=profile, replication=replication,
            use_kernel=use_kernel, exchange_variant=variant,
            wire_dtype=wire_dtype, save=False)
    rec = {"arch": f"cp_{profile}", "cell": "exchange_ab",
           "multi_pod": multi_pod, "wire_dtype": wire_dtype,
           "variants": cells}
    ok = all(c.get("ok") for c in cells.values())
    rec["ok"] = ok
    if ok:
        rec["collective_bytes"] = {
            v: c["collectives"]["total"] for v, c in cells.items()}
        rec["t_collective"] = {
            v: c["roofline"]["t_collective"] for v, c in cells.items()}
        # chunking must not change how many bytes ride the wire — only when
        # they move relative to compute
        a, b = (rec["collective_bytes"][v] for v in ("ring", "overlap"))
        rec["same_volume"] = bool(a > 0 and abs(a - b) <= 0.05 * a)
    if save:
        tag = "pod2" if multi_pod else "pod1"
        wtag = "_bf16w" if wire_dtype != "float32" else ""
        _save(rec, f"cp_{profile}__exchange_ab{wtag}__{tag}.json", out_dir)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'cp' (paper workload)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--cp-profile", default="amazon")
    ap.add_argument("--cp-replication", type=int, default=1)
    ap.add_argument("--cp-kernel", action="store_true")
    ap.add_argument("--cp-preset", default=None,
                    help="repro_torch.api preset (paper|optimized|fused|"
                         "sorted) driving the CP cell's kernel/exchange/"
                         "replication settings")
    ap.add_argument("--cp-exchange", default=None,
                    choices=["allgather", "ring", "overlap"],
                    help="exchange gather variant for the CP cell")
    ap.add_argument("--cp-wire", default="float32",
                    choices=["float32", "bfloat16"],
                    help="exchange wire dtype for the CP cell")
    ap.add_argument("--cp-exchange-ab", action="store_true",
                    help="the CP cell under both the blocking ring and the "
                         "overlap schedule, side by side")
    ap.add_argument("--kv-layout", default="auto")
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--tag-extra", default="")
    ap.add_argument("--out-dir", default=None,
                    help="where records go (default experiments/dryrun_torch)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="LM cells run in this many processes at once")
    args = ap.parse_args(argv)

    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]
    failures = 0
    if args.arch == "cp":
        cfg = None
        if args.cp_preset:
            from repro_torch.api import preset
            cfg = preset(args.cp_preset)
        for mp in meshes:
            if args.cp_exchange_ab:
                rec = run_cp_exchange_ab(
                    multi_pod=mp, profile=args.cp_profile,
                    replication=args.cp_replication,
                    use_kernel=args.cp_kernel, wire_dtype=args.cp_wire,
                    out_dir=args.out_dir)
                _report_ab(rec)
            else:
                rec = run_cp_cell(multi_pod=mp, profile=args.cp_profile,
                                  replication=args.cp_replication,
                                  use_kernel=args.cp_kernel,
                                  exchange_variant=args.cp_exchange,
                                  wire_dtype=args.cp_wire, config=cfg,
                                  out_dir=args.out_dir)
                _report(rec)
            failures += 0 if rec["ok"] else 1
    else:
        archs = ARCH_IDS if args.arch == "all" else [args.arch]
        cells = list(SHAPE_CELLS) if args.shape == "all" else [args.shape]
        jobs = [(arch, cell, mp) for mp in meshes for arch in archs
                for cell in cells if supports_cell(arch, cell)]
        kw = dict(remat=args.remat, microbatches=args.microbatches,
                  kv_layout=args.kv_layout, moe_dispatch=args.moe_dispatch,
                  tag_extra=args.tag_extra, out_dir=args.out_dir)
        if args.jobs > 1:
            import concurrent.futures as cf
            import multiprocessing as mpc
            with cf.ProcessPoolExecutor(
                    args.jobs, mp_context=mpc.get_context("spawn")) as pool:
                futs = [pool.submit(_run_job, job, kw) for job in jobs]
                recs = (f.result() for f in futs)
                for rec in recs:
                    failures += 0 if rec["ok"] else 1
                    _report(rec)
        else:
            for job in jobs:
                rec = _run_job(job, kw)
                failures += 0 if rec["ok"] else 1
                _report(rec)
    if failures:
        raise SystemExit(f"{failures} cells failed")


def _run_job(job, kw) -> dict:
    arch, cell, mp = job
    return run_cell(arch, cell, multi_pod=mp, **kw)


def _report_ab(rec: dict):
    if not rec["ok"]:
        bad = {v: c.get("error") for v, c in rec["variants"].items()
               if not c.get("ok")}
        print(f"FAIL {rec['arch']:<22} exchange_ab    {bad}", flush=True)
        return
    cb, tc = rec["collective_bytes"], rec["t_collective"]
    print(f"OK   {rec['arch']:<22} exchange_ab    wire={rec['wire_dtype']:<9}"
          f"ring {cb['ring']/1e6:8.2f}MB/{tc['ring']*1e3:.2f}ms vs overlap "
          f"{cb['overlap']/1e6:8.2f}MB/{tc['overlap']*1e3:.2f}ms "
          f"same_volume={rec['same_volume']}", flush=True)


def _report(rec: dict):
    tag = "x".join(str(d) for d in rec["mesh"])
    if rec["ok"]:
        t = rec["roofline"]
        print(f"OK   {rec['arch']:<22} {rec['cell']:<14} mesh={tag:<9} "
              f"C={t['t_compute']*1e3:8.2f}ms M={t['t_memory']*1e3:8.2f}ms "
              f"X={t['t_collective']*1e3:8.2f}ms dom={t['bottleneck']}",
              flush=True)
    else:
        print(f"FAIL {rec['arch']:<22} {rec['cell']:<14} mesh={tag:<9} "
              f"{rec['error']}", flush=True)


if __name__ == "__main__":
    main()
