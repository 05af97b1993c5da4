"""Three-term roofline of a dry-run cell on the H100 (no launch).

The port's counterpart of the reference package's ``launch/roofline.py``:

    compute    = FLOPs_per_chip / peak_FLOPs
    memory     = bytes_per_chip / HBM_bw
    collective = coll_bytes_per_chip / link_bw

:class:`HW` holds one NVIDIA H100 SXM's numbers, from NVIDIA's H100
datasheet (SXM column): 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, and 450 GB/s of NVLink each way per card (900 GB/s
both ways).

Where each term comes from:

* **FLOPs** — counted, not parsed: the dry-run runs the cell's function
  on tensors of the ``meta`` device under
  ``torch.utils.flop_counter.FlopCounterMode`` (:func:`count_flops`),
  which counts the matrix products (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions and attention kernels) as ``2·M·N·K``; a
  training cell's backward and its remat recompute run under the same
  counter. That is the reference's loop-weighted ``dot``/``convolution``
  count; each Python loop iteration here is one of the reference's loop
  trips. The count is of the whole cell, divided evenly over the chips.
* **memory bytes** — the reference's analytic model,
  :func:`analytic_memory_bytes`, unchanged.
* **collective bytes** — counted where the port sends them
  (``comm.volume.count_sent``): the CP cell's exchange from the exchange
  model, and an LM cell's MoE all-to-all where the cell runs
  ``moe_dispatch="a2a"``. The collectives GSPMD would insert around a
  sharded LM layer have no counterpart in a one-controller port; the
  dry-run reports them as ``null``, with its reason.

No counterpart by design: ``parse_hlo``, ``collective_bytes`` and
``_dot_flops``, which read XLA's HLO text; the port makes no HLO.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["HW", "roofline_terms", "analytic_memory_bytes", "format_row",
           "count_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12      # bf16 per card, dense, tensor cores
    hbm_bw: float = 3.35e12         # bytes/s, HBM3
    link_bw: float = 450e9          # bytes/s per card each way, NVLink


def count_flops(fn, *args, **kwargs) -> tuple[Any, float]:
    """``(fn(*args, **kwargs), matrix-product FLOPs it ran)``, counted by
    ``FlopCounterMode`` (works on ``meta`` tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return out, float(fc.get_total_flops())


def analytic_memory_bytes(meta: dict) -> float:
    """Per-chip HBM traffic model for one step (the reference's).

    train:   params (read fwd + read bwd + write) ×2B + grads rw ×2B +
             adam m,v rw f32 (16B/param) + activations (residual stream,
             ~12 floats/token/layer without remat, ~4 with)
    prefill: params read + activations write/read (~6/token/layer) + KV write
    decode:  params read + full KV cache read
    All divided by chip count (tensors are sharded).
    """
    chips = meta.get("chips", 1)
    p = meta.get("params", 0)
    dt = 2.0  # bf16
    kind = meta.get("kind")
    seq, batch = meta.get("seq", 0), meta.get("batch", 0)
    d = meta.get("d_model", 0)
    layers = meta.get("n_layers", 1)
    kv_bytes = meta.get("kv_bytes", 0.0)
    act_scale = 4.0 if meta.get("remat") else 12.0
    if kind == "train":
        par = p * (3 * dt + 2 * dt + 16.0)
        act = act_scale * batch * seq * d * layers * dt
        return (par + act) / chips
    if kind == "prefill":
        par = p * dt
        act = 6.0 * batch * seq * d * layers * dt
        return (par + act + kv_bytes) / chips
    # decode
    return (p * dt + kv_bytes) / chips


def roofline_terms(cost: dict[str, Any], coll: dict[str, float],
                   hw: HW = HW(), *, dot_flops: float | None = None,
                   analytic_bytes: float | None = None) -> dict[str, float]:
    """The three terms, the bottleneck and the roofline fraction (the
    reference's function). ``cost`` may carry ``flops`` and
    ``bytes accessed``; ``dot_flops`` and ``analytic_bytes`` take their
    place when given."""
    raw_flops = float(cost.get("flops", 0.0) or 0.0)
    raw_bytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    flops = dot_flops if dot_flops else raw_flops
    byts = analytic_bytes if analytic_bytes else raw_bytes
    cb = float(coll.get("total", 0.0) or 0.0)
    terms = {
        "flops_per_chip": flops,
        "raw_hlo_flops": raw_flops,
        "bytes_per_chip": byts,
        "raw_hlo_bytes": raw_bytes,
        "coll_bytes_per_chip": cb,
        "t_compute": flops / hw.peak_flops,
        "t_memory": byts / hw.hbm_bw,
        "t_collective": cb / hw.link_bw,
    }
    dom = max(("t_compute", "t_memory", "t_collective"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom
    t_max = terms[dom]
    terms["step_time_bound"] = t_max
    terms["roofline_fraction"] = (terms["t_compute"] / t_max) if t_max > 0 else 0.0
    return terms


def format_row(meta: dict, terms: dict) -> str:
    return (f"{meta['arch']:<22} {meta['cell']:<12} "
            f"C={terms['t_compute']*1e3:9.3f}ms "
            f"M={terms['t_memory']*1e3:9.3f}ms "
            f"X={terms['t_collective']*1e3:9.3f}ms "
            f"dom={terms['bottleneck'][2:]:<10} "
            f"frac={terms['roofline_fraction']:.3f}")
