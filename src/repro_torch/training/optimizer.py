"""AdamW with distributed-training sharding (ZeRO-1).

The port's copy of the reference package's ``training/optimizer.py``. The
optimizer is a transform of flat parameter dicts (``name -> tensor``, as
``dict(model.named_parameters())`` gives), with no optimizer library.
Everything a step computes stays on the parameters' device: ``step`` is an
int32 tensor, and the learning rate, the bias corrections, the gradient
norm and the clip scale are tensors, so a step makes no host sync.

:func:`adamw_update` updates the parameters and the moments in place (the
card holds one copy of the model and its moments, not two) and returns
them, as the reference returns its new trees. Each parameter is updated in
float32 and cast back to its dtype; weight decay applies to every leaf.

``zero1_specs`` derives the optimizer-state partition specs from the
parameter specs: each moment inherits the parameter's spec *plus* sharding
of its first still-unsharded divisible dim over the DP axes. Specs are
tuples normalised as ``PartitionSpec`` normalises them
(:func:`repro_torch.models.sharding.spec`), and the multi-device slice
consumes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models.sharding import dp_axes, spec

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "zero1_specs",
           "cosine_schedule", "global_norm_clip"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac·lr``, in float32
    on ``step``'s device (a Python int becomes a host tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params: dict) -> dict:
    """Zero float32 moments for every parameter, and ``step`` 0 (int32) on
    the first parameter's device."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"mu": zeros, "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in
    insertion order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _clip_scale(gn, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)


def global_norm_clip(grads: dict, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))``.
    Returns (clipped grads, norm). The clipped grads are float32: the
    reference multiplies by a float32 array, which promotes bf16."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt: dict):
    """One AdamW step. Updates ``params`` and ``opt["mu"]``/``opt["nu"]`` in
    place and returns ``(params, {"mu", "nu", "step"}, {"lr",
    "grad_norm"})``, every value a tensor on the parameters' device."""
    step = opt["step"] + 1
    lr = cosine_schedule(cfg, step)
    if cfg.grad_clip:
        # global_norm_clip, one leaf at a time (no second set of grads)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=step.device)
        scale = None
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step
    c2 = 1 - b2 ** step
    for n, p in params.items():
        g32 = grads[n].float()
        if scale is not None:
            g32 = g32 * scale
        m, v = opt["mu"][n], opt["nu"][n]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        p32 = p.float()
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, {"mu": opt["mu"], "nu": opt["nu"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


def _map_specs(fn, specs, shapes):
    """``fn(spec, shape)`` over a nested dict/list of spec tuples (a tuple is
    a leaf) and the matching tree of objects with ``.shape``."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, shapes[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, s) for v, s in zip(specs, shapes)]
    return fn(specs, shapes)


def zero1_specs(param_specs: Any, params_shape: Any, mesh) -> dict:
    """Optimizer-state specs: param spec + DP sharding of the first
    divisible unsharded dim (ZeRO-1 moment partitioning). ``mesh`` is any
    object with ``axis_names`` and a ``shape`` mapping."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1

    def one(sp: tuple, shape) -> tuple:
        dims = tuple(shape.shape)
        if dp_size <= 1 or not dims:
            return sp
        entries = list(sp) + [None] * (len(dims) - len(sp))
        for i, (e, dim) in enumerate(zip(entries, dims)):
            if e is None and dim % dp_size == 0 and dim > 0:
                entries[i] = dp if len(dp) > 1 else dp[0]
                return spec(*entries)
        return sp

    moment = _map_specs(one, param_specs, params_shape)
    return {"mu": moment, "nu": moment, "step": spec()}
