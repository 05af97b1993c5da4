"""Shared model primitives: norms, rotary embeddings, init helpers.

The port's copy of the reference package's ``models/common.py``. Norm
statistics, rotary angles and soft-capping run in float32 as there, and the
result is cast back to the input's dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "layer_norm", "rope", "rope_at", "dense_init",
           "softcap"]


def dense_init(shape, *, generator: torch.Generator | None,
               scale: float | None = None, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) truncated to [-2, 2], times
    ``scale`` (default ``1/sqrt(fan_in)``), drawn in float32 and cast.

    The reference's distribution with ``torch``'s generator, so not its
    bits (``models.convert`` carries the reference's weights across). On
    the meta device nothing is drawn."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out * s).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6, *, offset: float = 1.0):
    """RMSNorm with gemma-style (1+scale) option (offset=1) or llama style
    (offset=0 → plain scale)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (offset + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def softcap(x, cap: float | None):
    """tanh logit soft-capping (gemma2)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def _rope_freqs(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_at(x, positions, theta: float = 10000.0):
    """Rotary embedding at explicit positions.

    x: (..., S, H, hd); positions: broadcastable to (..., S).
    Rotates the first even half-pairs (GPT-NeoX convention: split halves).
    """
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)             # (hd/2,)
    ang = positions[..., :, None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, theta: float = 10000.0, offset: int = 0):
    """Rotary embedding for positions offset..offset+S-1. x: (B,S,H,hd)."""
    s = x.shape[-3]
    pos = torch.arange(s, device=x.device) + offset
    return rope_at(x, pos[None, :], theta)
