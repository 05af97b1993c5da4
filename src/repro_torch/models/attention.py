"""Attention variants: GQA (optionally sliding-window / soft-capped), MLA,
cross-attention; chunked (flash-style) prefill and single-token decode.

The port's copy of the reference package's ``models/attention.py``, in plain
PyTorch with the same arithmetic per block: float32 scores, ``NEG_INF``
masking (not ``-inf``), the online-softmax merge in the reference's order,
and ``maximum(l, 1e-37)`` before the division. Prefill never materialises
an S×S score matrix. What differs is only how the blocks are issued: the
reference's ``lax.map``/``lax.scan`` loops compile into one program, while
eager PyTorch would pay a Python step per block. So the port stacks the
query chunks of one step (all chunks of a sliding-window layer, or every
query chunk that meets key chunk ``j`` of a global layer) into one batched
product, up to :data:`SCORE_ELEMS` float32 elements of scores (or of key
and value copies) per product. Each query chunk still merges its key
chunks in the order ``j = 0, 1, ...``.

Shapes: q (B,S,H,hd), k/v (B,S,KVH,hd) with H % KVH == 0 (GQA).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import shardctx
from repro_torch.models.common import softcap

__all__ = ["attention_prefill", "attention_decode", "mla_prefill",
           "mla_decode_absorbed", "cross_attention"]

NEG_INF = -2.0 ** 30
# float32 elements that one stacked product's scores, or its copies of the
# keys and values, may hold: 512 MB
SCORE_ELEMS = 1 << 27


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, kvh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kvh, n_rep, hd).reshape(
        b, s, kvh * n_rep, hd)


def _chunk_attend(qc, k, v, mask, scale, cap):
    """N stacked (q-chunk × kv-span) attentions with explicit masks.

    qc: (B,N,C,H,hd); k,v: (B,N,T,H,hd); mask: (N,C,T) bool (True=keep).
    Returns (out (B,N,C,H,hdv), m (B,N,H,C), l (B,N,H,C)) — unnormalised
    (flash accumulator convention). Each of the N blocks is the reference's
    ``_chunk_attend`` of one block."""
    s = torch.einsum("bnchd,bnthd->bnhct", qc.float(), k.float()) * scale
    s = softcap(s, cap)
    mask = mask[None, :, None]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)                                 # (B,N,H,C)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    out = torch.einsum("bnhct,bnthd->bnchd", p, v.float())
    return out, m, l


def _groups(n: int, per_block: int):
    """Split ``range(n)`` into runs of blocks whose stacked scores and
    key/value copies stay within :data:`SCORE_ELEMS` (``per_block``: the
    larger of the two for one block)."""
    g = max(1, SCORE_ELEMS // max(per_block, 1))
    return [(i, min(i + g, n)) for i in range(0, n, g)]


def _chunks(x, c: int, i0: int, i1: int):
    """Chunks ``i0 .. i1-1`` of length ``c`` along dim 1: (B,N,c,...)."""
    b = x.shape[0]
    return x[:, i0 * c:i1 * c].reshape(b, i1 - i0, c, *x.shape[2:])


def attention_prefill(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      cap: float | None = None, chunk: int = 512,
                      block_skip: bool = True):
    """Chunked attention over full sequences (train / prefill).

    window: sliding-window span (local attention; causal implied).
    block_skip: skip fully-masked KV blocks (exact — skipped blocks are
    provably all-masked): query chunk ``i`` meets key chunks ``0..i`` only.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    hdv = v.shape[3]          # may differ from hd (MLA: nope+rope vs v dim)
    n_rep = h // kvh
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    c = min(chunk, s)
    if s % c:
        c = math.gcd(s, c)
    nq = s // c
    dev = q.device

    if window is not None:
        # local attention: q chunk i sees kv [i*c - (window-1), i*c + c)
        span = window - 1 + c
        pad = window - 1
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        # (B, nq, span, H, hd) views: chunk i's span starts at i*c of kp
        kw = kp.unfold(1, span, c).permute(0, 1, 4, 2, 3)
        vw = vp.unfold(1, span, c).permute(0, 1, 4, 2, 3)
        qpos = torch.arange(c, device=dev)
        kpos = torch.arange(span, device=dev) - pad
        base_mask = (kpos[None, :] <= qpos[:, None]) & \
                    (kpos[None, :] > qpos[:, None] - window)    # (c, span)
        outs = []
        per_block = b * h * span * max(c, hd + hdv)
        for i0, i1 in _groups(nq, per_block):
            ii = torch.arange(i0, i1, device=dev)
            # positions before 0 are padding → masked
            valid = (kpos[None, None, :] + ii[:, None, None] * c) >= 0
            out, m, l = _chunk_attend(_chunks(q, c, i0, i1), kw[:, i0:i1],
                                      vw[:, i0:i1], base_mask[None] & valid,
                                      scale, cap)
            outs.append(out / torch.clamp_min(l, 1e-37).transpose(2, 3)
                        [..., None])
        return torch.cat(outs, dim=1).reshape(b, s, h, hdv).to(q.dtype)

    # global attention: acc/m/l per query chunk, merged over key chunks j
    qpos = torch.arange(c, device=dev)
    kpos = torch.arange(c, device=dev)
    acc = torch.zeros((b, nq, c, h, hdv), dtype=torch.float32, device=dev)
    m = torch.full((b, nq, h, c), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nq, h, c), dtype=torch.float32, device=dev)
    for j in range(nq):
        kc = _chunks(k, c, j, j + 1)
        vc = _chunks(v, c, j, j + 1)
        # block_skip: only lower-triangular (i >= j) blocks are computed
        first = j if causal and block_skip else 0
        per_block = b * h * c * max(c, hd + hdv)
        parts = []
        for i0, i1 in _groups(nq - first, per_block):
            i0, i1 = i0 + first, i1 + first
            n = i1 - i0
            if causal:
                ii = torch.arange(i0, i1, device=dev)
                mask = (qpos[None, :, None] + ii[:, None, None] * c) >= \
                    (kpos[None, None, :] + j * c)
            else:
                mask = torch.ones((n, c, c), dtype=torch.bool, device=dev)
            o, m2, l2 = _chunk_attend(
                _chunks(q, c, i0, i1), kc.expand(b, n, *kc.shape[2:]),
                vc.expand(b, n, *vc.shape[2:]), mask, scale, cap)
            a_i, m_i, l_i = acc[:, i0:i1], m[:, i0:i1], l[:, i0:i1]
            m_new = torch.maximum(m_i, m2)
            alpha = torch.exp(m_i - m_new)
            beta = torch.exp(m2 - m_new)
            parts.append((a_i * alpha.transpose(2, 3)[..., None]
                          + o * beta.transpose(2, 3)[..., None],
                          l_i * alpha + l2 * beta, m_new))
        # the merged chunks replace chunks first..nq-1 out of place, so
        # autograd keeps the accumulators each step read
        acc, l, m = (torch.cat([old[:, :first], *new], dim=1)
                     for old, new in zip((acc, l, m), zip(*parts)))
    outs = acc / torch.clamp_min(l, 1e-37).transpose(2, 3)[..., None]
    return outs.reshape(b, s, h, hdv).to(q.dtype)


def cross_attention(q, k, v, *, cap=None, chunk: int = 512):
    """Non-causal attention against a fixed memory (encoder / image tokens)."""
    return _full_softmax(q, k, v, cap)


def _full_softmax(q, k, v, cap):
    h, kvh = q.shape[2], k.shape[2]
    k, v = _repeat_kv(k, h // kvh), _repeat_kv(v, h // kvh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    s = softcap(s, cap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_decode(q, k_cache, v_cache, cur_len: int, *,
                     window: int | None = None, cap: float | None = None):
    """Single-token decode: q (B,1,H,hd); caches (B,S_max,KVH,hd).

    cur_len: number of valid cache positions INCLUDING the newly written
    token (a Python int: the port keeps the decode position on the host).
    """
    b, smax, kvh, hd = k_cache.shape
    h = q.shape[2]
    q = shardctx.constrain(q, "decode_q")
    k = _repeat_kv(k_cache, h // kvh)
    v = _repeat_kv(v_cache, h // kvh)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    s = shardctx.constrain(s, "decode_scores")
    s = softcap(s, cap)
    pos = torch.arange(smax, device=q.device)
    mask = pos < cur_len
    if window is not None:
        mask = mask & (pos >= cur_len - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p, v.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV with decoupled RoPE dims.
# ---------------------------------------------------------------------------

def mla_prefill(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, *, causal=True,
                chunk: int = 512):
    """Naive (expanded) MLA for train/prefill.

    q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,kv_lora),
    k_rope (B,S,1,dr) shared across heads; w_uk (kv_lora,H,dn),
    w_uv (kv_lora,H,dv)."""
    k_nope = torch.einsum("bsl,lhd->bshd", c_kv, w_uk)
    v = torch.einsum("bsl,lhd->bshd", c_kv, w_uv)
    h = q_nope.shape[2]
    k_rope_h = k_rope.expand(*k_rope.shape[:2], h, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    return attention_prefill(q, k, v, causal=causal, chunk=chunk)


def mla_decode_absorbed(q_nope, q_rope, ckv_cache, krope_cache, cur_len: int,
                        w_uk, w_uv):
    """Absorbed-matmul MLA decode: scores in compressed space — the cache
    stays (S, kv_lora + dr) per token and is never expanded.

    q_nope (B,1,H,dn), q_rope (B,1,H,dr); ckv_cache (B,S,kv_lora);
    krope_cache (B,S,dr)."""
    b, smax, lora = ckv_cache.shape
    dn = q_nope.shape[-1]
    q_nope = shardctx.constrain(q_nope, "decode_q")
    q_rope = shardctx.constrain(q_rope, "decode_q")
    scale = 1.0 / math.sqrt(dn + q_rope.shape[-1])
    # absorb w_uk into q: q' = q_nope @ w_uk^T per head → compressed space
    q_c = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk.float())
    s = torch.einsum("bqhl,bsl->bhqs", q_c, ckv_cache.float())
    s = s + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), krope_cache.float())
    s = s * scale
    s = shardctx.constrain(s, "decode_scores")
    mask = torch.arange(smax, device=q_nope.device) < cur_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhqs,bsl->bqhl", p, ckv_cache.float())
    o = torch.einsum("bqhl,lhd->bqhd", o_c, w_uv.float())
    return o.to(q_nope.dtype)
