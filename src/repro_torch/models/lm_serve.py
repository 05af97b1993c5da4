"""LM serving functions: prefill_step / decode_step wrappers and
greedy/sampled generation, plus cache sharding specs (incl.
sequence-parallel long decode).

The port's copy of the reference package's ``models/lm_serve.py``. The
functions take the :class:`~repro_torch.models.transformer.Model`, which holds
its parameters, in place of the reference's ``(model, params)`` pair.
Sampling draws from a caller's ``torch.Generator`` with ``torch.multinomial``,
so sampled tokens do not reproduce ``jax.random``'s; greedy tokens follow
the logits alone.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.sharding import dp_axes, spec
from repro_torch.models.transformer import Model

__all__ = ["make_prefill_step", "make_decode_step", "cache_specs", "generate"]


def make_prefill_step(model: Model, cache_len: int):
    def prefill_step(tokens, extra=None):
        return model.prefill(tokens, cache_len, extra=extra)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(tokens, cache):
        return model.decode_step(tokens, cache)
    return decode_step


def cache_specs(model: Model, mesh, *, batch: int, seq_shard: bool = False,
                kv_layout: str = "auto") -> Any:
    """Partition specs (tuples, :func:`repro_torch.models.sharding.spec`)
    for the decode cache in the reference's layout: one dict per pattern
    position, each leaf ``(cyc, B, S, ...)``. ``mesh``: any object with
    ``axis_names`` and a ``shape`` mapping.

    ``kv_layout``:
      * "auto"  — KV heads over "model" when divisible, else the cache
        *sequence* dim over "model" (flash-decoding style).
      * "replicated_heads" — the naive baseline (heads or nothing).
    ``seq_shard=True``: shard S over the DP axes as well (long decode,
    where batch==1 leaves DP idle).
    """
    cfg = model.cfg
    dp = dp_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    tp_size = mesh.shape[tp] if tp else 1
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]

    batch_ax = dp if (batch % max(dp_size, 1) == 0 and batch > 1
                      and not seq_shard) else None

    specs = []
    for spec_l in cfg.pattern:
        c: dict[str, Any] = {}
        if spec_l.mixer == "attn":
            heads_ok = tp is not None and cfg.n_kv_heads % tp_size == 0
            head_ax = tp if heads_ok else None
            if seq_shard:
                seq_ax = dp
            elif not heads_ok and kv_layout == "auto":
                seq_ax = tp
            else:
                seq_ax = None
            kv = spec(None, batch_ax, seq_ax, head_ax, None)  # (cyc,B,S,KVH,hd)
            c["mixer"] = {"k": kv, "v": kv}
        elif spec_l.mixer == "mla":
            seq_ax = dp if seq_shard else (tp if kv_layout == "auto" else None)
            c["mixer"] = {"ckv": spec(None, batch_ax, seq_ax, None),
                          "kr": spec(None, batch_ax, seq_ax, None)}
        elif spec_l.mixer == "cross_attn":
            c["mixer"] = {}
        elif spec_l.mixer == "mamba":
            c["mixer"] = {"conv": spec(None, batch_ax, None, tp),
                          "h": spec(None, batch_ax, tp, None)}
        elif spec_l.mixer == "rwkv6":
            c["mixer"] = {"shift": spec(None, batch_ax, None),
                          "s": spec(None, batch_ax, tp, None, None)}
        if spec_l.ffn == "rwkv_cm":
            c["cm_shift"] = spec(None, batch_ax, None)
        specs.append(c)
    return {"layers": tuple(specs), "pos": spec()}


@torch.no_grad()
def generate(model: Model, prompt, *, steps: int, cache_len: int, extra=None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Greedy (or sampled) autoregressive generation — the end-to-end
    serving path. ``prompt`` (B,S) int64 on the model's device; returns the
    (B, steps) generated tokens. ``temperature > 0`` samples from
    ``softmax(logits / temperature)`` with ``generator``."""
    logits, cache = model.prefill(prompt, cache_len, extra=extra)
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for _ in range(steps):
        out.append(tok)
        logits, cache = model.decode_step(tok, cache)
        if temperature > 0.0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits[:, -1:], dim=-1)
    return torch.cat(out, dim=1)
