"""Composable decoder-LM / encoder-decoder definition.

The port's copy of the reference package's ``models/transformer.py``. A
model is a cyclic ``pattern`` of :class:`LayerSpec` blocks tiled to
``n_layers``. The reference stacks each pattern position's parameters
across cycles and runs one ``lax.scan``; the port holds one parameter tree
per layer, ``layers[c * len(pattern) + pi]`` for cycle ``c`` and pattern
position ``pi``, and loops over them in Python. ``models.convert`` maps
between the two layouts.

Mixers: GQA attention (sliding window / softcap options), MLA (DeepSeek),
Mamba, RWKV6, cross-attention (VLM); FFNs: dense (swiglu / squared-relu /
gelu), MoE (+shared experts), RWKV channel-mix. See attention.py / ffn.py /
ssm.py for the math; this file wires blocks, params and caches.

The decode cache is ``{"layers": [per-layer dict], "pos": int, "xkv": ...}``.
Each layer's dict has the reference's keys (``mixer`` with ``k``/``v``,
``ckv``/``kr``, ``conv``/``h`` or ``shift``/``s``, and ``cm_shift``) without
the cycle dimension, and ``pos`` is a Python int, so a decode step never
reads the position back from the card. Attention caches are written in
place at ``pos``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import shardctx
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (dense_init, layer_norm, rms_norm,
                                       rope_at, softcap)

__all__ = ["LayerSpec", "EncoderConfig", "ModelConfig", "Model", "Params"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"            # attn | mla | mamba | rwkv6 | cross_attn | none
    causal: bool = True
    window: int | None = None      # sliding-window width (local attention)
    attn_softcap: float | None = None
    cross: bool = False            # extra cross-attn sub-block (whisper dec)
    ffn: str = "dense"             # dense | moe | rwkv_cm | none


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_heads: int
    d_ff: int
    mlp_kind: str = "gelu"
    input_dim: int | None = None   # stub frontend embedding dim (defaults d)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    mlp_kind: str = "swiglu"
    # MoE
    n_experts: int = 0
    topk: int = 2
    moe_d_ff: int | None = None
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "sort"
    # MLA
    kv_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # RWKV
    rwkv_head_dim: int = 64
    # misc
    rope_theta: float = 10000.0
    final_softcap: float | None = None
    emb_scale: bool = False
    post_norm: bool = False        # gemma2 sandwich norm
    norm_offset: float = 0.0       # 1.0 → gemma (1+scale) RMSNorm
    norm_kind: str = "rms"         # rms | ln
    use_bias: bool = False
    use_abs_pos: bool = False      # learned absolute positions (whisper)
    max_pos: int = 0
    norm_eps: float = 1e-6
    dtype: str = "float32"
    encoder: EncoderConfig | None = None
    # runtime knobs
    attn_chunk: int = 512
    rwkv_chunk: int = 64
    remat: str = "none"            # none | full | dots (under autograd only)

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layers(self) -> tuple[LayerSpec, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def n_cycles(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} % "
                             f"pattern {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Params(nn.Module):
    """A nested parameter tree as modules: dict entries become child
    :class:`Params`, lists become ``nn.ModuleList``\\ s, tensors become
    parameters. They are built with ``requires_grad=False``, since serving
    computes no gradients; training turns them on explicitly with
    ``nn.Module.requires_grad_(True)`` (what
    ``training.train_step.make_train_step`` does). Indexed like the
    reference's dict pytree: ``p["wq"]``, ``"w3" in p``."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(Params(x) for x in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def keys(self):
        return [*self._parameters, *self._modules]


# ===========================================================================
# Parameter construction
# ===========================================================================

class _Init:
    """Draws one config's parameters on one device from one generator."""

    def __init__(self, cfg: ModelConfig, device, generator):
        self.cfg, self.device, self.g = cfg, torch.device(device), generator
        self.dt = cfg.torch_dtype

    def dense(self, shape, scale=None, dtype=None):
        return dense_init(shape, generator=self.g, scale=scale,
                          dtype=dtype or self.dt, device=self.device)

    def uniform(self, shape):
        """U[0, 1) in float32 (the reference's ``jax.random.uniform``)."""
        if self.device.type == "meta":
            return torch.empty(shape, device=self.device)
        return torch.rand(shape, generator=self.g, device=self.device)

    def full(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=dtype or self.dt,
                          device=self.device)

    def norm_param(self, d: int) -> dict:
        """The reference's ``_norm_param``."""
        if self.cfg.norm_kind == "ln":
            return {"w": self.full((d,), 1.0), "b": self.full((d,), 0.0)}
        return {"w": self.full((d,), 0.0 if self.cfg.norm_offset else 1.0)}


def _init_mixer(ini: _Init, cfg: ModelConfig, spec: LayerSpec) -> dict:
    d, hd = cfg.d_model, cfg.hd
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    dt, dev = ini.dt, ini.device
    p: dict[str, Any] = {"norm1": ini.norm_param(d)}
    if spec.mixer == "attn" or spec.mixer == "cross_attn":
        p.update(wq=ini.dense((d, h * hd)), wk=ini.dense((d, kvh * hd)),
                 wv=ini.dense((d, kvh * hd)), wo=ini.dense((h * hd, d)))
        if cfg.use_bias:
            p.update(bq=ini.full((h * hd,), 0.0), bk=ini.full((kvh * hd,), 0.0),
                     bv=ini.full((kvh * hd,), 0.0), bo=ini.full((d,), 0.0))
    elif spec.mixer == "mla":
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        lora = cfg.kv_lora
        p.update(wq=ini.dense((d, h * (dn + dr))),
                 w_dkv=ini.dense((d, lora + dr)),
                 kv_norm=ini.norm_param(lora),
                 w_uk=ini.dense((lora, h, dn)),
                 w_uv=ini.dense((lora, h, dv)),
                 wo=ini.dense((h * dv, d)))
    elif spec.mixer == "mamba":
        d_in = cfg.mamba_expand * d
        n = cfg.mamba_d_state
        dtr = max(1, math.ceil(d / 16))
        dt_init = torch.log(torch.expm1(torch.clamp(
            ini.uniform((d_in,)) * 0.099 + 0.001, min=1e-4))).to(dt)
        p.update(
            in_proj=ini.dense((d, 2 * d_in)),
            conv_w=ini.dense((cfg.mamba_d_conv, d_in)),
            conv_b=ini.full((d_in,), 0.0),
            x_proj=ini.dense((d_in, dtr + 2 * n)),
            dt_proj=ini.dense((dtr, d_in)),
            dt_bias=dt_init,
            A_log=torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=dev)).expand(d_in, n).to(dt).contiguous(),
            D=ini.full((d_in,), 1.0),
            out_proj=ini.dense((d_in, d)),
        )
    elif spec.mixer == "rwkv6":
        hd_r = cfg.rwkv_head_dim
        h_r = d // hd_r
        p.update(
            wr=ini.dense((d, d)), wk=ini.dense((d, d)), wv=ini.dense((d, d)),
            wg=ini.dense((d, d)), ww=ini.dense((d, d), scale=0.01),
            w_base=ini.full((d,), 2.0),
            u=(ini.uniform((h_r, hd_r)) - 0.5).to(dt),
            ln_w=ini.full((h_r, hd_r), 1.0),
            ln_b=ini.full((h_r, hd_r), 0.0),
            wo=ini.dense((d, d)),
            **{f"mu_{n}": (ini.uniform((d,)) * 0.5).to(dt)
               for n in ("r", "k", "v", "g", "w")},
        )
    elif spec.mixer != "none":
        raise ValueError(spec.mixer)
    if cfg.post_norm and spec.mixer != "none":
        p["pn1"] = ini.norm_param(d)
    return p


def _init_cross(ini: _Init, cfg: ModelConfig) -> dict:
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    kvh = cfg.n_kv_heads
    return dict(normx=ini.norm_param(d), xwq=ini.dense((d, h * hd)),
                xwk=ini.dense((d, kvh * hd)), xwv=ini.dense((d, kvh * hd)),
                xwo=ini.dense((h * hd, d)))


def _init_ffn(ini: _Init, cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    glu = cfg.mlp_kind in ("swiglu", "geglu")
    p: dict[str, Any] = {"norm2": ini.norm_param(d)}
    if spec.ffn == "dense":
        f = cfg.d_ff
        p.update(w1=ini.dense((d, f)), w2=ini.dense((f, d)))
        if glu:
            p["w3"] = ini.dense((d, f))
    elif spec.ffn == "moe":
        e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        p.update(router=ini.dense((d, e), dtype=torch.float32),
                 w1=ini.dense((e, d, f)), w2=ini.dense((e, f, d)))
        if glu:
            p["w3"] = ini.dense((e, d, f))
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p.update(s1=ini.dense((d, fs)), s2=ini.dense((fs, d)))
            if glu:
                p["s3"] = ini.dense((d, fs))
    elif spec.ffn == "rwkv_cm":
        f = cfg.d_ff
        p.update(mu_ck=(ini.uniform((d,)) * 0.5).to(ini.dt),
                 mu_cr=(ini.uniform((d,)) * 0.5).to(ini.dt),
                 ck=ini.dense((d, f)), cr=ini.dense((d, d)),
                 cv=ini.dense((f, d)))
    elif spec.ffn != "none":
        raise ValueError(spec.ffn)
    if cfg.post_norm and spec.ffn != "none":
        p["pn2"] = ini.norm_param(d)
    return p


def _encoder_cfg(cfg: ModelConfig, **kw) -> ModelConfig:
    enc = cfg.encoder
    return dataclasses.replace(
        cfg, n_heads=enc.n_heads, n_kv_heads=enc.n_heads, d_ff=enc.d_ff,
        mlp_kind=enc.mlp_kind, post_norm=False, **kw)


_ENC_SPEC = LayerSpec(mixer="attn", causal=False, ffn="dense")


def _init_encoder(cfg: ModelConfig, device, generator) -> dict:
    ecfg = _encoder_cfg(cfg)
    eini = _Init(ecfg, device, generator)
    return {"layers": [{"mixer": _init_mixer(eini, ecfg, _ENC_SPEC),
                        "ffn": _init_ffn(eini, ecfg, _ENC_SPEC)}
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": eini.norm_param(cfg.d_model)}


def init_params(cfg: ModelConfig, device, generator) -> dict:
    """The parameter tree of ``cfg`` in the port's per-layer layout (the
    reference's ``Model.init``)."""
    ini = _Init(cfg, device, generator)
    layers = []
    for spec in cfg.layers:
        lp = {"mixer": _init_mixer(ini, cfg, spec),
              "ffn": _init_ffn(ini, cfg, spec)}
        if spec.cross:
            lp["cross"] = _init_cross(ini, cfg)
        layers.append(lp)
    tree = {"embed": ini.dense((cfg.vocab, cfg.d_model), scale=1.0),
            "final_norm": ini.norm_param(cfg.d_model), "layers": layers}
    if cfg.use_abs_pos:
        tree["pos_emb"] = ini.dense((cfg.max_pos, cfg.d_model), scale=0.02)
    if cfg.encoder is not None:
        tree["encoder"] = _init_encoder(cfg, device, generator)
    return tree


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_kind == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, offset=cfg.norm_offset)


# ===========================================================================
# Sub-blocks (plain functions of the config, a layer's params and tensors)
# ===========================================================================

def _qkv(cfg: ModelConfig, p, x):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
    if cfg.use_bias:
        q = q + p["bq"].reshape(1, 1, h, hd)
        k = k + p["bk"].reshape(1, 1, kvh, hd)
        v = v + p["bv"].reshape(1, 1, kvh, hd)
    return q, k, v


def _out(cfg: ModelConfig, p, o):
    b, s = o.shape[:2]
    o = o.reshape(b, s, -1) @ p["wo"]
    if cfg.use_bias:
        o = o + p["bo"]
    return o


def _attn_full(cfg: ModelConfig, spec: LayerSpec, p, x, pos0: int = 0):
    q, k, v = _qkv(cfg, p, x)
    if not cfg.use_abs_pos:
        pos = (torch.arange(x.shape[1], device=x.device) + pos0)[None]
        q = rope_at(q, pos, cfg.rope_theta)
        k = rope_at(k, pos, cfg.rope_theta)
    o = attn_mod.attention_prefill(
        q, k, v, causal=spec.causal, window=spec.window,
        cap=spec.attn_softcap, chunk=cfg.attn_chunk)
    return _out(cfg, p, o), {"k": k, "v": v}


def _step_pos(x, pos: int):
    return torch.full((1, 1), pos, dtype=torch.int64, device=x.device)


def _attn_step(cfg: ModelConfig, spec: LayerSpec, p, x, cache, pos: int):
    q, k, v = _qkv(cfg, p, x)                         # s == 1
    if not cfg.use_abs_pos:
        posv = _step_pos(x, pos)
        q = rope_at(q, posv, cfg.rope_theta)
        k = rope_at(k, posv, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    kc[:, pos:pos + 1] = k.to(kc.dtype)
    vc[:, pos:pos + 1] = v.to(vc.dtype)
    o = attn_mod.attention_decode(q, kc, vc, pos + 1, window=spec.window,
                                  cap=spec.attn_softcap)
    return _out(cfg, p, o), {"k": kc, "v": vc}


def _mla_qkv(cfg: ModelConfig, p, x, pos):
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv_full = x @ p["w_dkv"]
    c_kv = _apply_norm(cfg, p["kv_norm"], ckv_full[..., :cfg.kv_lora])
    k_rope = ckv_full[..., cfg.kv_lora:][:, :, None, :]
    q_rope = rope_at(q_rope, pos, cfg.rope_theta)
    k_rope = rope_at(k_rope, pos, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_full(cfg: ModelConfig, p, x):
    pos = torch.arange(x.shape[1], device=x.device)[None]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, pos)
    o = attn_mod.mla_prefill(q_nope, q_rope, c_kv, k_rope,
                             p["w_uk"], p["w_uv"], chunk=cfg.attn_chunk)
    return _out(cfg, p, o), {"ckv": c_kv, "kr": k_rope[:, :, 0, :]}


def _mla_step(cfg: ModelConfig, p, x, cache, pos: int):
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, _step_pos(x, pos))
    ckv_c, kr_c = cache["ckv"], cache["kr"]
    ckv_c[:, pos:pos + 1] = c_kv.to(ckv_c.dtype)
    kr_c[:, pos:pos + 1] = k_rope[:, :, 0, :].to(kr_c.dtype)
    o = attn_mod.mla_decode_absorbed(q_nope, q_rope, ckv_c, kr_c, pos + 1,
                                     p["w_uk"], p["w_uv"])
    return _out(cfg, p, o), {"ckv": ckv_c, "kr": kr_c}


def _cross(cfg: ModelConfig, p, x, xkv):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    mem = xkv["x"]
    q = (x @ p["xwq"]).reshape(b, s, h, hd)
    k = (mem @ p["xwk"]).reshape(b, -1, kvh, hd)
    v = (mem @ p["xwv"]).reshape(b, -1, kvh, hd)
    o = attn_mod.cross_attention(q, k, v)
    return o.reshape(b, s, h * hd) @ p["xwo"]


def _cross_as_mixer(cfg: ModelConfig, p, xin, xkv):
    b, s, _ = xin.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (xin @ p["wq"]).reshape(b, s, h, hd)
    k = (xkv["x"] @ p["wk"]).reshape(b, -1, cfg.n_kv_heads, hd)
    v = (xkv["x"] @ p["wv"]).reshape(b, -1, cfg.n_kv_heads, hd)
    o = attn_mod.cross_attention(q, k, v)
    return o.reshape(b, s, h * hd) @ p["wo"]


def _ffn(cfg: ModelConfig, spec: LayerSpec, p, x):
    if spec.ffn == "dense":
        return ffn_mod.mlp(x, p, cfg.mlp_kind)
    if spec.ffn == "moe":
        b, s, d = x.shape
        moe_axes = shardctx.get("moe_axes")
        # the reference's condition: a2a when the batch divides dp×ep;
        # otherwise (and always without the hint) the sorted dispatch
        if (cfg.moe_dispatch == "a2a" and moe_axes is not None
                and b % (moe_axes["dp_size"] * moe_axes["ep_size"]) == 0):
            out, _aux = ffn_mod.moe_a2a(
                x, p, topk=cfg.topk, capacity_factor=cfg.capacity_factor,
                act=cfg.mlp_kind, dp_axes=moe_axes["dp"],
                ep_axis=moe_axes["ep"], mesh=moe_axes["mesh"])
        else:
            out, _aux = ffn_mod.moe(
                x.reshape(b * s, d), p, topk=cfg.topk,
                capacity_factor=cfg.capacity_factor,
                dispatch=cfg.moe_dispatch if cfg.moe_dispatch != "a2a"
                else "sort", act=cfg.mlp_kind)
            out = out.reshape(b, s, d)
        if cfg.n_shared_experts:
            sp = {"w1": p["s1"], "w2": p["s2"]}
            if "s3" in p:
                sp["w3"] = p["s3"]
            out = out + ffn_mod.mlp(x, sp, cfg.mlp_kind)
        return out
    if spec.ffn == "rwkv_cm":
        return ssm_mod.rwkv_channel_mix(x, p)
    raise ValueError(spec.ffn)


def _layer_full(cfg: ModelConfig, spec: LayerSpec, p, x, xkv=None, *,
                want_cache: bool):
    cache = {}
    if spec.mixer != "none":
        xin = _apply_norm(cfg, p["mixer"]["norm1"], x)
        if spec.mixer == "attn":
            o, c = _attn_full(cfg, spec, p["mixer"], xin)
        elif spec.mixer == "cross_attn":
            o, c = _cross_as_mixer(cfg, p["mixer"], xin, xkv), {}
        elif spec.mixer == "mla":
            o, c = _mla_full(cfg, p["mixer"], xin)
        elif spec.mixer == "mamba":
            if want_cache:
                o, c = _mamba_with_state(xin, p["mixer"])
            else:
                o, c = ssm_mod.mamba_scan(xin, p["mixer"]), {}
        elif spec.mixer == "rwkv6":
            if want_cache:
                o, c = _rwkv_with_state(xin, p["mixer"], cfg.rwkv_chunk)
            else:
                o = ssm_mod.rwkv6_chunked(xin, p["mixer"], chunk=cfg.rwkv_chunk)
                c = {}
        else:
            raise ValueError(spec.mixer)
        if cfg.post_norm:
            o = _apply_norm(cfg, p["mixer"]["pn1"], o)
        x = x + o
        cache["mixer"] = c
    if spec.cross:
        xin = _apply_norm(cfg, p["cross"]["normx"], x)
        x = x + _cross(cfg, p["cross"], xin, xkv)
    if spec.ffn != "none":
        xin = _apply_norm(cfg, p["ffn"]["norm2"], x)
        o = _ffn(cfg, spec, p["ffn"], xin)
        if cfg.post_norm:
            o = _apply_norm(cfg, p["ffn"]["pn2"], o)
        x = x + o
        if spec.ffn == "rwkv_cm" and want_cache:
            cache["cm_shift"] = xin[:, -1, :]
    return x, cache


def _layer_step(cfg: ModelConfig, spec: LayerSpec, p, x, cache, pos: int,
                xkv=None):
    new_cache = dict(cache)
    if spec.mixer != "none":
        xin = _apply_norm(cfg, p["mixer"]["norm1"], x)
        if spec.mixer == "attn":
            o, c = _attn_step(cfg, spec, p["mixer"], xin, cache["mixer"], pos)
        elif spec.mixer == "cross_attn":
            o, c = _cross_as_mixer(cfg, p["mixer"], xin, xkv), cache["mixer"]
        elif spec.mixer == "mla":
            o, c = _mla_step(cfg, p["mixer"], xin, cache["mixer"], pos)
        elif spec.mixer == "mamba":
            o2, c = ssm_mod.mamba_step(xin[:, 0, :], cache["mixer"], p["mixer"])
            o = o2[:, None, :]
        elif spec.mixer == "rwkv6":
            o2, c = ssm_mod.rwkv6_step(xin[:, 0, :], cache["mixer"], p["mixer"])
            o = o2[:, None, :]
        else:
            raise ValueError(spec.mixer)
        if cfg.post_norm:
            o = _apply_norm(cfg, p["mixer"]["pn1"], o)
        x = x + o
        new_cache["mixer"] = c
    if spec.cross:
        xin = _apply_norm(cfg, p["cross"]["normx"], x)
        x = x + _cross(cfg, p["cross"], xin, xkv)
    if spec.ffn != "none":
        xin = _apply_norm(cfg, p["ffn"]["norm2"], x)
        if spec.ffn == "rwkv_cm":
            o2, sh = ssm_mod.rwkv_channel_mix_step(
                xin[:, 0, :], cache["cm_shift"], p["ffn"])
            o = o2[:, None, :]
            new_cache["cm_shift"] = sh
        else:
            o = _ffn(cfg, spec, p["ffn"], xin)
        if cfg.post_norm:
            o = _apply_norm(cfg, p["ffn"]["pn2"], o)
        x = x + o
    return x, new_cache


class _MMF32(torch.autograd.Function):
    """``a @ b`` of low-precision 2-D operands, written in float32 by
    cuBLAS (``torch.mm(..., out_dtype=float32)``). The backward gives the
    reference's cotangents of a ``preferred_element_type=f32`` product: the
    float32 cotangent against the other operand widened to float32, each
    gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().t() @ g).to(b.dtype)
        return ga, gb


def _logits_f32(x, embed):
    """``x @ embed.T`` from model-dtype operands, accumulated and returned in
    float32 (the reference's ``preferred_element_type=f32``). On the card
    cuBLAS writes the f32 product of bf16 operands directly
    (:class:`_MMF32`); elsewhere the operands are widened, which is exact."""
    if x.dtype == torch.float32 and embed.dtype == torch.float32:
        return x @ embed.t()
    if x.is_cuda:
        out = _MMF32.apply(x.reshape(-1, x.shape[-1]), embed.t())
        return out.reshape(*x.shape[:-1], embed.shape[0])
    return x.float() @ embed.float().t()


def _dots_policy(ctx, op, *args, **kwargs):
    """Remat ``"dots"``: save the products without batch dimensions (the
    reference's ``dots_with_no_batch_dims_saveable``: ``mm``/``addmm``, not
    attention's or the experts' ``bmm``) and recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMATS = ("none", "full", "dots")


# ===========================================================================
# Model
# ===========================================================================

class Model(Params):
    """A model bound to a config, holding its parameters on ``device``
    (default ``"cuda"``).

    ``generator`` draws the seeded random initialisation (default: a
    generator on ``device`` seeded with 0); ``device="meta"`` allocates
    shapes only. :func:`repro_torch.models.convert.load_reference_params`
    installs the reference's weights instead."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        device = torch.device("cuda" if device is None else device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(init_params(cfg, device, generator))
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self["embed"].device

    # ---- public entry points --------------------------------------------
    def encode(self, frames):
        """Whisper-style encoder over precomputed frame embeddings."""
        cfg = self.cfg
        x = frames.to(self.device, cfg.torch_dtype)
        ecfg = _encoder_cfg(cfg, use_abs_pos=False)
        for lp in self["encoder"]["layers"]:
            x, _ = _layer_full(ecfg, _ENC_SPEC, lp, x, want_cache=False)
        return _apply_norm(cfg, self["encoder"]["final_norm"], x)

    def embed_tokens(self, tokens, pos0: int = 0):
        cfg = self.cfg
        x = self["embed"][tokens]
        if cfg.emb_scale:
            # the reference scales by sqrt(d) rounded to the model dtype
            x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
        if cfg.use_abs_pos:
            s = tokens.shape[1]
            x = x + self["pos_emb"][pos0:pos0 + s][None]
        return x

    def logits(self, x):
        cfg = self.cfg
        x = _apply_norm(cfg, self["final_norm"], x)
        return softcap(_logits_f32(x, self["embed"]), cfg.final_softcap)

    def forward(self, tokens, *, extra=None):
        """Full causal forward → logits (B,S,V) in float32. ``extra``: dict
        with 'frames' (enc-dec) or 'images' (VLM cross-attn memory)."""
        xkv = self._make_xkv(extra)
        x = self.embed_tokens(tokens)
        x, _ = self._run_layers(x, xkv)
        return self.logits(x)

    def _make_xkv(self, extra):
        if extra is None:
            return None
        if "frames" in extra:
            enc_out = self.encode(extra["frames"])
            return {"x": enc_out, "enc_out": enc_out}
        if "images" in extra:
            img = extra["images"].to(self.device, self.cfg.torch_dtype)
            return {"x": img, "enc_out": img}
        return None

    def _run_layers(self, x, xkv=None, *, want_cache: bool = False):
        """Every layer in order (the reference's ``_run_groups``, a scan
        over cycles of the pattern). Under autograd, ``cfg.remat``
        checkpoints one cycle at a time as the reference's scan body does:
        ``"full"`` keeps only each cycle's input, ``"dots"`` its
        batch-free products too (:func:`_dots_policy`). Remat changes what
        the backward keeps, not the values."""
        cfg = self.cfg
        if cfg.remat not in REMATS:
            raise ValueError(f"remat {cfg.remat!r}: one of {REMATS}")
        if cfg.remat != "none" and torch.is_grad_enabled() and not want_cache:
            return self._run_cycles_remat(x, xkv), []
        caches = []
        for spec, lp in zip(cfg.layers, self["layers"]):
            x, c = _layer_full(cfg, spec, lp, x, xkv, want_cache=want_cache)
            caches.append(c)
        return x, caches

    def _run_cycles_remat(self, x, xkv):
        cfg = self.cfg
        npat = len(cfg.pattern)

        def cycle(x, c):
            for pi, spec in enumerate(cfg.pattern):
                x, _ = _layer_full(cfg, spec, self["layers"][c * npat + pi],
                                   x, xkv, want_cache=False)
            return x

        kw = {}
        if cfg.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        for c in range(cfg.n_cycles):
            x = checkpoint(cycle, x, c, use_reentrant=False, **kw)
        return x

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, *, extra=None):
        """Forward + build decode caches sized ``cache_len``. Returns the
        last position's logits (B,1,V) and the cache."""
        xkv = self._make_xkv(extra)
        x = self.embed_tokens(tokens)
        x, caches = self._run_layers(x, xkv, want_cache=True)
        caches = self._pad_caches(caches, tokens.shape[1], cache_len)
        logits = self.logits(x[:, -1:, :])
        return logits, {"layers": caches, "pos": int(tokens.shape[1]),
                        "xkv": xkv}

    @staticmethod
    def _pad_caches(caches, s: int, cache_len: int):
        """Sequence-indexed leaves (k, v, ckv, kr) grow to ``cache_len``."""
        out = []
        for c in caches:
            c = dict(c)
            if "mixer" in c:
                m = dict(c["mixer"])
                for name in ("k", "v", "ckv", "kr"):
                    if name in m:
                        leaf = m[name]
                        buf = leaf.new_zeros(
                            (leaf.shape[0], cache_len, *leaf.shape[2:]))
                        buf[:, :s] = leaf
                        m[name] = buf
                c["mixer"] = m
            out.append(c)
        return out

    def empty_cache(self, batch: int, cache_len: int, dtype=None):
        """Zero decode caches (for serving from an empty state): the
        per-layer list of the cache's ``layers``."""
        cfg = self.cfg
        dt = dtype or cfg.torch_dtype
        kvh, hd = cfg.n_kv_heads, cfg.hd
        d_in = cfg.mamba_expand * cfg.d_model
        z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                                 device=self.device)
        caches = []
        for spec in cfg.layers:
            c: dict[str, Any] = {}
            if spec.mixer == "attn":
                c["mixer"] = {"k": z(batch, cache_len, kvh, hd),
                              "v": z(batch, cache_len, kvh, hd)}
            elif spec.mixer == "cross_attn":
                c["mixer"] = {}
            elif spec.mixer == "mla":
                c["mixer"] = {"ckv": z(batch, cache_len, cfg.kv_lora),
                              "kr": z(batch, cache_len, cfg.qk_rope_dim)}
            elif spec.mixer == "mamba":
                c["mixer"] = {
                    "conv": z(batch, cfg.mamba_d_conv - 1, d_in),
                    "h": z(batch, d_in, cfg.mamba_d_state,
                           dtype=torch.float32)}
            elif spec.mixer == "rwkv6":
                hr = cfg.d_model // cfg.rwkv_head_dim
                c["mixer"] = {
                    "shift": z(batch, cfg.d_model),
                    "s": z(batch, hr, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                           dtype=torch.float32)}
            if spec.ffn == "rwkv_cm":
                c["cm_shift"] = z(batch, cfg.d_model)
            caches.append(c)
        return caches

    @torch.no_grad()
    def decode_step(self, tokens, cache, *, extra=None):
        """One token: tokens (B,1); cache from prefill / empty_cache.

        Attention caches are written in place at ``cache["pos"]``; a step
        reads positions ``< pos + 1`` only, so decode one lineage of caches
        at a time."""
        cfg = self.cfg
        pos = cache["pos"]
        xkv = cache.get("xkv")
        if xkv is None and extra is not None:
            xkv = self._make_xkv(extra)
        x = self.embed_tokens(tokens, pos0=pos)
        new_layers = []
        for spec, lp, c in zip(cfg.layers, self["layers"], cache["layers"]):
            x, c = _layer_step(cfg, spec, lp, x, c, pos, xkv)
            new_layers.append(c)
        return self.logits(x), {"layers": new_layers, "pos": pos + 1,
                                "xkv": xkv}


def _mamba_with_state(x, p):
    """mamba_scan + final recurrent state (for prefill→decode handoff): the
    state the scan ends in, and the conv's last ``k-1`` inputs."""
    y, h_t, xi = ssm_mod._mamba_scan_state(x, p)
    k = p["conv_w"].shape[0]
    pad = torch.nn.functional.pad(xi, (0, 0, k - 1, 0))
    conv_tail = pad[:, pad.shape[1] - (k - 1):, :]
    return y, {"conv": conv_tail, "h": h_t}


def _rwkv_with_state(x, p, chunk):
    y = ssm_mod.rwkv6_chunked(x, p, chunk=chunk)
    # final state via the reference recurrence, no outputs kept
    r, k, v, g, logw = ssm_mod._rwkv_proj(x, ssm_mod._shift(x), p)
    b, sl, h, hd = r.shape
    kk, vv, ww = (t.float() for t in (k, v, logw))
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    for t in range(sl):
        s = torch.exp(ww[:, t])[..., :, None] * s + \
            kk[:, t, :, :, None] * vv[:, t, :, None, :]
    return y, {"shift": x[:, -1, :], "s": s}
