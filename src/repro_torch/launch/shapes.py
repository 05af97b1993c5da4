"""Assigned input-shape cells and their arguments, as ``meta`` tensors.

The port's counterpart of the reference package's ``launch/shapes.py``.

Cells (assignment):
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> serve prefill
  decode_32k   seq=32768  global_batch=128   -> serve decode (1 new token,
                                                KV cache of seq_len)
  long_500k    seq=524288 global_batch=1     -> decode, sub-quadratic archs
                                                only (rwkv6, jamba) with
                                                sequence-parallel KV

:func:`input_specs` returns what the dry-run needs: the function to run,
its arguments as tensors on the ``meta`` device (``Model(cfg,
device="meta")``, its ``empty_cache``, ``adamw_init`` of its parameters:
shapes and dtypes, no storage), their placements on the mesh
(``models.sharding.Placement``), and the bookkeeping the roofline reads.
The port's parameter tree holds one entry per layer, so ``args[0]`` is the
model's nested tree of parameters, and the decode cache is the port's
per-layer list; the reference's layouts are ``models.convert``'s mapping
of these. Tokens are int32, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm_serve as serve_mod
from repro_torch.models import shardctx
from repro_torch.models import sharding as shard_rules
from repro_torch.models.transformer import Model, ModelConfig, Params
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import make_train_step

__all__ = ["SHAPE_CELLS", "LONG_OK", "ENCODER_LEN", "IMAGE_TOKENS",
           "input_specs", "supports_cell", "CellSpec", "param_count",
           "active_param_count", "param_tree"]

SHAPE_CELLS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode", seq_shard=True),
}

# archs whose every layer is sub-quadratic-capable (SSM / hybrid with
# seq-parallel attention decode) — the only ones long_500k runs on.
LONG_OK = {"rwkv6_7b", "jamba15_large"}

ENCODER_LEN = 1500      # whisper stub frames
IMAGE_TOKENS = 1600     # llama-vision stub patch embeddings

META = torch.device("meta")


def supports_cell(arch: str, cell: str) -> bool:
    if cell == "long_500k":
        return arch in LONG_OK
    return True


@dataclasses.dataclass
class CellSpec:
    fn: Callable              # the cell's function, run on ``args``
    args: tuple               # meta tensors (nested dicts / lists)
    in_shardings: tuple       # Placements, the structure of ``args``
    out_shardings: Any
    meta: dict                # bookkeeping for the roofline

    def arg_bytes_per_device(self) -> int:
        """Bytes of ``args`` one device holds under ``in_shardings``."""
        return _placed_bytes(self.args, self.in_shardings)


def _placed_bytes(tree, placements) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_placed_bytes(v, placements[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_placed_bytes(v, p) for v, p in zip(tree, placements))
    if not isinstance(tree, torch.Tensor):
        return 0                     # a Python int (the decode position)
    shape = tuple(tree.shape) if placements is None else \
        placements.shard_shape(tree.shape)
    return math.prod(shape) * tree.element_size()


def param_tree(params: Params):
    """A ``Params`` tree as nested dicts and lists of its tensors."""
    if type(params).__name__ == "ModuleList":
        return [param_tree(p) for p in params]
    if not isinstance(params, Params):
        return params
    return {k: param_tree(params[k]) for k in params.keys()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def param_count(params) -> int:
    return sum(math.prod(t.shape) for _, t in _leaves(param_tree(params)))


def active_param_count(cfg: ModelConfig, params) -> int:
    """MoE-aware active parameters: the routed experts' leaves (``w1``,
    ``w2``, ``w3`` of an FFN that has a ``router``) count at
    ``topk / n_experts``; every other leaf counts whole."""
    tree = param_tree(params)
    total = 0
    for path, leaf in _leaves(tree):
        n = math.prod(leaf.shape)
        if cfg.n_experts and path and path[-1] in ("w1", "w2", "w3"):
            parent = tree
            for k in path[:-1]:
                parent = parent[k]
            if "router" in parent:
                n = int(n * cfg.topk / cfg.n_experts)
        total += n
    return total


def _extra_shapes(cfg: ModelConfig, batch: int) -> dict:
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.empty((batch, ENCODER_LEN, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=META)
    elif any(s.mixer == "cross_attn" for s in cfg.pattern):
        extra["images"] = torch.empty((batch, IMAGE_TOKENS, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=META)
    return extra


def _extra_specs(extra: dict, dp) -> dict:
    return {k: shard_rules.spec(dp, None, None) for k in extra}


def _with_moe_hints(cfg: ModelConfig, mesh, dp, fn):
    """Install the ``moe_axes`` hint the ``a2a`` MoE dispatch reads."""
    if cfg.moe_dispatch != "a2a" or "model" not in mesh.axis_names:
        return fn
    if cfg.n_experts == 0 or cfg.n_experts % mesh.shape["model"]:
        return fn
    ep_size = mesh.shape["model"]
    dp_size = math.prod(mesh.shape[a] for a in (dp or ()))
    axes = {"mesh": mesh, "dp": dp, "ep": "model",
            "dp_size": dp_size, "ep_size": ep_size}
    moe_out = shard_rules.spec(dp, None, None)

    def wrapped(*args):
        with shardctx.hints(moe_axes=axes, moe_out=moe_out):
            return fn(*args)

    return wrapped


def _per_layer_cache_specs(model: Model, mesh, **kw) -> list:
    """``lm_serve.cache_specs`` (the reference's layout: a leading cycle
    dimension per pattern position) as the port's per-layer list."""
    stacked = serve_mod.cache_specs(model, mesh, **kw)["layers"]
    npat = len(model.cfg.pattern)

    def drop(sp):
        if isinstance(sp, dict):
            return {k: drop(v) for k, v in sp.items()}
        return sp[1:]

    return [drop(stacked[l % npat]) for l in range(model.cfg.n_layers)]


def input_specs(arch: str, cell: str, mesh, *,
                remat: str | None = None,
                microbatches: int = 1,
                variant: str = "full",
                seq: int | None = None,
                batch: int | None = None,
                kv_layout: str = "auto",
                moe_dispatch: str | None = None,
                n_layers: int | None = None) -> CellSpec:
    """``variant='smoke'`` + seq/batch overrides run the identical path at
    CPU scale. ``mesh``: ``launch.mesh``'s description meshes, or any
    object with ``axis_names`` and a ``shape`` mapping. ``n_layers``
    builds the config with that many decoder layers (the dry-run counts
    one cycle of the pattern and none, and weights the cycle by the
    config's cycle count)."""
    info = SHAPE_CELLS[cell]
    cfg = get_config(arch, variant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    model = Model(cfg, device=META)
    kind = info["kind"]
    seq = seq or info["seq"]
    batch = batch or info["batch"]
    dp = shard_rules.dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    if batch % max(dp_size, 1):
        dp = None            # tiny batches (long_500k b=1) stay replicated

    params_shape = param_tree(model)
    p_specs = shard_rules.param_specs(params_shape)
    p_specs = shard_rules.sanitize_specs(p_specs, params_shape, mesh)
    p_shard = shard_rules.make_shardings(mesh, p_specs)

    chips = math.prod(mesh.shape[a] for a in mesh.axis_names)
    kv_bytes = sum(t.numel() * t.element_size() for c in
                   model.empty_cache(batch, seq) for _, t in _leaves(c))
    meta = dict(arch=arch, cell=cell, seq=seq, batch=batch, kind=kind,
                params=param_count(params_shape),
                active_params=active_param_count(cfg, params_shape),
                chips=chips, d_model=cfg.d_model, n_layers=cfg.n_layers,
                kv_bytes=kv_bytes, remat=cfg.remat not in (None, "none"))
    tok = lambda *shape: torch.empty(shape, dtype=torch.int32,  # noqa: E731
                                     device=META)
    pl = lambda sp: shard_rules.Placement(mesh, sp)             # noqa: E731

    if kind == "train":
        opt_shape = opt_mod.adamw_init(dict(model.named_parameters()))
        o_specs = opt_mod.zero1_specs(p_specs, params_shape, mesh)
        o_specs = {"mu": shard_rules.flatten(o_specs["mu"]),
                   "nu": shard_rules.flatten(o_specs["nu"]),
                   "step": o_specs["step"]}
        o_shard = shard_rules.make_shardings(mesh, o_specs)
        extra = _extra_shapes(cfg, batch)
        batch_shapes = {"tokens": tok(batch, seq), "targets": tok(batch, seq),
                        **extra}
        batch_specs = {"tokens": shard_rules.spec(dp),
                       "targets": shard_rules.spec(dp),
                       **_extra_specs(extra, dp)}
        b_shard = shard_rules.make_shardings(mesh, batch_specs)
        opt_cfg = opt_mod.AdamWConfig()
        step = make_train_step(model, opt_cfg, microbatches=microbatches)

        def base_step(params, opt_state, batch_in):
            return step(opt_state, batch_in)

        return CellSpec(
            fn=_with_moe_hints(cfg, mesh, dp, base_step),
            args=(params_shape, opt_shape, batch_shapes),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, None),
            meta=meta,
        )

    if kind == "prefill":
        extra = _extra_shapes(cfg, batch)

        def prefill_base(params, tokens, extra_in):
            return model.prefill(tokens, cache_len=seq,
                                 extra=extra_in or None)

        return CellSpec(
            fn=_with_moe_hints(cfg, mesh, dp, prefill_base),
            args=(params_shape, tok(batch, seq), extra),
            in_shardings=(p_shard, pl(shard_rules.spec(dp, None)),
                          shard_rules.make_shardings(
                              mesh, _extra_specs(extra, dp))),
            out_shardings=None,
            meta=meta,
        )

    # decode: one token at the cache's last position, so the step reads
    # the whole cache (the reference's step reads all of it, masked)
    seq_shard = bool(info.get("seq_shard"))
    c_layers = _per_layer_cache_specs(model, mesh, batch=batch,
                                      seq_shard=seq_shard,
                                      kv_layout=kv_layout)
    extra = _extra_shapes(cfg, batch)
    cache = {"layers": model.empty_cache(batch, seq), "pos": seq - 1}
    cache_spec_tree = {"layers": c_layers, "pos": None}
    if extra:
        # cross-attn memory rides in the cache (computed at prefill time)
        mem = extra["frames" if "frames" in extra else "images"]
        cache["xkv"] = {"x": mem, "enc_out": mem}
        cache_spec_tree["xkv"] = {"x": shard_rules.spec(dp, None, None),
                                  "enc_out": shard_rules.spec(dp, None, None)}
    else:
        cache["xkv"] = None
        cache_spec_tree["xkv"] = None

    dp_b = dp if (dp and batch % dp_size == 0 and batch > 1
                  and not seq_shard) else None
    q_hint = shard_rules.spec(dp_b, None, None, None)
    tp = "model" if "model" in mesh.axis_names else None
    heads_ok = tp is not None and cfg.n_kv_heads % mesh.shape.get(tp, 1) == 0
    if seq_shard:
        s_axis = dp
    elif tp and not heads_ok and kv_layout == "auto":
        s_axis = tp
    else:
        s_axis = None
    scores_hint = shard_rules.spec(dp_b, None, None, s_axis) if s_axis \
        else None

    def decode_base(params, tokens, cache_in):
        with shardctx.hints(decode_q=q_hint, decode_scores=scores_hint):
            return model.decode_step(tokens, cache_in)

    return CellSpec(
        fn=_with_moe_hints(cfg, mesh, dp, decode_base),
        args=(params_shape, tok(batch, 1), cache),
        in_shardings=(p_shard, pl(shard_rules.spec(dp, None)),
                      shard_rules.make_shardings(mesh, cache_spec_tree)),
        out_shardings=None,
        meta={**meta, "seq_shard": seq_shard, "kv_layout": kv_layout},
    )
