"""Parameter / activation partition rules.

The port's copy of the reference package's ``models/sharding.py``. Mesh
axes: ``data`` (+ ``pod`` when multi-pod) = data parallel; ``model`` =
tensor/expert parallel. Rules are keyed on parameter leaf names.

A spec is a tuple, one entry per dimension, normalised as
``jax.sharding.PartitionSpec`` normalises its entries (an empty tuple is
``None``, a 1-tuple is its one axis name), so ``tuple(P(...))`` of the
reference compares equal. A mesh is any object with ``axis_names`` and a
``shape`` mapping from axis name to size (``launch.mesh``'s description
meshes, or a ``core.mttkrp.CPMesh``-like object).

The reference applies its rules to a cycle-stacked tree: each layer leaf
carries a leading cycle dimension (``(cyc, E, d, f)`` is an expert leaf,
``(cyc, d, f)`` a dense one) that its rules pad with ``None``. The port's
tree holds one entry per layer (``models.convert`` maps the layouts), so
its rules apply to the per-layer shape: an expert leaf is 3-D and a dense
one 2-D, and the reference's spec of a stacked leaf is the port's with a
leading ``None``. ZeRO-1 (``training.optimizer.zero1_specs``) shards the
first divisible unsharded dimension of what it is given: of a stacked leaf
that may be the cycle dimension, which a per-layer leaf does not have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["spec", "dp_axes", "batch_spec", "param_specs", "sanitize_specs",
           "make_shardings", "Placement", "flatten", "TP"]

TP = "model"

# leaf name -> spec on the per-layer shape
_RULES: dict[str, tuple] = {
    # embeddings
    "embed": ("vocab_d",),
    "pos_emb": (None, None),
    # attention
    "wq": (None, TP), "wk": (None, TP), "wv": (None, TP), "wo": (TP, None),
    "bq": (TP,), "bk": (TP,), "bv": (TP,), "bo": (None,),
    # MLA
    "w_dkv": (None, None), "w_uk": (None, TP, None), "w_uv": (None, TP, None),
    # dense mlp
    "w1": ("mlp_in",), "w3": ("mlp_in",), "w2": ("mlp_out",),
    # moe shared experts
    "s1": (None, TP), "s3": (None, TP), "s2": (TP, None),
    "router": (None, None),
    # mamba
    "in_proj": (None, TP), "conv_w": (None, TP), "conv_b": (TP,),
    "x_proj": (TP, None), "dt_proj": (None, TP), "dt_bias": (TP,),
    "A_log": (TP, None), "D": (TP,), "out_proj": (TP, None),
    # rwkv6
    "wr": (None, TP), "wg": (None, TP), "ww": (None, TP),
    "w_base": (TP,), "u": (TP, None), "ln_w": (TP, None), "ln_b": (TP, None),
    "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_g": (None,),
    "mu_w": (None,),
    # rwkv channel mix
    "mu_ck": (None,), "mu_cr": (None,),
    "ck": (None, TP), "cr": (None, None), "cv": (TP, None),
    # cross attention
    "xwq": (None, TP), "xwk": (None, TP), "xwv": (None, TP), "xwo": (TP, None),
}


def spec(*entries) -> tuple:
    """A partition spec as a tuple, normalised like ``PartitionSpec``."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            if not e:
                return None
            return e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def _pad(sp: tuple, ndim: int, rank: int) -> tuple:
    """Prepend ``None`` for leading dims beyond the rule's rank."""
    if ndim > rank:
        return spec(*([None] * (ndim - rank) + list(sp)))
    return sp


def _spec_for(name: str, ndim: int) -> tuple:
    """The spec of a per-layer (or top-level) leaf called ``name``."""
    rule = _RULES.get(name)
    if name == "embed":
        return spec(TP, None)                 # vocab-sharded (tied unembed)
    if rule is None:
        return spec()                         # norms, scalars -> replicated
    if name in ("w1", "w3", "w2"):
        # per layer: dense (d, f) / (f, d) is 2-D; experts (E, d, f) /
        # (E, f, d) are 3-D, experts over the model axis (EP)
        if ndim >= 3:
            return spec(*([None] * (ndim - 3) + [TP, None, None]))
        if name == "w2":
            return _pad(spec(TP, None), ndim, 2)
        return _pad(spec(None, TP), ndim, 2)
    return _pad(spec(*rule), ndim, len(rule))


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def flatten(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a nested dict / list tree, in the naming
    of ``nn.Module.named_parameters`` (``layers.0.mixer.wq``)."""
    if isinstance(tree, list):
        items = list(enumerate(tree))
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:                          # a leaf: a tensor or a spec tuple
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def param_specs(params) -> Any:
    """The spec of every leaf of a parameter tree of nested dicts and lists
    of tensors (``launch.shapes.param_tree`` of a ``Model``; meta tensors
    do), as the same tree of spec tuples."""
    def leaf(path, t):
        name = next(p for p in reversed(path) if isinstance(p, str))
        return _spec_for(name, len(t.shape))
    return _map_tree(leaf, params)


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in axes)


def _zip_map(fn, specs, shapes):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, v, shapes[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_zip_map(fn, v, shapes[i]) for i, v in enumerate(specs)]
    return fn(specs, shapes)


def sanitize_specs(specs: Any, shapes: Any, mesh) -> Any:
    """Drop sharding on dims the mesh axes don't divide (e.g. whisper's
    51865-row vocab on a 16-way model axis -> replicated embed)."""
    def one(sp: tuple, shape) -> tuple:
        dims = tuple(shape.shape)
        entries = list(sp) + [None] * (len(dims) - len(sp))
        return spec(*[e if (e is None or dims[i] % _axes_size(mesh, e) == 0)
                      else None for i, e in enumerate(entries)])
    return _zip_map(one, specs, shapes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a sharded leaf lives: ``spec`` over ``mesh`` (the port's
    counterpart of a ``NamedSharding``, with no devices behind it)."""
    mesh: Any
    spec: tuple

    def shard_shape(self, global_shape) -> tuple:
        """The shape one device holds of a ``global_shape`` leaf."""
        dims = list(global_shape)
        for i, e in enumerate(self.spec):
            n = _axes_size(self.mesh, e)
            if dims[i] % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} is not "
                                 f"divisible by {e!r} ({n})")
            dims[i] //= n
        return tuple(dims)


def make_shardings(mesh, tree_of_specs: Any) -> Any:
    """A :class:`Placement` per spec of a nested dict/list of specs
    (``None`` stays ``None``)."""
    return _map_tree(lambda _, sp: None if sp is None else Placement(mesh, sp),
                     tree_of_specs)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(mesh) -> tuple:
    return spec(dp_axes(mesh))
