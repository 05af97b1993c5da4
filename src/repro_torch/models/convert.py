"""The reference's weights carried across: its parameter pytree in and out
of a port :class:`~repro_torch.models.transformer.Model`.

The reference keeps one parameter tree per pattern position, stacked over
cycles (``groups[pi]`` with leaves ``(cyc, ...)``), and the encoder's
layers stacked over layers; the port keeps one tree per layer,
``layers[c * len(pattern) + pi]``. Both functions copy exactly: the only
cast is to the parameter's own dtype (the config's, or float32 for the MoE
router), which the reference's arrays already have. Arrays are numpy;
bfloat16 arrays are ``ml_dtypes.bfloat16`` (what ``np.asarray`` of a JAX
bf16 array gives), read through their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Model, Params

__all__ = ["load_reference_params", "reference_params", "reference_cache"]


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _walk(params: Params, path: str = ""):
    """(path, parameter) of a tree's leaves, children in name order."""
    for k in sorted(params.keys()):
        v = params[k]
        if isinstance(v, Params):
            yield from _walk(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", k, v


def _keys(tree: dict, path: str = "") -> set:
    out = set()
    for k, v in tree.items():
        out |= _keys(v, f"{path}{k}.") if isinstance(v, dict) else {f"{path}{k}"}
    return out


def _get(tree: dict, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _sections(model: Model, tree: dict):
    """(port Params, reference subtree, stacked index or None) per part."""
    npat = len(model.cfg.pattern)
    yield model["final_norm"], tree["final_norm"], None
    for l, lp in enumerate(model["layers"]):
        c, pi = divmod(l, npat)
        yield lp, tree["groups"][pi], c
    if "encoder" in model:
        for i, lp in enumerate(model["encoder"]["layers"]):
            yield lp, tree["encoder"]["layers"], i
        yield model["encoder"]["final_norm"], tree["encoder"]["final_norm"], None


@torch.no_grad()
def load_reference_params(model: Model, tree: dict) -> Model:
    """Install the reference's parameter pytree (numpy leaves) in ``model``;
    returns ``model``. Raises on a missing or extra leaf or a shape
    mismatch."""
    top = [k for k in ("embed", "pos_emb") if k in model]
    want = set(top) | {"final_norm", "groups"} | (
        {"encoder"} if "encoder" in model else set())
    if set(tree) != want:
        raise ValueError(f"reference tree has {sorted(tree)}, the model "
                         f"{sorted(want)}")

    def put(param, a, path):
        t = _to_tensor(a)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{path}: reference shape {tuple(t.shape)}, "
                             f"port {tuple(param.shape)}")
        param.copy_(t.to(param.dtype))

    for k in top:
        put(model[k], tree[k], k)
    for params, sub, idx in _sections(model, tree):
        leaves = list(_walk(params))
        if {p for p, _, _ in leaves} != _keys(sub):
            raise ValueError(f"leaves differ: reference {sorted(_keys(sub))}, "
                             f"port {sorted(p for p, _, _ in leaves)}")
        for path, _, param in leaves:
            a = _get(sub, path)
            put(param, a if idx is None else np.asarray(a)[idx], path)
    return model


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _stacked(trees: list) -> dict:
    """Reference layout of per-layer trees: each leaf stacked on axis 0."""
    flat = {p: np.stack([_to_numpy(t[p]) for t in trees])
            for p in trees[0]}
    return _nest(flat)


def reference_params(model: Model) -> dict:
    """The inverse of :func:`load_reference_params`: the model's parameters
    as the reference's pytree of numpy arrays."""
    cfg = model.cfg
    npat = len(cfg.pattern)
    flat = [{p: t for p, _, t in _walk(lp)} for lp in model["layers"]]
    tree = {"embed": _to_numpy(model["embed"]),
            "final_norm": _nest({p: _to_numpy(t) for p, _, t in
                                 _walk(model["final_norm"])}),
            "groups": [_stacked(flat[pi::npat]) for pi in range(npat)]}
    if "pos_emb" in model:
        tree["pos_emb"] = _to_numpy(model["pos_emb"])
    if "encoder" in model:
        enc = model["encoder"]
        tree["encoder"] = {
            "layers": _stacked([{p: t for p, _, t in _walk(lp)}
                                for lp in enc["layers"]]),
            "final_norm": _nest({p: _to_numpy(t) for p, _, t in
                                 _walk(enc["final_norm"])})}
    return tree


def reference_cache(model: Model, layers: list) -> tuple:
    """A port cache's ``layers`` in the reference's layout: one dict per
    pattern position, each leaf stacked over cycles ``(cyc, B, ...)``, as
    numpy arrays."""
    npat = len(model.cfg.pattern)

    def flat(c, path=""):
        out = {}
        for k, v in c.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{path}{k}."))
                if not v:
                    out[f"{path}{k}"] = {}
            else:
                out[f"{path}{k}"] = v
        return out

    per = [flat(c) for c in layers]
    out = []
    for pi in range(npat):
        group = per[pi::npat]
        tree = {}
        for p in group[0]:
            if isinstance(group[0][p], dict):
                tree[p] = {}
            else:
                tree[p] = np.stack([_to_numpy(g[p]) for g in group])
        out.append(_nest(tree))
    return tuple(out)
