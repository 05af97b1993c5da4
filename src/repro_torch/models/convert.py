"""The reference's weights carried across: its parameter pytree, and its
AdamW state, in and out of a port
:class:`~repro_torch.models.transformer.Model`.

The reference keeps one parameter tree per pattern position, stacked over
cycles (``groups[pi]`` with leaves ``(cyc, ...)``), and the encoder's
layers stacked over layers; the port keeps one tree per layer,
``layers[c * len(pattern) + pi]``. Both functions copy exactly: the only
cast is to the parameter's own dtype (the config's, or float32 for the MoE
router), which the reference's arrays already have; the moments ``mu`` and
``nu`` are float32 trees of the parameters' layout. Arrays are numpy;
bfloat16 arrays are ``ml_dtypes.bfloat16`` (what ``np.asarray`` of a JAX
bf16 array gives), read through their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Model, Params

__all__ = ["load_reference_params", "reference_params", "reference_cache",
           "reference_opt_state", "load_reference_opt_state"]


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


def _read_reference(model: Model, tree: dict, put) -> None:
    """``put(param, array, path)`` for every parameter of ``model`` and its
    array in the reference's pytree ``tree`` (a cycle's or layer's slice of
    a stacked leaf). Raises on a missing or extra leaf."""
    top = [k for k in ("embed", "pos_emb") if k in model]
    want = set(top) | {"final_norm", "groups"} | (
        {"encoder"} if "encoder" in model else set())
    if set(tree) != want:
        raise ValueError(f"reference tree has {sorted(tree)}, the model "
                         f"{sorted(want)}")
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


def _checked(param, a, path) -> torch.Tensor:
    t = _to_tensor(a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{path}: reference shape {tuple(t.shape)}, "
                         f"port {tuple(param.shape)}")
    return t


@torch.no_grad()
def load_reference_params(model: Model, tree: dict) -> Model:
    """Install the reference's parameter pytree (numpy leaves) in ``model``;
    returns ``model``. Raises on a missing or extra leaf or a shape
    mismatch."""
    def put(param, a, path):
        param.copy_(_checked(param, a, path).to(param.dtype))

    _read_reference(model, tree, put)
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


def _reference_layout(model: Model, leaf) -> dict:
    """The reference's pytree of ``leaf(param)`` (a numpy array) over the
    model's parameters: per-layer trees stacked on axis 0."""
    cfg = model.cfg
    npat = len(cfg.pattern)

    def flat(params):
        return {p: leaf(t) for p, _, t in _walk(params)}

    def stacked(trees):
        return _nest({p: np.stack([t[p] for t in trees]) for p in trees[0]})

    layers = [flat(lp) for lp in model["layers"]]
    tree = {"embed": leaf(model["embed"]),
            "final_norm": _nest(flat(model["final_norm"])),
            "groups": [stacked(layers[pi::npat]) for pi in range(npat)]}
    if "pos_emb" in model:
        tree["pos_emb"] = leaf(model["pos_emb"])
    if "encoder" in model:
        enc = model["encoder"]
        tree["encoder"] = {
            "layers": stacked([flat(lp) for lp in enc["layers"]]),
            "final_norm": _nest(flat(enc["final_norm"]))}
    return tree


def reference_params(model: Model) -> dict:
    """The inverse of :func:`load_reference_params`: the model's parameters
    as the reference's pytree of numpy arrays."""
    return _reference_layout(model, _to_numpy)


def reference_opt_state(model: Model, opt: dict) -> dict:
    """The port's AdamW state (``training.optimizer.adamw_init`` over
    ``dict(model.named_parameters())``) as the reference's: ``mu`` and
    ``nu`` in the parameters' ``groups`` layout, ``step`` an int32 scalar,
    all numpy."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {k: _reference_layout(
        model, lambda p, k=k: _to_numpy(opt[k][names[id(p)]]))
        for k in ("mu", "nu")} | {"step": _to_numpy(opt["step"])}


def load_reference_opt_state(model: Model, tree: dict, device=None) -> dict:
    """The inverse of :func:`reference_opt_state`: the reference's AdamW
    state as the port's, keyed by ``model.named_parameters()``'s names, on
    ``device`` (default: the model's). Raises on a missing or extra leaf
    or a shape mismatch."""
    device = model.device if device is None else torch.device(device)
    names = {id(p): n for n, p in model.named_parameters()}
    opt: dict = {"mu": {}, "nu": {}}
    for k in ("mu", "nu"):
        def put(param, a, path, k=k):
            opt[k][names[id(param)]] = _checked(param, a, path).to(
                device, torch.float32)
        _read_reference(model, tree[k], put)
        opt[k] = {n: opt[k][n] for n in names.values()}
    opt["step"] = torch.as_tensor(np.asarray(tree["step"]),
                                  dtype=torch.int32, device=device)
    return opt


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
