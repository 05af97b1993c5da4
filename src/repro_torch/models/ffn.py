"""Feed-forward blocks: dense MLP variants and Mixture-of-Experts.

The port's copy of the reference package's ``models/ffn.py``. MoE dispatch
has the reference's two interchangeable single-device implementations,
``"scatter"`` (capacity-bucketed, GShard style) and ``"sort"`` (token
copies sorted by expert id into contiguous segments — the AMPED transfer).
Both drop the copies over capacity, and the capacity is computed over the
flat tokens of the call as there.

Where the two libraries differ, the port pins the reference's semantics:

* ``jax.nn.gelu`` is the tanh approximation; so is :func:`_act`'s.
* ``lax.top_k`` breaks ties by the lower index; :func:`_topk_gates` takes
  the top ``k`` of a stable descending sort.
* ``jnp.argsort`` is stable; so are the port's sorts.
* The combine sums each token's ``topk`` copies in ``k`` order, with no
  atomics, so a run on the card gives the same bits every time.

The expert-parallel ``moe_a2a`` and its bucket helpers belong to the
multi-device slice; ``Model._ffn`` takes the reference's own fallback to
``"sort"`` when no ``moe_axes`` hint is installed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mlp", "moe", "moe_ref_dense"]


def _act(kind: str, x, gate=None):
    if kind == "swiglu":
        return F.silu(gate) * x
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if kind == "squared_relu":
        return torch.square(F.relu(x))
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp(x, p, kind: str = "swiglu"):
    """x (..., d). p: {'w1','w2'} (+ 'w3' gate for *glu kinds)."""
    if kind in ("swiglu", "geglu"):
        h = _act(kind, x @ p["w1"], x @ p["w3"])
    else:
        h = _act(kind, x @ p["w1"])
    return h @ p["w2"]


def _topk_gates(logits, k: int):
    """Softmax-after-topk router (deepseek/mixtral convention); ties go to
    the lower expert index, as ``lax.top_k``'s do."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k], dim=-1)
    return gates, idx[..., :k]


def moe(x, p, *, topk: int, capacity_factor: float = 1.25,
        dispatch: str = "sort", act: str = "swiglu"):
    """MoE over flat tokens. x: (T, d). p: {'router' (d,E),
    'w1','w3' (E,d,f), 'w2' (E,f,d)}. Returns (T, d), aux metrics."""
    t, d = x.shape
    e = p["router"].shape[1]
    cap = max(1, -(-int(capacity_factor * t * topk) // e))  # ceil
    cap = min(cap, t)
    dev = x.device

    logits = x.float() @ p["router"].float()
    gates, eidx = _topk_gates(logits, topk)          # (T,k)

    flat_e = eidx.reshape(-1)                        # (T*k,)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(topk)

    if dispatch == "scatter":
        # position of each copy within its expert via cumsum over one-hot
        onehot = (flat_e[:, None] == torch.arange(e, device=dev)).to(torch.int32)
        pos = torch.cumsum(onehot, dim=0) - 1
        mypos = pos.gather(1, flat_e[:, None])[:, 0]
        keep = mypos < cap
        slot = torch.where(keep, mypos, cap - 1)
        buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
        buf.index_put_((flat_e, slot), torch.where(
            keep, 1.0, 0.0).to(x.dtype)[:, None] * x[flat_tok],
            accumulate=True)
        y = _expert_ffn(buf, p, act)
        out_copies = torch.where(keep[:, None], y[flat_e, slot], 0.0)
    elif dispatch == "sort":
        # AMPED-style: sort copies by expert id → contiguous segments.
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        tok_sorted = flat_tok[order]
        # rank within segment = position - segment start
        seg_start = torch.searchsorted(e_sorted, torch.arange(e, device=dev))
        rank = torch.arange(t * topk, device=dev) - seg_start[e_sorted]
        keep_s = rank < cap
        slot = torch.where(keep_s, rank, cap - 1)
        buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
        buf.index_put_((e_sorted, slot), torch.where(
            keep_s, 1.0, 0.0).to(x.dtype)[:, None] * x[tok_sorted],
            accumulate=True)
        y = _expert_ffn(buf, p, act)
        copies_sorted = torch.where(keep_s[:, None], y[e_sorted, slot], 0.0)
        inv = torch.argsort(order)
        out_copies = copies_sorted[inv]
    else:
        raise ValueError(dispatch)

    # the reference's out.at[flat_tok].add(...): flat_tok is
    # repeat(arange(t), topk), so each token's copies are added in k order
    contrib = (out_copies.float() * flat_g[:, None]).reshape(t, topk, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(topk):
        out = out + contrib[:, j]
    load = torch.zeros(e, dtype=torch.float32, device=dev).index_put_(
        (flat_e,), torch.ones_like(flat_g), accumulate=True)
    aux = {"router_z": torch.mean(torch.square(
        torch.logsumexp(logits, dim=-1))),
        "load": load / (t * topk)}
    return out.to(x.dtype), aux


def _expert_ffn(buf, p, act: str):
    """buf (E, cap, d) → (E, cap, d), batched over experts."""
    if act in ("swiglu", "geglu"):
        h1 = torch.bmm(buf, p["w1"])
        h3 = torch.bmm(buf, p["w3"])
        h = _act(act, h1, h3)
    else:
        h = _act(act, torch.bmm(buf, p["w1"]))
    return torch.bmm(h, p["w2"])


def moe_ref_dense(x, p, *, topk: int, act: str = "swiglu"):
    """O(T·E) oracle: run every expert on every token, combine with top-k
    gates. No capacity drops — comparisons must use cap >= tokens."""
    t, d = x.shape
    e = p["router"].shape[1]
    logits = x.float() @ p["router"].float()
    gates, eidx = _topk_gates(logits, topk)
    ys = _expert_ffn(x.expand(e, t, d).contiguous(), p, act)  # (E,T,d)
    onehot = F.one_hot(eidx, e).float()                        # (T,k,E)
    w = (onehot * gates[..., None]).sum(1)                     # (T,E)
    return torch.einsum("te,etd->td", w, ys.float()).to(x.dtype)
