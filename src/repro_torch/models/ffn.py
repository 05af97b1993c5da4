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

``dispatch="a2a"`` is :func:`moe_a2a`, the expert-parallel all-to-all.
The reference runs it inside ``shard_map`` with one ``lax.all_to_all``
over the expert axis; the port keeps one controller (as its CP exchange
does) and loops over the ``(dp, ep)`` shards of a mesh of logical devices.
``Model._ffn`` calls it under the reference's own condition (a
``moe_axes`` hint, and a batch that divides ``dp_size * ep_size``) and
takes the ``"sort"`` dispatch otherwise.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.comm import volume
from repro_torch.kernels.ref import slot_order_index_add

__all__ = ["mlp", "moe", "moe_ref_dense", "moe_a2a", "a2a_exchange_bytes",
           "count_dropped"]

# the dropped-copy counts of the MoE calls under count_dropped(), else None
_DROPPED: list | None = None


@contextlib.contextmanager
def count_dropped():
    """Collect the token copies each MoE call drops for capacity while the
    block runs; yields a dict whose ``"copies"`` is their total once the
    block ends (one host read, then). Off outside the block."""
    global _DROPPED
    prev, _DROPPED = _DROPPED, []
    out: dict = {}
    try:
        yield out
    finally:
        got, _DROPPED = _DROPPED, prev
        out["copies"] = int(sum(int(t) for t in got))


def _note_dropped(n) -> None:
    if _DROPPED is not None:
        _DROPPED.append(n)


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
        _note_dropped((~keep).sum())
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
        _note_dropped((~keep_s).sum())
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


def _bucket_scatter(values, bucket, rank, nbuckets: int, cap: int):
    """Scatter rows into ``(nbuckets, cap, ...)`` buckets. Rows whose rank
    is ``cap`` or more land in a sacrificial slot ``cap`` that is sliced
    off, so no valid slot is ever corrupted by a collision. values:
    ``(N, ...)`` or ``(N,)``, int or float."""
    slot = torch.where(rank < cap, rank, cap)
    buf = torch.zeros((nbuckets, cap + 1) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    buf = buf.index_put((bucket, slot), values, accumulate=True)
    return buf[:, :cap]


def _local_expert_ffn(xs, le, valid, w1, w2, w3, act: str):
    """Run a shard's local experts on the rows it received. xs: (N, d);
    le: (N,) local expert id; valid: (N,) bool. Returns (N, d), invalid
    rows zero."""
    n, d = xs.shape
    e_loc = w1.shape[0]
    if e_loc == 1:
        p1 = {"w1": w1[0], "w2": w2[0]}
        if w3 is not None:
            p1["w3"] = w3[0]
        return torch.where(valid[:, None], mlp(xs, p1, act), 0.0)
    # the senders padded by capacity_factor already: the per-expert
    # capacity is the balanced share of the N received rows
    dev = xs.device
    cap = min(n, max(1, -(-n // e_loc)))
    le_eff = torch.where(valid, le, e_loc)           # invalid -> dummy bucket
    order = torch.argsort(le_eff, stable=True)
    le_s = le_eff[order]
    seg_start = torch.searchsorted(le_s, torch.arange(e_loc + 1, device=dev))
    rank = torch.arange(n, device=dev) - seg_start[torch.clamp(le_s, max=e_loc)]
    ok = (le_s < e_loc) & (rank < cap)
    _note_dropped(((le_s < e_loc) & (rank >= cap)).sum())
    buf = _bucket_scatter(torch.where(ok[:, None], xs[order], 0.0),
                          torch.where(ok, le_s, e_loc - 1),
                          torch.where(ok, rank, cap), e_loc, cap)
    p = {"w1": w1, "w2": w2}
    if w3 is not None:
        p["w3"] = w3
    y = _expert_ffn(buf, p, act)
    got = y[torch.where(ok, le_s, 0), torch.where(ok, rank, 0)]
    got = torch.where(ok[:, None], got, 0.0)
    return got[torch.argsort(order)]


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all(..., tiled=True)`` over one group of ``ep`` shards:
    chunk ``j`` of shard ``i``'s ``(ep, ...)`` buffer goes to shard ``j``
    and lands at position ``i``. Each chunk that crosses to another shard
    adds its bytes to the sender's ``"all_to_all"`` count; the backward
    is the same exchange of the gradients, counted the same way."""

    @staticmethod
    def forward(ctx, ids, devices, *bufs):
        ctx.ids, ctx.devices = ids, devices
        return tuple(_exchange(list(bufs), ids, devices))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_exchange(list(grads), ctx.ids, ctx.devices))


def _exchange(bufs, ids, devices):
    ep = len(bufs)
    for i, b in enumerate(bufs):
        volume.count_sent("all_to_all", ids[i],
                          (ep - 1) * (b.numel() // ep) * b.element_size())
    if len(set(devices)) == 1:
        # logical devices on one device: the exchange is a transposition
        return list(torch.stack(bufs).transpose(0, 1).unbind(0))
    return [torch.stack([bufs[i][j].to(devices[j], non_blocking=True)
                         for i in range(ep)]) for j in range(ep)]


def _all_to_all(bufs, ids, devices):
    return list(_AllToAll.apply(tuple(ids), tuple(devices), *bufs))


def a2a_exchange_bytes(ep: int, s_b: int, d: int, itemsize: int) -> int:
    """Bytes one shard sends per :func:`moe_a2a` call (forward): its
    payload out and the expert outputs back, ``2 (ep-1) s_b d`` elements,
    and the local expert ids, ``(ep-1) s_b`` int32s. The chunk a shard
    keeps for itself does not leave it."""
    return 2 * (ep - 1) * s_b * d * itemsize + (ep - 1) * s_b * 4


def _mesh_index(mesh, coords: dict) -> int:
    """Row-major position of ``coords`` (axis -> index, 0 where absent)."""
    idx = 0
    for a in mesh.axis_names:
        idx = idx * mesh.shape[a] + coords.get(a, 0)
    return idx


def moe_a2a(x, p, *, topk: int, capacity_factor: float, act: str,
            dp_axes, ep_axis: str, mesh):
    """Expert-parallel MoE via all-to-all over the ``(dp, ep)`` shards of
    ``mesh`` (``axis_names``, a ``shape`` mapping and, optionally,
    ``devices``: one torch device per position, row-major; without them
    every shard runs on ``x``'s device).

    x: (B, S, d) global activations. The batch is split over ``dp_axes`` ×
    ``ep_axis`` when it divides, else batch over ``dp_axes`` and sequence
    over ``ep_axis`` (the reference's boundary). Each shard routes its
    tokens, sorts the copies by destination shard (stable), fills one
    ``s_b``-row bucket per destination, and exchanges the buckets with
    :class:`_AllToAll`; each shard runs its ``E / ep`` experts (views of
    ``w1/w2/w3``) on what it received, and the outputs travel back to the
    slots they came from. Copies over ``s_b`` a destination are dropped.
    Each token's ``topk`` contributions are summed in f32 in the sorted
    order with :func:`slot_order_index_add`. Returns ``(out, {})``."""
    dp_axes = tuple(dp_axes) if dp_axes else ()
    tok_axes = dp_axes + (ep_axis,)
    ep = mesh.shape[ep_axis]
    dp_sizes = [mesh.shape[a] for a in dp_axes]
    dp_size = math.prod(dp_sizes)
    b, s, d = x.shape
    if b % (dp_size * ep) == 0:
        b_loc, s_loc = b // (dp_size * ep), s
    elif b % dp_size == 0 and s % ep == 0:
        b_loc, s_loc = b // dp_size, s // ep
    else:
        raise ValueError(f"x {tuple(x.shape)} splits neither over {tok_axes} "
                         f"nor over {dp_axes} x {ep_axis}")
    seq_split = s_loc != s
    e = p["router"].shape[1]
    if e % ep:
        raise ValueError(f"{e} experts over {ep} expert shards")
    e_loc = e // ep
    w3 = p["w3"] if "w3" in p else None
    t_loc = b_loc * s_loc
    k = topk
    s_b = min(max(1, -(-int(t_loc * k * capacity_factor) // ep)), t_loc * k)

    devices = getattr(mesh, "devices", None)
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    for a in range(dp_size):
        coords = {}
        rest = a
        for ax, n in zip(reversed(dp_axes), reversed(dp_sizes)):
            coords[ax], rest = rest % n, rest // n
        devs, ids, st = [], [], []
        for j in range(ep):
            sid = _mesh_index(mesh, {**coords, ep_axis: j})
            dev = x.device if devices is None else torch.device(devices[sid])
            if seq_split:
                xb = x[a * b_loc:(a + 1) * b_loc, j * s_loc:(j + 1) * s_loc]
            else:
                i0 = (a * ep + j) * b_loc
                xb = x[i0:i0 + b_loc]
            devs.append(dev)
            ids.append(sid)
            st.append(_a2a_route(xb.to(dev), p["router"].to(dev), k, ep,
                                 e_loc, s_b))
        recv_x = _all_to_all([r["send_x"] for r in st], ids, devs)
        recv_le = _all_to_all([r["send_le"] for r in st], ids, devs)
        ys = []
        for j in range(ep):
            dev = devs[j]
            xs = recv_x[j].reshape(ep * s_b, d)
            le = recv_le[j].reshape(ep * s_b) - 1
            sl = slice(j * e_loc, (j + 1) * e_loc)
            y = _local_expert_ffn(
                xs, torch.clamp(le, min=0), le >= 0, p["w1"][sl].to(dev),
                p["w2"][sl].to(dev), None if w3 is None else w3[sl].to(dev),
                act)
            ys.append(y.reshape(ep, s_b, d).to(x.dtype))
        back = _all_to_all(ys, ids, devs)
        for j in range(ep):
            r = st[j]
            got = back[j][r["dest_s"], torch.clamp(r["rank"], max=s_b - 1)]
            got = torch.where(r["keep"][:, None], got, 0.0)
            contrib = got * r["gate_s"][:, None]
            o = torch.zeros((t_loc, d), dtype=torch.float32, device=devs[j])
            o = slot_order_index_add(o, r["tok_s"], contrib)
            o = o.to(x.dtype).reshape(b_loc, s_loc, d).to(x.device)
            if seq_split:
                out[a * b_loc:(a + 1) * b_loc, j * s_loc:(j + 1) * s_loc] = o
            else:
                i0 = (a * ep + j) * b_loc
                out[i0:i0 + b_loc] = o
    return out, {}


def _a2a_route(xb, router, k: int, ep: int, e_loc: int, s_b: int) -> dict:
    """One shard's routing and send buckets (the reference's ``body`` up to
    its first all-to-all)."""
    b_loc, s_loc, d = xb.shape
    t_loc = b_loc * s_loc
    dev = xb.device
    x_loc = xb.reshape(t_loc, d)
    logits = x_loc.float() @ router.float()
    gates, eidx = _topk_gates(logits, k)
    flat_e = eidx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    dest = flat_e // e_loc                           # destination EP shard
    order = torch.argsort(dest, stable=True)         # AMPED: group by owner
    dest_s = dest[order]
    seg_start = torch.searchsorted(dest_s, torch.arange(ep, device=dev))
    rank = torch.arange(t_loc * k, device=dev) - seg_start[dest_s]
    keep = rank < s_b
    _note_dropped((~keep).sum())
    tok_s = flat_tok[order]
    send_x = _bucket_scatter(
        torch.where(keep[:, None], x_loc[tok_s], 0.0).to(x_loc.dtype),
        dest_s, rank, ep, s_b)                       # payload stays bf16
    send_le = _bucket_scatter(
        torch.where(keep, (flat_e[order] % e_loc) + 1, 0).to(torch.int32),
        dest_s, rank, ep, s_b)                       # +1: 0 marks empty
    return {"send_x": send_x, "send_le": send_le, "dest_s": dest_s,
            "rank": rank, "keep": keep, "tok_s": tok_s,
            "gate_s": flat_g[order]}


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
