"""State-space / linear-recurrence mixers: Mamba (Jamba) and RWKV6 (Finch).

The port's copy of the reference package's ``models/ssm.py``. Each mixer
provides a sequential prefill (a Python loop over positions where the
reference runs ``lax.scan``), a single-token decode step carrying O(1)
state, and for RWKV6 a chunked (matmul-parallel) prefill equal to the scan.

The Mamba conv is the reference's shift-and-sum, not ``F.conv1d``, which
on the card may pick a cuDNN algorithm with another summation order.

Decay safety: per-channel decays are clamped to exp(-8) ≤ w ≤ exp(-1e-4) so
the chunked formulation's exp(±L) factors stay representable in f32 over a
chunk (the reference's documented deviation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mamba_scan", "mamba_step", "rwkv6_scan", "rwkv6_chunked",
           "rwkv6_step", "rwkv_channel_mix", "rwkv_channel_mix_step"]


# ---------------------------------------------------------------------------
# Mamba (selective SSM, Mamba-1 parameterisation)
# ---------------------------------------------------------------------------

def _mamba_gates(xc, p):
    """Input-dependent (Δ, B, C) from the conv output."""
    dt_rank = p["dt_proj"].shape[0]
    n = p["A_log"].shape[1]
    dbc = xc @ p["x_proj"]                           # (..., dt_rank + 2n)
    dt = F.softplus(dbc[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    b = dbc[..., dt_rank:dt_rank + n]
    c = dbc[..., dt_rank + n:]
    return dt, b, c                                   # (...,d_in),(...,n),(...,n)


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x (B,S,d_in), w (k,d_in)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b


def _mamba_scan_state(x, p):
    """The Mamba mixer over a sequence and its final recurrent state.
    Returns (out (B,S,d), h_T (B,d_in,n) f32, xi (B,S,d_in))."""
    xz = x @ p["in_proj"]                             # (B,S,2*d_in)
    d_in = xz.shape[-1] // 2
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, bb, cc = _mamba_gates(xc, p)
    a = -torch.exp(p["A_log"])                        # (d_in, n)
    xs, dts, bs, cs = (t.float() for t in (xc, dt, bb, cc))
    h = torch.zeros((x.shape[0], d_in, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        dt_t = dts[:, t]
        da = torch.exp(dt_t[..., None] * a[None])     # (B,d_in,n)
        h = da * h + (dt_t * xs[:, t])[..., None] * bs[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cs[:, t]))
    y = torch.stack(ys, dim=1) + xc * p["D"][None, None, :]
    out = (y * F.silu(z)).to(x.dtype)
    return out @ p["out_proj"], h, xi


def mamba_scan(x, p):
    """Full-sequence Mamba mixer. x (B,S,d) → (B,S,d)."""
    return _mamba_scan_state(x, p)[0]


def mamba_step(x_t, state, p):
    """One decode step. x_t (B,d); state = {'conv': (B,k-1,d_in),
    'h': (B,d_in,n)}. Returns (y (B,d), new state)."""
    xz = x_t @ p["in_proj"]
    d_in = xz.shape[-1] // 2
    xi, z = xz[..., :d_in], xz[..., d_in:]
    conv_buf = torch.cat([state["conv"], xi[:, None, :]], dim=1)  # (B,k,d_in)
    xc = F.silu(torch.einsum("bkd,kd->bd", conv_buf, p["conv_w"]) + p["conv_b"])
    dt, bb, cc = _mamba_gates(xc, p)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a[None])
    h = da * state["h"] + (dt * xc)[..., None] * bb[:, None, :]
    # f32 state against the model's dtype: the product in f32, as JAX's
    # einsum promotes
    y = torch.einsum("bdn,bn->bd", h, cc.to(h.dtype)) + xc * p["D"][None, :]
    out = (y * F.silu(z)).to(x_t.dtype) @ p["out_proj"]
    return out, {"conv": conv_buf[:, 1:], "h": h}


# ---------------------------------------------------------------------------
# RWKV6 (Finch) time-mix with data-dependent per-channel decay
# ---------------------------------------------------------------------------

_W_MIN, _W_MAX = -8.0, -1e-4  # bounds on log-decay


def _rwkv_proj(x, x_prev, p):
    """Token-shift mixing + projections. x, x_prev: (B,S,d).
    Returns r,k,v,g (B,S,H,hd), logw (B,S,H,hd)."""
    hd = p["u"].shape[1]
    h = x.shape[-1] // hd

    def mix(name):
        mu = p[f"mu_{name}"]
        return x + mu * (x_prev - x)

    def heads(y):
        return y.reshape(*y.shape[:-1], h, hd)

    r = heads(mix("r") @ p["wr"])
    k = heads(mix("k") @ p["wk"])
    v = heads(mix("v") @ p["wv"])
    g = F.silu(mix("g") @ p["wg"])
    logw = -F.softplus(mix("w") @ p["ww"] + p["w_base"])
    logw = torch.clamp(logw, _W_MIN, _W_MAX)
    return r, k, v, g, heads(logw)


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def rwkv6_scan(x, p):
    """Reference scan. x (B,S,d) → (B,S,d) (before output proj ⊙ g)."""
    r, k, v, g, logw = _rwkv_proj(x, _shift(x), p)
    u = p["u"]                                        # (H, hd)
    b, s_len, h, hd = r.shape
    rr, kk, vv, ww = (t.float() for t in (r, k, v, logw))
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    os = []
    for t in range(s_len):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]   # (B,H,hd,hd)
        os.append(torch.einsum("bhi,bhij->bhj", rr[:, t],
                               s + u[None, :, :, None] * kv))
        s = torch.exp(ww[:, t])[..., :, None] * s + kv
    o = torch.stack(os, dim=1)                        # (B,S,H,hd)
    return _rwkv_out(o, g, x, p)


def rwkv6_chunked(x, p, *, chunk: int = 64):
    """Chunked (intra-chunk matmul) form — equal to rwkv6_scan.

    Within a chunk, with L_t = Σ_{j<=t} logw_j:
      o_t = r_t·A_{t-1}·S_in + Σ_{s<t} (r_t e^{L_{t-1}-L_s})·k_s v_s
            + (r_t ⊙ u ⊙ k_t)·v_t
      S_out = e^{L_C} S_in + Σ_s e^{L_C - L_s} k_s v_s
    """
    b, s_len, d = x.shape
    r, k, v, g, logw = _rwkv_proj(x, _shift(x), p)
    u = p["u"]
    h, hd = r.shape[2], r.shape[3]
    c = min(chunk, s_len)
    while s_len % c:         # largest divisor of s_len not exceeding chunk
        c -= 1
    nc = s_len // c

    def resh(t):
        return t.reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4).float()

    rr, kk, vv, ww = resh(r), resh(k), resh(v), resh(logw)  # (nc,B,H,c,hd)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device),
                      diagonal=-1)
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    os = []
    for ci in range(nc):
        rc, kc, vc, wc = rr[ci], kk[ci], vv[ci], ww[ci]   # (B,H,c,hd)
        lcum = torch.cumsum(wc, dim=2)                # L_t (inclusive)
        l_prev = lcum - wc                            # L_{t-1}
        l_tot = lcum[:, :, -1:, :]                    # L_C
        q_dec = rc * torch.exp(l_prev)                # r_t e^{L_{t-1}}
        k_dec = kc * torch.exp(-lcum)                 # k_s e^{-L_s}
        inter = torch.einsum("bhti,bhij->bhtj", q_dec, s)
        scores = torch.einsum("bhti,bhsi->bhts", q_dec, k_dec)
        scores = torch.where(mask[None, None], scores, 0.0)
        intra = torch.einsum("bhts,bhsj->bhtj", scores, vc)
        diag = torch.einsum("bhti,bhti,bhtj->bhtj",
                            rc, u[None, :, None, :] * kc, vc)
        os.append(inter + intra + diag)
        k_rem = kc * torch.exp(l_tot - lcum)          # k_s e^{L_C - L_s}
        s = torch.exp(l_tot[:, :, 0, :])[..., :, None] * s + \
            torch.einsum("bhsi,bhsj->bhij", k_rem, vc)
    o = torch.stack(os).permute(1, 0, 3, 2, 4).reshape(b, s_len, h, hd)
    return _rwkv_out(o, g, x, p)


def rwkv6_step(x_t, state, p):
    """One decode step. x_t (B,d); state {'shift': (B,d), 's': (B,H,hd,hd)}."""
    x1 = x_t[:, None, :]
    r, k, v, g, logw = _rwkv_proj(x1, state["shift"][:, None, :], p)
    r, k, v, logw = (t[:, 0].float() for t in (r, k, v, logw))
    g = g[:, 0]
    u = p["u"]
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", r, state["s"] + u[None, :, :, None] * kv)
    s_new = torch.exp(logw)[..., :, None] * state["s"] + kv
    out = _rwkv_out(o[:, None], g[:, None], x1, p)[:, 0]
    return out, {"shift": x_t, "s": s_new}


def _rwkv_out(o, g, x, p):
    """Per-head groupnorm → gate → output projection."""
    b, s, h, hd = o.shape
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o * p["ln_w"][None, None] + p["ln_b"][None, None]
    o = o.reshape(b, s, h * hd).to(x.dtype) * g
    return o @ p["wo"]


def rwkv_channel_mix(x, p):
    """RWKV channel-mix FFN (squared-relu with receptance gate)."""
    xx = _shift(x)
    xk = x + p["mu_ck"] * (xx - x)
    xr = x + p["mu_cr"] * (xx - x)
    k = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"])


def rwkv_channel_mix_step(x_t, shift_state, p):
    xx = shift_state
    xk = x_t + p["mu_ck"] * (xx - x_t)
    xr = x_t + p["mu_cr"] * (xx - x_t)
    k = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (k @ p["cv"]), x_t
