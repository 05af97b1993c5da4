"""The benchmark's tensor generator: a dataset profile, scaled, drawn on the
device from the run's seed.

The semantics are those of the port's synthetic profiles
(``core/coo.draw_sparse_block`` and ``random_sparse`` with
``sparse/io.profile_geometry``), frozen here so that a change to the program
cannot change the benchmark's inputs:

- the mode sizes and the number of draws scale linearly, each by a factor
  of its own (at least 8 rows a mode and 64 draws);
- a ``zipf`` mode draws Zipf(a) over 1, 2, ... and shifts it to start at 0;
  draws past the mode's end fold onto its last index. Drawn by inverse CDF
  in float64, the folded tail mass being ``zeta(a, s) / zeta(a)``;
- a ``uniform`` mode draws every index alike;
- values are standard normal float32;
- duplicate coordinates are summed into one nonzero. The coordinates are
  sorted on as many int64 words as the shape needs, so no shape overflows a
  key (five Twitch modes at 3e-2 span 6.8e19 coordinates).

The draws are torch's, not numpy's: the benchmark takes its inputs from its
own seed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["scaled_geometry", "zipf_cdf", "tail_mass", "key_words",
           "draw_coo", "summed"]

_WORD_LIMIT = 1 << 62


def scaled_geometry(shape, nnz: int, scale: float,
                    mode_scale: float) -> tuple[tuple[int, ...], int]:
    """(shape, draws) of a profile: its draws cut to ``scale`` of its
    nonzeros, its mode sizes to ``mode_scale``."""
    return (tuple(max(8, int(round(s * mode_scale))) for s in shape),
            max(64, int(round(nnz * scale))))


def zipf_cdf(size: int, a: float, device) -> torch.Tensor:
    """float64 CDF over indices ``0 .. size-1`` of Zipf(a) shifted to 0,
    with the mass past the end folded onto index ``size - 1``."""
    k = torch.arange(1, size, dtype=torch.float64, device=device)
    zeta = torch.special.zeta(torch.tensor(a, dtype=torch.float64),
                              torch.tensor(1.0, dtype=torch.float64)).item()
    cdf = torch.cumsum(k.pow(-a), 0) / zeta
    return torch.cat([cdf, torch.ones(1, dtype=torch.float64, device=device)])


def key_words(shape) -> list[list[int]]:
    """Consecutive groups of modes whose coordinates ravel into one int64
    word each (lexicographic order over the words is the order over the
    coordinates)."""
    words, cur, span = [], [], 1
    for m, s in enumerate(shape):
        if cur and span * s >= _WORD_LIMIT:
            words.append(cur)
            cur, span = [], 1
        cur.append(m)
        span *= s
    words.append(cur)
    return words


def _draw_mode(size: int, n: int, distribution: str, a: float,
               gen: torch.Generator, device) -> torch.Tensor:
    if distribution == "uniform":
        return torch.randint(0, size, (n,), generator=gen, device=device)
    if distribution == "zipf":
        u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
        return torch.searchsorted(zipf_cdf(size, a, device), u,
                                  right=True).clamp_(max=size - 1)
    raise ValueError(f"unknown distribution {distribution!r}")


def draw_coo(shape, n: int, *, distribution: str, zipf_a: float, seed: int,
             device) -> tuple[np.ndarray, np.ndarray]:
    """``n`` draws over ``shape`` from ``seed``, duplicates summed: host
    int32 indices ``(nnz, nmodes)`` sorted by coordinate, and float32
    values. Device memory is freed before this returns."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    cols = [_draw_mode(s, n, distribution, zipf_a, gen, device)
            for s in shape]
    vals = torch.randn(n, dtype=torch.float32, generator=gen, device=device)
    out = summed(cols, vals, shape)
    del cols, vals
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def summed(cols, vals: torch.Tensor, shape) -> tuple[np.ndarray, np.ndarray]:
    """Duplicate coordinates of the draws ``cols`` (one int64 tensor a
    mode) summed in float64: host int32 indices sorted by coordinate and
    float32 values."""
    n, device = vals.shape[0], vals.device
    groups = key_words(shape)
    words = []
    for modes in groups:
        w = torch.zeros(n, dtype=torch.int64, device=device)
        for m in modes:
            w.mul_(shape[m]).add_(cols[m])
        words.append(w)
    perm = torch.arange(n, device=device)
    for w in reversed(words):       # least significant word first, stable
        perm = perm[torch.sort(w[perm], stable=True).indices]
    words = [w[perm] for w in words]
    new = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        new[1:] = torch.stack([w[1:] != w[:-1] for w in words]).any(0)
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], torch.tensor([n], device=device)])
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                      torch.cumsum(vals[perm].double(), 0)])
    sums = (csum[ends] - csum[starts]).float()
    ind = torch.empty((starts.numel(), len(shape)), dtype=torch.int32,
                      device=device)
    for modes, w in zip(groups, words):
        w = w[starts]
        for m in reversed(modes):
            ind[:, m] = (w % shape[m]).int()
            w = w // shape[m]
    return ind.cpu().numpy(), sums.cpu().numpy()


def tail_mass(size: int, a: float) -> float:
    """``zeta(a, size) / zeta(a)``: the share of Zipf draws folded onto the
    last index of a mode of ``size`` rows."""
    z = torch.special.zeta
    t = torch.tensor
    return float(z(t(a, dtype=torch.float64), t(float(size), dtype=torch.float64))
                 / z(t(a, dtype=torch.float64), t(1.0, dtype=torch.float64)))

