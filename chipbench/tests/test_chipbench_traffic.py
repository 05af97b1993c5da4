"""The tensor generator: seeded, folded Zipf tails, duplicates summed on
keys that do not overflow."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench.traffic import tensor as gen


def test_same_seed_same_tensor_other_seed_other():
    shape = (300, 120, 90)
    kw = dict(distribution="zipf", zipf_a=1.1, device="cpu")
    a = gen.draw_coo(shape, 20_000, seed=2**33 + 5, **kw)
    b = gen.draw_coo(shape, 20_000, seed=2**33 + 5, **kw)
    c = gen.draw_coo(shape, 20_000, seed=2**33 + 6, **kw)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[0].shape != c[0].shape or not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("size,a", [(5, 1.1), (40, 1.4), (1000, 1.05)])
def test_folded_tail_mass_is_hurwitz_over_riemann(size, a):
    cdf = gen.zipf_cdf(size, a, "cpu")
    direct = sum(k ** -a for k in range(1, 200_000)) + 200_000 ** (1 - a) / (a - 1)
    head = sum(k ** -a for k in range(1, size))
    assert cdf[-1].item() == 1.0
    assert 1.0 - cdf[-2].item() == pytest.approx(gen.tail_mass(size, a),
                                                 rel=1e-9)
    assert gen.tail_mass(size, a) == pytest.approx(1 - head / direct,
                                                   rel=1e-4)


def test_drawn_shares_follow_the_cdf():
    size, a, n = 6, 1.4, 400_000
    g = torch.Generator().manual_seed(3)
    idx = gen._draw_mode(size, n, "zipf", a, g, "cpu")
    share = torch.bincount(idx, minlength=size).double() / n
    pmf = torch.diff(gen.zipf_cdf(size, a, "cpu"), prepend=torch.zeros(1,
                     dtype=torch.float64))
    assert torch.allclose(share, pmf, atol=3e-3)
    assert share[-1].item() == pytest.approx(gen.tail_mass(size, a),
                                             abs=3e-3)


def test_scaled_geometry_is_the_profiles_linear_scaling():
    amazon = (4_821_207, 1_774_269, 1_805_187)
    assert gen.scaled_geometry(amazon, 1_741_809_018, 3e-2, 3e-2) == \
        ((144_636, 53_228, 54_156), 52_254_271)
    assert gen.scaled_geometry(amazon, 1_741_809_018, 1.9e-2, 1.0) == \
        (amazon, 33_094_371)
    assert gen.scaled_geometry((46, 10), 100, 1e-3, 1e-3) == ((8, 8), 64)


def test_key_words_split_where_int64_would_overflow():
    twitch = (465_729, 184_850, 23_516, 183, 183)
    words = gen.key_words(twitch)
    assert words == [[0, 1, 2, 3], [4]]
    for w in words:
        assert np.prod([float(twitch[m]) for m in w]) < 2.0 ** 62
    assert gen.key_words((144_636, 53_228, 54_156)) == [[0, 1, 2]]


@pytest.mark.parametrize("shape", [(7, 5, 3), (465_729, 184_850, 23_516, 3, 3)])
def test_summed_matches_a_plain_accumulation(shape):
    rng = np.random.default_rng(1)
    n = 5000
    cols = np.stack([rng.integers(0, min(s, 4), n) for s in shape], 1)
    cols[:, 0] = rng.integers(0, 3, n) * (shape[0] - 1) // 2
    vals = rng.standard_normal(n).astype(np.float32)
    ind, out = gen.summed([torch.from_numpy(c) for c in cols.T],
                          torch.from_numpy(vals), shape)
    want: dict = {}
    for c, v in zip(map(tuple, cols), vals):
        want[c] = want.get(c, 0.0) + float(v)
    keys = sorted(want)
    assert [tuple(r) for r in ind.tolist()] == keys
    assert np.array_equal(out, np.array([want[k] for k in keys], np.float32))
