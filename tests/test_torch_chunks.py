"""Work items and the two-level order of the ``sorted`` and ``fused`` EC.

A tile's run of more than ``CHUNK_BLOCKS`` kernel blocks is cut into work
items; the CUDA kernels sum each item in slot order and the items' partials
in item order. Here, on the CPU: ``tile_chunks`` (the items the kernels
launch over), and the plain versions — which is what a CPU tensor runs —
on shards with such runs:

* bitwise equal to an independent numpy two-level sum (``np.add.at`` per
  chunk, then the chunks in order);
* within rtol 1e-5 / atol 1e-5·max|ref| of the reference's slot-order
  ``ref`` and of its ``ec_sorted`` Pallas kernel in interpret mode: rows of
  a few hundred f32 terms summed in another grouping differ in the last
  bits only;
* the same bits for every ``num_buffers``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from _torch_cases import LONG_RUN, longest_run, shard_arrays  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ref import ec_rows_chunked, ec_rows_ref  # noqa: E402

C = _build.CHUNK_BLOCKS
TOL = 1e-5


# -- tile_chunks --------------------------------------------------------------

def _items(b2t, chunk_blocks):
    """(items as (start, end, part), split runs as (first, n, tile))."""
    c = _build.tile_chunks(torch.tensor(b2t, dtype=torch.int32),
                           chunk_blocks)
    nb = len(b2t)
    assert c.item_starts.dtype == c.item_part.dtype == c.split.dtype == \
        torch.int32
    assert c.item_starts.shape == (nb + 1,) and c.item_part.shape == (nb,)
    assert c.split.shape == (3, nb // chunk_blocks)
    assert c.n_parts == 2 * nb // chunk_blocks
    starts = c.item_starts.tolist()
    n = starts.index(nb) if nb else 0
    assert starts[n:] == [nb] * (nb + 1 - n)
    assert c.item_part.tolist()[n:] == [-1] * (nb - n)
    items = [(starts[i], starts[i + 1], int(c.item_part[i]))
             for i in range(n)]
    split = [tuple(col) for col in c.split.T.tolist() if col[0] >= 0]
    assert all(col == [-1, -1, -1] for col in c.split.T.tolist()[len(split):])
    return items, split


def _runs(b2t):
    b2t = np.asarray(b2t)
    if not b2t.size:
        return []
    edges = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


def _check_cover(b2t, chunk_blocks):
    items, split = _items(b2t, chunk_blocks)
    it = iter(items)
    next_part, split_seen = 0, []
    for r0, r1 in _runs(b2t):
        length = r1 - r0
        if length <= chunk_blocks:  # one item, writing its tile
            assert next(it) == (r0, r1, -1)
            continue
        n = -(-length // chunk_blocks)
        for k in range(n):  # in order, each <= chunk_blocks blocks
            b = r0 + k * chunk_blocks
            assert next(it) == (b, min(b + chunk_blocks, r1), next_part + k)
        split_seen.append((next_part, n, int(b2t[r0])))
        next_part += n
    assert next(it, None) is None
    assert split == split_seen
    assert next_part <= 2 * len(b2t) // chunk_blocks
    return items


@pytest.mark.parametrize("b2t,chunk_blocks,expect", [
    ([0, 0, 3, 3, 3, 4, 7, 7], 3, [(0, 2, -1), (2, 5, -1), (5, 6, -1),
                                   (6, 8, -1)]),
    ([0, 0, 3, 3, 3, 3, 3, 4, 7, 7, 7, 7, 7, 7, 7], 3,
     [(0, 2, -1), (2, 5, 0), (5, 7, 1), (7, 8, -1), (8, 11, 2), (11, 14, 3),
      (14, 15, 4)]),
    ([5], 16, [(0, 1, -1)]),
    ([], 16, []),
    ([1] * 16, 16, [(0, 16, -1)]),
    ([1] * 17, 16, [(0, 16, 0), (16, 17, 1)]),
    ([2] * 3 + [0] * 40, 16, [(0, 3, -1), (3, 19, 0), (19, 35, 1),
                             (35, 43, 2)]),
])
def test_tile_chunks(b2t, chunk_blocks, expect):
    assert _check_cover(b2t, chunk_blocks) == expect


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tile_chunks_random_runs(seed):
    """Random run lengths around C: every run covered once, in order, by
    items of at most C blocks; runs of at most C blocks are one item."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3 * C + 2, size=rng.integers(1, 30))
    tiles = rng.permutation(len(lengths) + 5)[:len(lengths)]
    b2t = np.repeat(tiles, lengths).astype(np.int32)
    _check_cover(b2t, C)


def test_tile_chunks_default_is_chunk_blocks():
    b2t = torch.zeros(2 * C + 1, dtype=torch.int32)
    c = _build.tile_chunks(b2t)
    assert c.item_starts[:4].tolist() == [0, C, 2 * C, 2 * C + 1]
    assert c.split[:, 0].tolist() == [0, 3, 0]


# -- the plain versions on runs longer than C blocks -------------------------

def _numpy_two_level(a, factors, mode, part):
    """The fixed two-level order written out in numpy: a run of <= C
    blocks in slot order; a longer run as per-chunk (tile, R) partials in
    slot order (np.add.at), added from 0 in chunk order."""
    tile, block_p = part.tile, part.block_p
    e = a["values"][:, None].astype(np.float32)
    for w, f in enumerate(factors):
        if w != mode:
            e = e * f[a["indices"][:, w]]
    rows = a["local_rows"].astype(np.int64)
    b2t = a["block_to_tile"]
    out = np.zeros((part.rows_max, e.shape[1]), np.float32)
    for r0, r1 in _runs(b2t):
        if r1 - r0 <= C:
            sl = slice(r0 * block_p, r1 * block_p)
            np.add.at(out, rows[sl], e[sl])
            continue
        base = int(b2t[r0]) * tile
        total = np.zeros((tile, e.shape[1]), np.float32)
        for b in range(r0, r1, C):
            sl = slice(b * block_p, min(b + C, r1) * block_p)
            p = np.zeros_like(total)
            np.add.at(p, rows[sl] - base, e[sl])
            total = total + p
        out[base:base + tile] = total
    return out


def _port(a, part, factors, variant, mode, num_buffers=2):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return ops.mttkrp_local(
        t["indices"], t["values"], t["local_rows"], t["block_to_tile"],
        [torch.from_numpy(f) for f in factors], mode=mode,
        num_rows=part.rows_max, tile=part.tile, block_p=part.block_p,
        variant=variant, num_buffers=num_buffers,
        tile_mask=t["tile_visited"], seg_starts=t["seg_starts"],
        seg_rows=t["seg_rows"]).numpy()


def _jax(a, part, factors, variant, mode):
    return np.asarray(j_ops.mttkrp_local(
        jnp.asarray(a["indices"]), jnp.asarray(a["values"]),
        jnp.asarray(a["local_rows"]), jnp.asarray(a["block_to_tile"]),
        [jnp.asarray(f) for f in factors], mode=mode,
        num_rows=part.rows_max, tile=part.tile, block_p=part.block_p,
        variant=variant, interpret=True,
        tile_mask=jnp.asarray(a["tile_visited"]),
        seg_starts=jnp.asarray(a["seg_starts"]),
        seg_rows=jnp.asarray(a["seg_rows"])))


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_chunked_plain_equals_numpy_two_level(case, variant):
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    assert longest_run(a["block_to_tile"]) > C
    got = _port(a, part, factors, variant, mode)
    np.testing.assert_array_equal(got, _numpy_two_level(a, factors, mode,
                                                        part))


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_chunked_plain_near_reference(case, variant):
    """Against the reference's slot-order ``ref`` and its ``ec_sorted``
    Pallas kernel (interpret mode), which agree with each other bitwise."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    got = _port(a, part, factors, variant, mode)
    for ref_variant in ("ref", "sorted"):
        want = _jax(a, part, factors, ref_variant, mode)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("num_buffers", [3, 4])
def test_chunked_plain_num_buffers_same_bits(variant, num_buffers):
    part, factors, mode, dev = LONG_RUN["hot_row_4mode"]()
    a = shard_arrays(part, dev)
    np.testing.assert_array_equal(
        _port(a, part, factors, variant, mode, num_buffers=num_buffers),
        _port(a, part, factors, variant, mode, num_buffers=2))


@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_sorted_and_fused_plain_agree_bitwise(case):
    """Both kernels compute one function in one order, from descriptors
    or from per-slot rows."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    np.testing.assert_array_equal(_port(a, part, factors, "sorted", mode),
                                  _port(a, part, factors, "fused", mode))


def test_chunked_equals_slot_order_on_short_runs():
    """With every run at most ``chunk_blocks`` blocks the two-level order
    is the slot order, bit for bit; with a smaller chunk it is not."""
    part, factors, mode, dev = LONG_RUN["hot_row_3mode"]()
    a = {k: torch.from_numpy(v) for k, v in shard_arrays(part, dev).items()}
    gathered = [torch.from_numpy(f).index_select(0, a["indices"][:, w])
                for w, f in enumerate(factors) if w != mode]
    args = (a["values"], gathered, a["local_rows"], part.rows_max,
            a["block_to_tile"])
    geo = dict(tile=part.tile, block_p=part.block_p)
    slot_order = ec_rows_chunked(*args, **geo, chunk_blocks=part.nblocks)
    assert torch.equal(slot_order, ec_rows_ref(*args[:4]))
    split = ec_rows_chunked(*args, **geo, chunk_blocks=4)
    assert not torch.equal(split, slot_order)
    torch.testing.assert_close(split, slot_order, rtol=TOL,
                               atol=TOL * float(slot_order.abs().max()))
