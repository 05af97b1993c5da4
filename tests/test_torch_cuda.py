"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the CPU, bitwise: the same f32 products, the same per-row order
of additions (slot order, and for ``sorted``/``fused`` on a tile's run of
more than ``CHUNK_BLOCKS`` blocks the fixed two-level order, which the
plain versions follow too; on the card they do so under
``torch.use_deterministic_algorithms(True)``).

Marked ``gpu``: skipped where no card is present, which the fixture below
decides at run time. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cases import (BLOCKED_PROPERTY, BLOCKED_SHAPES,  # noqa: E402
                          DEGENERATE_SORTED, LONG_RUN, blocked_case,
                          partitioned_case, shard_arrays)
import repro_torch.api as api  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.mttkrp_blocked import ec_blocked  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ec(part, factors, variant, device, dev=0, mode=1, num_buffers=2,
        plain=False):
    """One shard's EC through ``mttkrp_local`` (``plain``: the variant's
    plain version on the same device, through ``kernel_args``)."""
    a = shard_arrays(part, dev)
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    facs = [torch.from_numpy(f).to(device) for f in factors]
    if plain:
        from repro_torch.kernels import mttkrp_fused, mttkrp_sorted
        fn = {"sorted": mttkrp_sorted.ec_sorted_plain,
              "fused": mttkrp_fused.ec_fused_plain}[variant]
        args = ops.kernel_args(variant, t["indices"], t["values"],
                               t["local_rows"], t["block_to_tile"], facs,
                               mode=mode, tile=part.tile,
                               seg_starts=t["seg_starts"],
                               seg_rows=t["seg_rows"])
        out = fn(*args, num_rows=part.rows_max, tile=part.tile,
                 block_p=part.block_p)
        return ops._mask_unvisited(out, t["tile_visited"], part.tile).cpu()
    return ops.mttkrp_local(
        t["indices"], t["values"], t["local_rows"], t["block_to_tile"], facs,
        mode=mode, num_rows=part.rows_max, tile=part.tile,
        block_p=part.block_p, variant=variant, num_buffers=num_buffers,
        tile_mask=t["tile_visited"], seg_starts=t["seg_starts"],
        seg_rows=t["seg_rows"]).cpu()


def _assert_kernel_equals_plain(part, factors, variant, cuda, **kw):
    before = _build.LAUNCHES[f"ec_{variant}"]
    got = _ec(part, factors, variant, cuda, **kw)
    assert _build.LAUNCHES[f"ec_{variant}"] == before + 1
    ref = _ec(part, factors, variant, "cpu", **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [8, 32])
def test_kernel_matches_plain(cuda, variant, nmodes, rank):
    layout = "sorted" if variant == "sorted" else "blocked"
    part, factors = partitioned_case(nmodes, rank, seed=nmodes * 10 + rank,
                                     layout=layout)
    _assert_kernel_equals_plain(part, factors, variant, cuda)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("num_buffers", [2, 3, 4])
def test_kernel_num_buffers(cuda, variant, num_buffers):
    part, factors = partitioned_case(3, 16, seed=5)
    _assert_kernel_equals_plain(part, factors, variant, cuda,
                                num_buffers=num_buffers)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("case", sorted(DEGENERATE_SORTED))
def test_kernel_degenerate_shards(cuda, variant, case):
    part, factors, mode, dev = DEGENERATE_SORTED[case]()
    _assert_kernel_equals_plain(part, factors, variant, cuda, dev=dev,
                                mode=mode)


@pytest.mark.parametrize("num_buffers", [2, 3, 4])
@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_kernel_long_runs(cuda, case, variant, num_buffers):
    """Runs of more than CHUNK_BLOCKS blocks, split into work items and
    combined: bitwise equal to the plain version on the CPU and on the card
    (deterministic, index-order ``index_add_``), for every ring depth."""
    part, factors, mode, dev = LONG_RUN[case]()
    kw = dict(dev=dev, mode=mode, num_buffers=num_buffers)
    _assert_kernel_equals_plain(part, factors, variant, cuda, **kw)
    got = _ec(part, factors, variant, cuda, **kw)
    torch.use_deterministic_algorithms(True)
    try:
        ref = _ec(part, factors, variant, cuda, plain=True, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
def test_kernel_two_launches_same_bits(cuda, variant):
    part, factors, mode, dev = LONG_RUN["hot_row_4mode"]()
    a = _ec(part, factors, variant, cuda, dev=dev, mode=mode)
    b = _ec(part, factors, variant, cuda, dev=dev, mode=mode)
    assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("nmodes,rank,num_buffers", [
    (2, 4, 2), (3, 6, 3), (4, 64, 4), (5, 64, 4), (5, 128, 2)])
def test_smem_model_is_what_the_kernel_lays_out(cuda, variant, nmodes, rank,
                                                num_buffers):
    """The C entry point refuses a launch whose shared memory differs from
    its own layout, so a launch at the modelled bytes that runs and matches
    the plain version shows the model exact; a rank not a multiple of 4
    takes the 4-byte copies."""
    part, factors = partitioned_case(nmodes, rank, seed=rank + nmodes)
    _assert_kernel_equals_plain(part, factors, variant, cuda,
                                num_buffers=num_buffers)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
def test_oversized_item_kernel_raises_before_launch(cuda, variant):
    part, factors = partitioned_case(5, 128, seed=3, tile=32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        _ec(part, factors, variant, cuda, num_buffers=4)
    assert _build.LAUNCHES == before


def test_item_launch_rejects_a_wrong_smem_size(cuda, monkeypatch):
    """Called with other bytes than its layout needs, the C entry point
    returns an error instead of launching."""
    from repro_torch.kernels import mttkrp_fused
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f).to(cuda) for f in factors]
    args = ops.kernel_args("fused", a["indices"], a["values"],
                           a["local_rows"], a["block_to_tile"], facs, mode=1,
                           tile=part.tile)
    real = _build.variant_smem_bytes
    monkeypatch.setattr(_build, "variant_smem_bytes",
                        lambda *x, **k: real(*x, **k) + 16)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mttkrp_fused.ec_fused(*args, num_rows=part.rows_max, tile=part.tile,
                              block_p=part.block_p)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_kernel_replicated_shards(cuda, variant):
    part, factors = partitioned_case(3, 16, seed=3, num_devices=2,
                                     replication=2)
    for dev in range(2):
        _assert_kernel_equals_plain(part, factors, variant, cuda, dev=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_ec_blocked_direct(cuda, shape, dtype):
    tile, p, r, nin = shape
    b2t, rit, vals, gathered = blocked_case(7, tile, 5, p, r, nin, seed=1)
    args = [torch.from_numpy(x) for x in (vals, rit, b2t)]
    rows = [torch.from_numpy(g).to(dtype) for g in gathered]
    kw = dict(num_rows=5 * tile, tile=tile, block_p=p)
    got = ec_blocked(*[a.to(cuda) for a in args],
                     [g.to(cuda) for g in rows], **kw).cpu()
    ref = ec_blocked(*args, rows, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("seed,nblocks,n_tiles", BLOCKED_PROPERTY)
def test_ec_blocked_property(cuda, seed, nblocks, n_tiles):
    b2t, rit, vals, gathered = blocked_case(nblocks, 8, n_tiles, 16, 8, 2,
                                            seed)
    args = [torch.from_numpy(x) for x in (vals, rit, b2t)]
    rows = [torch.from_numpy(g) for g in gathered]
    kw = dict(num_rows=n_tiles * 8, tile=8, block_p=16)
    got = ec_blocked(*[a.to(cuda) for a in args],
                     [g.to(cuda) for g in rows], **kw).cpu()
    torch.testing.assert_close(got, ec_blocked(*args, rows, **kw),
                               rtol=0, atol=0)


def test_tile_runs_on_card(cuda):
    b2t = np.array([0, 0, 3, 3, 3, 4, 7, 7], np.int32)
    got = _build.tile_runs(torch.from_numpy(b2t).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, [0, 2, 5, 6, 8, 8, 8, 8, 8])


def test_kernel_rejects_bad_arguments(cuda):
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f).to(cuda) for f in factors]
    kw = dict(mode=1, num_rows=part.rows_max, tile=part.tile,
              block_p=part.block_p, variant="fused",
              tile_mask=a["tile_visited"])
    with pytest.raises(TypeError):
        ops.mttkrp_local(a["indices"], a["values"].double(), a["local_rows"],
                         a["block_to_tile"], facs, **kw)
    with pytest.raises(ValueError):
        ops.mttkrp_local(a["indices"], a["values"], a["local_rows"],
                         a["block_to_tile"].cpu(), facs, **kw)


@pytest.mark.parametrize("preset", ["paper", "optimized", "fused", "sorted"])
def test_als_on_card_matches_cpu(cuda, preset):
    """Ten sweeps on the card and on the CPU from the same seed: fits agree
    to 1e-4 (the card's grams and solve sum in another order)."""
    t = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    cfg = api.preset(preset, {"rank": 8, "kernel.autotune": False,
                              "runtime.tol": 0.0})
    plan = api.plan(t, cfg)
    fits = {d: api.compile(plan, cfg, device=d).run(10).fits
            for d in (cuda, "cpu")}
    np.testing.assert_allclose(fits[cuda], fits["cpu"], atol=1e-4)


def test_sorted_als_on_card_counts_launches(cuda):
    t = random_sparse((16, 12, 10), 300, seed=2, distribution="zipf")
    cfg = api.preset("sorted", {"rank": 4, "kernel.autotune": False,
                                "runtime.tol": 0.0})
    solver = api.compile(api.plan(t, cfg), cfg)
    _build.reset_launch_counts()
    solver.run(3)
    assert _build.LAUNCHES == {"ec_sorted": 9, "ec_fused": 0, "ec_blocked": 0}
