"""Build, bind and launch plumbing shared by the port's CUDA kernels: the
three EC kernels and the ALS solve's pseudo-inverse (``pinv_psd``).

Each source under ``csrc/`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. Libraries are keyed by a digest of the sources and flags, so an
edited kernel never loads a stale build, and land in ``build/`` beside this
file (listed in ``.gitignore``). :func:`build` compiles several sources in
parallel, one ``nvcc`` process each.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0, since a
refused launch never runs and a later synchronise would not report it.

Also here: the launch counters (one plain int per kernel, raised by the
wrapper where it launches), the shared-memory model the wrappers check
before launching, the argument checks, and the index bookkeeping that
splits the blocks among warps: :func:`tile_chunks` cuts each run of
consecutive blocks of one output tile into work items of at most
:data:`CHUNK_BLOCKS` blocks, one warp each, for all three kernels;
:func:`pack_items` puts those items in the one int32 tensor a placed shard
carries (:func:`item_views` reads it back), which every launch is given,
and :func:`count_items` counts those launches; :func:`walked_slots` counts
the slots those items walk, :func:`step_slots` the lane-group positions of
the steps ``ec_sorted``'s kernel walks them in, and :func:`split_slots` the
slots and partials of the runs they split.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import obs

__all__ = ["SOURCES", "SMEM_LIMIT", "MAX_NUM_BUFFERS", "LAUNCHES",
           "reset_launch_counts", "build", "kernel_function", "check",
           "check_blocking", "require", "item_buffers",
           "tile_chunks", "TileChunks", "pack_items",
           "item_words", "item_views", "count_items", "walked_slots",
           "step_slots", "step_width", "split_slots", "CHUNK_BLOCKS",
           "STAGE_SLOTS", "STEP_FLOATS", "ITEM_WARPS", "MAX_ITEM_RANK",
           "variant_smem_bytes", "copy_width", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# One shared library per source.
SOURCES = {"ec_sorted": "ec_sorted.cu", "ec_fused": "ec_fused.cu",
           "ec_blocked": "ec_blocked.cu", "pinv_psd": "pinv_psd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one CUDA block may use on Hopper (227 KiB).
SMEM_LIMIT = 232_448
# The TPU kernels' DMA ring depth range (mttkrp_sorted.py:157-159): the
# depth of the one-hot item kernel's cp.async ring of input rows, and the
# steps ec_sorted's kernel keeps its loads ahead in registers.
MAX_NUM_BUFFERS = 4
# Kernel blocks per work item of the EC kernels. A tile's run of more
# blocks is split into items of this many (the last may be shorter), whose
# partial sums ec_combine adds in item order: the bits of such a run depend
# on this number, so it is fixed, and never derived from the card. 16 keeps
# the smoke's hottest run (~27 k blocks) in ~1,700 items while an item
# still amortises its tile write-out over 2,048 slots at block_p 128.
CHUNK_BLOCKS = 16
# Mirrors of ec_common.cuh: slots per ring stage of the one-hot item kernel,
# warps (work items) per CUDA block, and the largest rank (columns per lane
# times 32); and of ec_sorted.cu: the floats of a step's staging row.
STAGE_SLOTS = 8
ITEM_WARPS = 4
MAX_ITEM_RANK = 128
STEP_FLOATS = 128

LAUNCHES = {"ec_sorted": 0, "ec_fused": 0, "ec_blocked": 0, "pinv_psd": 0}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are compiled at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SOURCES[name]] + sorted(p.name for p in CSRC.glob("*.cuh")):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every named source that has no current build, all ``nvcc``
    processes started together; return each source's compiler log (the
    ``-Xptxas -v`` register, shared-memory and spill lines). Raises
    ``RuntimeError`` with the compiler output if any build fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name]} exited {proc.returncode}:\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        for name in procs:
            _LOGS.pop(name, None)
        raise RuntimeError("\n".join(failed))
    return {n: _LOGS.get(n, "(built earlier)") for n in names}


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _build_locked((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            lib.ec_error_string.argtypes = [ctypes.c_int]
            lib.ec_error_string.restype = ctypes.c_char_p
        return lib


def kernel_function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of source ``name``, built on first use,
    with its ``argtypes`` declared (pointers and the stream as
    ``c_void_p``) and an ``int`` (``cudaError_t``) result."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str, kernel: str) -> None:
    if err != 0:
        msg = _library(name).ec_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} "
                           f"({msg})")


def copy_width(factors) -> int:
    """Floats per ``cp.async`` of a factor row: 4 (16 bytes) where every
    row starts on a 16-byte boundary, else 1."""
    rank = factors[0].shape[-1]
    ok = rank % 4 == 0 and all(f.data_ptr() % 16 == 0 for f in factors)
    return 4 if ok else 1


def launch(name: str, symbol: str, argtypes, device: torch.device,
           *args) -> None:
    """Call the C entry point ``symbol`` of source ``name`` with ``args``
    and the current stream of ``device``, with ``device`` made the
    thread's current device for the call (the entry point launches on the
    current device, which need not be the tensors'); raise if the launch
    failed, else count it in :data:`LAUNCHES`."""
    fn = kernel_function(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name, name)
    LAUNCHES[name] += 1


def check_blocking(nnz: int, *, num_rows: int, tile: int, block_p: int,
                   num_buffers: int | None = None) -> None:
    """The block-layout geometry every EC kernel takes, as the TPU wrappers
    check it: whole blocks of ``block_p`` slots, whole tiles of output rows,
    and ``num_buffers`` (where the kernel takes one) in [2, 4]."""
    if nnz % block_p:
        raise ValueError(f"nnz={nnz} is not a multiple of block_p={block_p}")
    if num_rows % tile:
        raise ValueError(f"num_rows={num_rows} is not a multiple of "
                         f"tile={tile}")
    if num_buffers is not None and not 2 <= num_buffers <= MAX_NUM_BUFFERS:
        raise ValueError(f"num_buffers must be in [2, {MAX_NUM_BUFFERS}], "
                         f"got {num_buffers}")


def require(t, name: str, *, shape, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` with a dtype
    in ``dtypes`` on ``device``: the kernels take raw pointers and trust
    nothing else about them."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def item_buffers(variant: str, block_to_tile: torch.Tensor, *,
                 num_rows: int, tile: int, rank: int, nin: int,
                 num_buffers: int, items: torch.Tensor):
    """What an EC kernel launch allocates: raise if the rank is above
    :data:`MAX_ITEM_RANK` or the shared memory per block exceeds
    :data:`SMEM_LIMIT`, then return the zeroed ``(num_rows, rank)``
    f32 output, the work items (views of ``items``, :func:`pack_items` of
    this ``block_to_tile`` as its placed shard carries them), the scratch
    buffer of ``(tile, rank)`` f32 partials of split runs (``torch.empty``:
    every partial the combine reads is written first) and the
    shared-memory bytes to request."""
    if rank > MAX_ITEM_RANK:
        raise ValueError(f"ec_{variant} takes R <= {MAX_ITEM_RANK}, got "
                         f"{rank}")
    smem = variant_smem_bytes(variant, tile=tile, rank=rank, nin=nin,
                              num_buffers=num_buffers)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ec_{variant} needs {smem} B of shared memory per "
                         f"block (tile={tile}, R={rank}, nin={nin}, "
                         f"num_buffers={num_buffers}); the limit is "
                         f"{SMEM_LIMIT}")
    dev = block_to_tile.device
    out = torch.zeros((num_rows, rank), dtype=torch.float32, device=dev)
    chunks = item_views(items, block_to_tile.numel())
    partials = torch.empty((chunks.n_parts, tile, rank), dtype=torch.float32,
                           device=dev)
    return out, chunks, partials, smem


class TileChunks(NamedTuple):
    """Work items of the EC kernels (see :func:`tile_chunks`).

    ``item_starts``: ``(nblocks + 1,)`` int32; item ``i`` spans blocks
    ``[item_starts[i], item_starts[i + 1])`` and ``item_starts[i] ==
    nblocks`` marks an index past the last item. ``item_part``:
    ``(nblocks,)`` int32, ``-1`` for an item that is a whole run (it writes
    its tile), else the index of its ``(tile, R)`` partial. ``split``:
    ``(3, n_split)`` int32, per split run its first partial, its number of
    partials and its tile, ``-1`` past the last split run. ``n_parts`` is
    the host-side bound on the partial count that sizes the scratch."""
    item_starts: torch.Tensor
    item_part: torch.Tensor
    split: torch.Tensor
    n_parts: int


def tile_chunks(block_to_tile: torch.Tensor,
                chunk_blocks: int = CHUNK_BLOCKS) -> TileChunks:
    """Cut every run of equal ``block_to_tile`` into work items of at most
    ``chunk_blocks`` consecutive blocks, in order. A run of at most
    ``chunk_blocks`` blocks is one item, which writes its tile directly; a
    longer run is split, each item writing a partial that ``ec_combine``
    adds into the tile in item order. By the partition contract
    (core/partition.py) the blocks of a tile are consecutive, so each
    visited tile is exactly one run.

    Built with torch ops on the tensor's device and without a host sync:
    sizes are upper bounds (at most ``nblocks`` items, fewer than ``nblocks
    / chunk_blocks`` split runs, and fewer than ``2 * nblocks /
    chunk_blocks`` partials, since a split run of ``L > chunk_blocks``
    blocks has ``ceil(L / chunk_blocks) < 2 L / chunk_blocks`` of them),
    and entries past the last are marked."""
    nb = block_to_tile.numel()
    dev = block_to_tile.device
    i32 = torch.int32
    n_split, n_parts = nb // chunk_blocks, (2 * nb) // chunk_blocks
    item_starts = torch.full((nb + 1,), nb, dtype=i32, device=dev)
    item_part = torch.full((nb,), -1, dtype=i32, device=dev)
    split = torch.full((3, n_split + 1), -1, dtype=i32, device=dev)
    if nb == 0:
        return TileChunks(item_starts, item_part, split[:, :n_split], n_parts)
    # the runs: each block's run, and each run's first block (then nb)
    new = torch.ones(nb, dtype=torch.bool, device=dev)
    new[1:] = block_to_tile[1:] != block_to_tile[:-1]
    run_id = torch.cumsum(new, 0) - 1
    blocks = torch.arange(nb, dtype=torch.int64, device=dev)
    runs = torch.full((nb + 1,), nb, dtype=torch.int64, device=dev)
    runs.scatter_reduce_(0, run_id, blocks, reduce="amin", include_self=True)
    pos = blocks - runs[run_id]
    length = (runs[1:] - runs[:-1])[run_id]
    is_split = length > chunk_blocks
    item_first = pos % chunk_blocks == 0
    item_id = torch.cumsum(item_first, 0) - 1
    item_starts.scatter_reduce_(0, item_id, blocks.to(i32), reduce="amin",
                                include_self=True)
    # the partial index is constant over an item's blocks: amax of equal
    # values is deterministic
    part_id = torch.cumsum(item_first & is_split, 0) - 1
    item_part.scatter_reduce_(
        0, item_id, torch.where(is_split, part_id, -1).to(i32),
        reduce="amax", include_self=True)
    run_first = (pos == 0) & is_split
    col = torch.where(run_first, torch.cumsum(run_first, 0) - 1, n_split)
    for k, v in enumerate((part_id, (length + chunk_blocks - 1)
                           // chunk_blocks, block_to_tile.long())):
        split[k].scatter_reduce_(0, col, v.to(i32), reduce="amax",
                                 include_self=True)
    return TileChunks(item_starts, item_part,
                      split[:, :n_split].contiguous(), n_parts)


def item_words(nblocks: int) -> int:
    """Length of :func:`pack_items`' tensor for ``nblocks`` blocks."""
    return 2 * nblocks + 1 + 3 * (nblocks // CHUNK_BLOCKS)


def pack_items(block_to_tile: torch.Tensor) -> torch.Tensor:
    """:func:`tile_chunks` of ``block_to_tile`` in one int32 tensor of
    :func:`item_words` entries: ``item_starts``, then ``item_part``, then
    ``split`` row by row. A placed shard carries it, computed once on the
    host (CPU torch gives the card's integers: ``amin``/``amax`` over ints
    is deterministic), so a launch reads its items instead of building
    them; :func:`item_views` takes it apart."""
    c = tile_chunks(block_to_tile)
    return torch.cat([c.item_starts, c.item_part, c.split.reshape(-1)])


def item_views(items: torch.Tensor, nblocks: int) -> TileChunks:
    """The :class:`TileChunks` of :func:`pack_items`' tensor for
    ``nblocks`` blocks: contiguous views of a contiguous ``items``, nothing
    copied."""
    return TileChunks(items[:nblocks + 1], items[nblocks + 1:2 * nblocks + 1],
                      items[2 * nblocks + 1:].view(3, nblocks // CHUNK_BLOCKS),
                      (2 * nblocks) // CHUNK_BLOCKS)


def count_items(items: torch.Tensor, nblocks: int,
                device: torch.device) -> None:
    """Raise unless ``items`` is a packed work-item tensor for ``nblocks``
    blocks on ``device`` (:func:`pack_items`), then count one EC launch
    given its shard's placed items in the global registry
    (``ec.items.placed``). Every ``ec_<variant>`` call does, on the CPU
    too, whose plain version needs no items."""
    require(items, "items", shape=(item_words(nblocks),),
            dtypes=(torch.int32,), device=device)
    obs.get_registry().inc("ec.items.placed")


def _item_walks(values: torch.Tensor, chunks: TileChunks,
                block_p: int) -> torch.Tensor:
    """Per work item (``chunks``, the shard's :func:`item_views`), the
    slots up to and including its last slot whose value is not 0: its
    earlier blocks in full, then its last such block's slots up to that
    one; 0 for an item whose values are all 0."""
    nb = chunks.item_part.numel()
    if nb == 0:
        return torch.zeros(0, dtype=torch.int64)
    nz = values[:nb * block_p].reshape(nb, block_p) != 0
    # each block's last slot that is not 0
    last = block_p - 1 - nz.flip(1).to(torch.uint8).argmax(1)
    starts = chunks.item_starts.long()
    first = torch.zeros(nb + 1, dtype=torch.int64, device=nz.device)
    first[starts] = 1
    item_id = torch.cumsum(first[:nb], 0) - 1
    blocks = torch.arange(nb, device=nz.device)
    # were the item to end in this block: its earlier blocks in full, then
    # this block up to its last nonzero
    walk = torch.where(nz.any(1),
                       (blocks - starts[item_id]) * block_p + last + 1, 0)
    per_item = torch.zeros(nb, dtype=torch.int64, device=nz.device)
    per_item.scatter_reduce_(0, item_id, walk, reduce="amax",
                             include_self=True)
    return per_item


def walked_slots(values: torch.Tensor, chunks: TileChunks,
                 block_p: int) -> int:
    """The slots ``ec_sorted``'s kernel walks on one shard, by its own rule
    (``csrc/ec_sorted.cu``): each work item (``chunks``, the shard's
    :func:`item_views`) walks its slots up to and including its last slot
    whose value is not 0, and none after it; an item whose values are all 0
    walks none. (The one-hot variants' kernel walks on to the end of that
    slot's stage of :data:`STAGE_SLOTS`.) Pad slots, value 0, lie at the end
    of a tile's run; a zero value before a run's last nonzero is walked.
    Plain torch ops on the tensors' device, ending in a host read: for
    placement, not for a sweep."""
    return int(_item_walks(values, chunks, block_p).sum())


def step_width(rank: int) -> int:
    """The slots one step of ``ec_sorted``'s kernel takes, one a lane
    group: a lane holds 4 columns of a factor row where ``rank % 4 == 0``
    (the 16-byte rows :func:`copy_width` finds on placed factors), else
    one, so a group is ``rank / 4`` or ``min(rank, 32)`` lanes and a warp
    of 32 holds ``32 // group`` of them: 4 at rank 32, 2 at 64, 1 at
    128."""
    if not 1 <= rank <= MAX_ITEM_RANK:
        raise ValueError(f"ec_sorted takes R in [1, {MAX_ITEM_RANK}], got "
                         f"{rank}")
    return 32 // (rank // 4 if rank % 4 == 0 else min(rank, 32))


def step_slots(values: torch.Tensor, chunks: TileChunks, block_p: int,
               rank: int) -> int:
    """The lane-group positions of the steps ``ec_sorted``'s kernel runs on
    one shard, by its own rule: each work item walks its
    :func:`walked_slots` in steps of :func:`step_width` slots, the last step
    of an item as wide as the others. So ``walked_slots / step_slots`` is
    the share of the steps' lane groups that hold a slot. Plain torch ops
    ending in a host read: for placement, not for a sweep."""
    g = step_width(rank)
    return int(((_item_walks(values, chunks, block_p) + g - 1) // g * g)
               .sum())


def split_slots(chunks: TileChunks, block_p: int) -> tuple[int, int]:
    """``(slots, partials)`` of the split path on one shard, by
    :func:`tile_chunks`' own rule, read from its work items ``chunks`` (the
    shard's :func:`item_views`): the placed slots whose block lies in a run
    of more than :data:`CHUNK_BLOCKS` blocks (pad slots included, as the
    kernel's launch holds them), and the ``(tile, R)`` partials the launch
    writes, one per work item of such a run (``TileChunks.n_parts`` is only
    their bound). Plain torch ops ending in a host read: for placement,
    not for a sweep."""
    starts = chunks.item_starts.long()
    parted = chunks.item_part >= 0
    blocks = (starts[1:] - starts[:-1])[parted]
    return int(blocks.sum()) * block_p, int(parted.sum())


def variant_smem_bytes(variant: str, *, tile: int, rank: int,
                       nin: int | None = None,
                       num_buffers: int | None = None) -> int:
    """Dynamic shared memory one CUDA block of the variant's kernel uses —
    the exact amount its wrapper requests at launch, checked against
    :data:`SMEM_LIMIT`. The counterpart of the reference's
    ``variant_vmem_bytes``.

    Every kernel variant (``nin`` and ``num_buffers`` required) runs
    :data:`ITEM_WARPS` work items per CUDA block, each warp owning a region
    of 4-byte words, every part rounded up to 16 bytes. ``fused`` and
    ``blocked``: the ``cp.async`` ring of ``num_buffers`` stages of
    :data:`STAGE_SLOTS` slots, each slot's ``nin`` f32 input rows of
    ``rank`` (factor rows gathered in the kernel, or for ``blocked`` the
    pre-gathered rows, bf16 ones cast to f32 before the launch), the stages'
    values and per stage its slots' ``row_in_tile``; no index word is
    staged (a stage's indices live in registers, and ``blocked`` has none).
    ``sorted`` keeps its loads in registers: two staging rows of
    :data:`STEP_FLOATS` f32 for a step's products and a ring of two blocks'
    ``2·tile + 3`` segment descriptor words, whatever ``nin`` and
    ``num_buffers``. Each ends in the ``(tile, rank)`` f32 tile
    accumulator. ``ref`` launches no kernel and models as 0."""
    if variant == "ref":
        return 0
    if variant not in ("sorted", "fused", "blocked"):
        raise ValueError(f"unknown EC variant {variant!r}")
    if nin is None or num_buffers is None:
        raise ValueError(f"ec_{variant}: variant_smem_bytes takes nin and "
                         f"num_buffers for every kernel variant")

    def words16(n):
        return -(-n // 4) * 4

    if variant == "sorted":
        warp_words = (words16(tile * rank) + 2 * STEP_FLOATS
                      + words16(2 * (2 * tile + 3)))
    else:
        warp_words = (words16(num_buffers * STAGE_SLOTS * nin * rank)
                      + 2 * words16(num_buffers * STAGE_SLOTS)
                      + words16(tile * rank))
    return ITEM_WARPS * warp_words * 4
