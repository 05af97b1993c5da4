"""Build, bind and launch plumbing shared by the port's CUDA EC kernels.

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
splits the blocks among CUDA blocks: :func:`tile_runs` (one CUDA block per
run of consecutive blocks of one output tile, ``ec_blocked``) and
:func:`tile_chunks` (runs cut into work items of at most
:data:`CHUNK_BLOCKS` blocks, one warp each, ``ec_sorted``/``ec_fused``).
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

__all__ = ["SOURCES", "SMEM_LIMIT", "MAX_NUM_BUFFERS", "LAUNCHES",
           "reset_launch_counts", "build", "kernel_function", "check",
           "check_blocking", "require", "launch_buffers", "item_buffers",
           "tile_runs", "tile_chunks", "TileChunks", "CHUNK_BLOCKS",
           "STAGE_SLOTS", "ITEM_WARPS", "MAX_ITEM_RANK",
           "variant_smem_bytes", "copy_width", "cuda_stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# One shared library per source (ec_onehot.cu holds ec_blocked).
SOURCES = {"ec_sorted": "ec_sorted.cu", "ec_fused": "ec_fused.cu",
           "ec_onehot": "ec_onehot.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one CUDA block may use on Hopper (227 KiB).
SMEM_LIMIT = 232_448
# The TPU kernels' DMA ring depth range (mttkrp_sorted.py:157-159): the
# depth of the ec_sorted/ec_fused cp.async ring of gathered factor rows.
MAX_NUM_BUFFERS = 4
# Kernel blocks per work item of ec_sorted/ec_fused. A tile's run of more
# blocks is split into items of this many (the last may be shorter), whose
# partial sums ec_combine adds in item order: the bits of such a run depend
# on this number, so it is fixed, and never derived from the card. 16 keeps
# the smoke's hottest run (~27 k blocks) in ~1,700 items while an item
# still amortises its tile write-out over 2,048 slots at block_p 128.
CHUNK_BLOCKS = 16
# Mirrors of ec_common.cuh: slots per ring stage, warps (work items) per
# CUDA block, and the largest rank (columns per lane times 32).
STAGE_SLOTS = 8
ITEM_WARPS = 4
MAX_ITEM_RANK = 128

LAUNCHES = {"ec_sorted": 0, "ec_fused": 0, "ec_blocked": 0}

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
                       "the EC kernels are compiled at first use")


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


def cuda_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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


def _check_smem(variant: str, smem: int, geometry: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"ec_{variant} needs {smem} B of shared memory per "
                         f"block ({geometry}); the limit is {SMEM_LIMIT}")


def launch_buffers(variant: str, block_to_tile: torch.Tensor, *,
                   num_rows: int, tile: int, block_p: int, rank: int):
    """What an ``ec_blocked`` launch allocates: raise if its shared memory
    per block exceeds :data:`SMEM_LIMIT`, then return the zeroed
    ``(num_rows, rank)`` f32 output (tiles no run visits stay 0), the tile
    runs and the shared-memory bytes to request."""
    smem = variant_smem_bytes(variant, tile=tile, block_p=block_p, rank=rank)
    _check_smem(variant, smem, f"tile={tile}, block_p={block_p}, R={rank}")
    out = torch.zeros((num_rows, rank), dtype=torch.float32,
                      device=block_to_tile.device)
    return out, tile_runs(block_to_tile), smem


def item_buffers(variant: str, block_to_tile: torch.Tensor, *,
                 num_rows: int, tile: int, rank: int, nin: int,
                 num_buffers: int):
    """What an ``ec_sorted`` / ``ec_fused`` launch allocates: raise if the
    rank is above :data:`MAX_ITEM_RANK` or the shared memory per block
    exceeds :data:`SMEM_LIMIT`, then return the zeroed ``(num_rows, rank)``
    f32 output, the work items (:func:`tile_chunks`), the scratch buffer of
    ``(tile, rank)`` f32 partials of split runs (``torch.empty``: every
    partial the combine reads is written first) and the shared-memory
    bytes to request."""
    if rank > MAX_ITEM_RANK:
        raise ValueError(f"ec_{variant} takes R <= {MAX_ITEM_RANK}, got "
                         f"{rank}")
    smem = variant_smem_bytes(variant, tile=tile, block_p=0, rank=rank,
                              nin=nin, num_buffers=num_buffers)
    _check_smem(variant, smem, f"tile={tile}, R={rank}, nin={nin}, "
                f"num_buffers={num_buffers}")
    dev = block_to_tile.device
    out = torch.zeros((num_rows, rank), dtype=torch.float32, device=dev)
    chunks = tile_chunks(block_to_tile)
    partials = torch.empty((chunks.n_parts, tile, rank), dtype=torch.float32,
                           device=dev)
    return out, chunks, partials, smem


def tile_runs(block_to_tile: torch.Tensor) -> torch.Tensor:
    """Start block of every run of equal ``block_to_tile``: an
    ``(nblocks + 1,)`` int32 tensor whose first ``nruns`` entries are the
    runs' first blocks and whose remaining entries are ``nblocks``. So run
    ``i`` spans ``[starts[i], starts[i + 1])``, and ``starts[i] == nblocks``
    marks an index past the last run.

    Built with torch ops on the tensor's device and without a host sync:
    the grid is launched with ``nblocks`` CUDA blocks (an upper bound on the
    run count) and those past the last run return at once. By the partition
    contract (core/partition.py) the blocks of a tile are consecutive, so
    each visited tile is exactly one run."""
    nb = block_to_tile.numel()
    dev = block_to_tile.device
    starts = torch.full((nb + 1,), nb, dtype=torch.int32, device=dev)
    if nb == 0:
        return starts
    new = torch.ones(nb, dtype=torch.bool, device=dev)
    new[1:] = block_to_tile[1:] != block_to_tile[:-1]
    run_id = torch.cumsum(new, 0) - 1
    blocks = torch.arange(nb, dtype=torch.int32, device=dev)
    return starts.scatter_reduce_(0, run_id, blocks, reduce="amin",
                                  include_self=True)


class TileChunks(NamedTuple):
    """Work items of ``ec_sorted`` / ``ec_fused`` (see :func:`tile_chunks`).

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
    adds into the tile in item order.

    Built with torch ops on the tensor's device and without a host sync,
    as :func:`tile_runs` is: sizes are upper bounds (at most ``nblocks``
    items, fewer than ``nblocks / chunk_blocks`` split runs, and fewer than
    ``2 * nblocks / chunk_blocks`` partials, since a split run of ``L >
    chunk_blocks`` blocks has ``ceil(L / chunk_blocks) < 2 L /
    chunk_blocks`` of them), and entries past the last are marked."""
    nb = block_to_tile.numel()
    dev = block_to_tile.device
    i32 = torch.int32
    n_split, n_parts = nb // chunk_blocks, (2 * nb) // chunk_blocks
    item_starts = torch.full((nb + 1,), nb, dtype=i32, device=dev)
    item_part = torch.full((nb,), -1, dtype=i32, device=dev)
    split = torch.full((3, n_split + 1), -1, dtype=i32, device=dev)
    if nb == 0:
        return TileChunks(item_starts, item_part, split[:, :n_split], n_parts)
    runs = tile_runs(block_to_tile).long()
    new = torch.ones(nb, dtype=torch.bool, device=dev)
    new[1:] = block_to_tile[1:] != block_to_tile[:-1]
    run_id = torch.cumsum(new, 0) - 1
    blocks = torch.arange(nb, dtype=torch.int64, device=dev)
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


def variant_smem_bytes(variant: str, *, tile: int, block_p: int,
                       rank: int, nin: int | None = None,
                       num_buffers: int | None = None) -> int:
    """Dynamic shared memory one CUDA block of the variant's kernel uses —
    the exact amount its wrapper requests at launch, checked against
    :data:`SMEM_LIMIT`. The counterpart of the reference's
    ``variant_vmem_bytes``.

    ``sorted`` and ``fused`` (``nin`` and ``num_buffers`` required;
    ``block_p`` does not enter) run :data:`ITEM_WARPS` work items per CUDA
    block, each warp owning a region of 4-byte words, every part rounded up
    to 16 bytes: the ``cp.async`` ring of ``num_buffers`` stages of
    :data:`STAGE_SLOTS` slots, each slot's ``nin`` gathered f32 factor rows
    of ``rank``; the stages' values; per stage its slots' ``row_in_tile``
    (``fused``) or per in-flight block its ``2·tile + 3`` segment
    descriptor words (``sorted``); and the ``(tile, rank)`` f32 tile
    accumulator. ``blocked`` stages one block's products ``E`` (``block_p ×
    rank`` f32), the ``(tile, rank)`` accumulator and the block's
    ``row_in_tile`` slab (``block_p`` int32). ``ref`` launches no kernel
    and models as 0."""
    if variant == "ref":
        return 0
    if variant == "blocked":
        return block_p * rank * 4 + tile * rank * 4 + block_p * 4
    if variant not in ("sorted", "fused"):
        raise ValueError(f"unknown EC variant {variant!r}")
    if nin is None or num_buffers is None:
        raise ValueError(f"ec_{variant}'s shared memory depends on nin and "
                         f"num_buffers")

    def words16(n):
        return -(-n // 4) * 4

    meta = (num_buffers * STAGE_SLOTS if variant == "fused"
            else num_buffers * (2 * tile + 3))
    warp_words = (words16(num_buffers * STAGE_SLOTS * nin * rank)
                  + words16(num_buffers * STAGE_SLOTS) + words16(meta)
                  + words16(tile * rank))
    return ITEM_WARPS * warp_words * 4
