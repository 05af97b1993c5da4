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
before launching, the argument checks, and :func:`tile_runs`, the index
bookkeeping that gives each CUDA block its run of consecutive blocks of one
output tile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "SMEM_LIMIT", "MAX_NUM_BUFFERS", "LAUNCHES",
           "reset_launch_counts", "build", "kernel_function", "check",
           "check_blocking", "require", "launch_buffers", "tile_runs",
           "variant_smem_bytes", "cuda_stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# One shared library per source: ec_onehot.cu holds ec_fused and ec_blocked.
SOURCES = {"ec_sorted": "ec_sorted.cu", "ec_onehot": "ec_onehot.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one CUDA block may use on Hopper (227 KiB).
SMEM_LIMIT = 232_448
# The TPU kernels' DMA ring depth range (mttkrp_sorted.py:157-159), kept as
# the validated range of num_buffers.
MAX_NUM_BUFFERS = 4

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


def launch_buffers(variant: str, block_to_tile: torch.Tensor, *,
                   num_rows: int, tile: int, block_p: int, rank: int):
    """What every EC launch allocates: raise if the variant's shared memory
    per block exceeds :data:`SMEM_LIMIT`, then return the zeroed
    ``(num_rows, rank)`` f32 output (tiles no run visits stay 0), the tile
    runs and the shared-memory bytes to request."""
    smem = variant_smem_bytes(variant, tile=tile, block_p=block_p, rank=rank)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ec_{variant} needs {smem} B of shared memory per "
                         f"block (tile={tile}, block_p={block_p}, R={rank}); "
                         f"the limit is {SMEM_LIMIT}")
    out = torch.zeros((num_rows, rank), dtype=torch.float32,
                      device=block_to_tile.device)
    return out, tile_runs(block_to_tile), smem


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


def variant_smem_bytes(variant: str, *, tile: int, block_p: int,
                       rank: int) -> int:
    """Dynamic shared memory one CUDA block of the variant's kernel uses —
    the exact amount its wrapper requests at launch, checked against
    :data:`SMEM_LIMIT`. The counterpart of the reference's
    ``variant_vmem_bytes``.

    Every kernel stages one block's elementwise products ``E``
    (``block_p × rank`` f32). The one-hot kernels (``fused``, ``blocked``)
    add the ``(tile, rank)`` f32 tile accumulator and the block's
    ``row_in_tile`` slab (``block_p`` int32). ``sorted`` accumulates in
    registers and reads its segment descriptors from global memory. The
    gathered factor rows are never staged, so neither their count nor their
    dtype enters; ``ref`` launches no kernel and models as 0."""
    if variant == "ref":
        return 0
    e = block_p * rank * 4
    if variant == "sorted":
        return e
    if variant in ("fused", "blocked"):
        return e + tile * rank * 4 + block_p * 4
    raise ValueError(f"unknown EC variant {variant!r}")
