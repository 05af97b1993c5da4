"""The environment of a benchmark process, set before torch is imported."""
from __future__ import annotations

import os
import sys
from pathlib import Path

__all__ = ["prepare"]


def prepare(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (only a
    checkout's first run builds), no tuner cache on disk (the cells fix
    their geometry), no JAX by proxy, and the checkout's ``src`` on the
    path."""
    cache = Path(root) / ".chipbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["AMPED_TORCH_AUTOTUNE_CACHE"] = ""
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(root), str(Path(root) / "src")]
