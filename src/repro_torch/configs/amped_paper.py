"""The paper's own experimental configuration (§5.1), as API presets.

The port's copy of the reference package's ``configs/amped_paper.py`` (its
CP configuration only). Datasets: the four public billion-scale tensors
(Table 3) — profiles in :data:`repro_torch.sparse.io.DATASET_PROFILES`.
Rank R=32, threadblock P(θ)=32 (the kernels' block_p defaults scale this
up), 4 devices on one node.

:func:`paper_config` pins those paper constants onto a named
:mod:`repro_torch.api` preset::

    cfg = paper_config("paper")       # the §5.1 configuration
    cfg = paper_config("fused")       # beyond-paper fused EC + autotune

The ``paper_setup``/``optimized_setup``/``fused_setup`` helpers are
deprecated shims: they take the historical ``PaperRun`` field names as
keyword overrides (``num_devices=``, ``use_kernel=``, ``kernel_variant=``,
...) and return :class:`repro_torch.api.DecomposeConfig` objects.
"""
from __future__ import annotations

import warnings
from typing import Any, Mapping

from repro_torch.api.config import DecomposeConfig, preset as _preset
from repro_torch.sparse.io import DATASET_PROFILES

__all__ = ["RANK", "PAPER_DEVICES", "paper_config",
           "paper_setup", "optimized_setup", "fused_setup"]

RANK = 32
PAPER_DEVICES = 4


def paper_config(name: str = "paper",
                 overrides: Mapping[str, Any] | None = None,
                 ) -> DecomposeConfig:
    """A :mod:`repro_torch.api` preset with the paper's rank/device
    constants applied. ``name`` is ``"paper" | "optimized" | "fused"``;
    ``overrides`` are dotted-path overrides applied last."""
    cfg = _preset(name, {"rank": RANK, "runtime.num_devices": PAPER_DEVICES})
    return cfg.with_overrides(overrides or {})


# historical PaperRun field → dotted DecomposeConfig path
_LEGACY_FIELDS = {
    "rank": "rank",
    "num_devices": "runtime.num_devices",
    "strategy": "partition.strategy",
    "replication": "partition.replication",
    "ring": "exchange.ring",
    "use_kernel": "kernel.use_kernel",
    "kernel_variant": "kernel.variant",
    "num_buffers": "kernel.num_buffers",
    "autotune": "kernel.autotune",
}


def _deprecated_setup(name: str, profile: str,
                      overrides: Mapping[str, Any]) -> DecomposeConfig:
    warnings.warn(
        f"{name}_setup() is deprecated; use "
        f"repro_torch.configs.amped_paper.paper_config({name!r}) or "
        f"repro_torch.api.preset({name!r})", DeprecationWarning,
        stacklevel=3)
    if profile not in DATASET_PROFILES:
        raise ValueError(f"unknown dataset profile {profile!r}; expected "
                         f"one of {sorted(DATASET_PROFILES)}")
    mapped = {_LEGACY_FIELDS.get(k, k): v for k, v in overrides.items()}
    return paper_config(name, mapped)


def paper_setup(profile: str = "amazon", **overrides) -> DecomposeConfig:
    """Deprecated: use :func:`paper_config`. ``overrides`` take the old
    ``PaperRun`` field names (or dotted config paths)."""
    return _deprecated_setup("paper", profile, overrides)


def optimized_setup(profile: str = "amazon", **overrides) -> DecomposeConfig:
    """Deprecated: use ``paper_config("optimized")``."""
    return _deprecated_setup("optimized", profile, overrides)


def fused_setup(profile: str = "amazon", **overrides) -> DecomposeConfig:
    """Deprecated: use ``paper_config("fused")``."""
    return _deprecated_setup("fused", profile, overrides)
