"""MTTKRP EC kernels: the plain PyTorch oracle (ref) and the hand-written
CUDA kernels for Hopper that replace the reference's three TPU kernels —
``ec_sorted`` (mttkrp_sorted), ``ec_fused`` (mttkrp_fused) and
``ec_blocked`` (mttkrp_blocked). Variant dispatch lives in ops; building
and binding the CUDA sources in _build. ``pinv`` holds the ALS solve's
pseudo-inverse kernel, which replaces ``torch.linalg.eigh`` on the card."""
from repro_torch.kernels.mttkrp_blocked import ec_blocked
from repro_torch.kernels.mttkrp_fused import ec_fused
from repro_torch.kernels.mttkrp_sorted import ec_sorted
from repro_torch.kernels.ops import (KERNEL_VARIANTS, mttkrp_local,
                                     resolve_variant)

__all__ = ["ec_blocked", "ec_fused", "ec_sorted", "mttkrp_local",
           "resolve_variant", "KERNEL_VARIANTS"]
