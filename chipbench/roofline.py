"""The card's published peaks and the least work an MTTKRP sweep needs.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W power limit:
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.

The work is counted from the tensor, never from a kernel's layout: per
mode, every nonzero's coordinates (int32 each) and value (float32) read
once, each row of the other modes' factors that some nonzero gathers read
once, and the whole output factor written once (float32 rows of
``rank``), and ``nmodes * rank`` operations a nonzero (the value times
``nmodes - 1`` rows, and the add into the output).
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "ec_sweep_work",
           "ec_sweep_bound_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def ec_sweep_work(shape, rows_used, nnz: int, rank: int) -> tuple[int, int]:
    """(bytes, operations) of the EC of one sweep over every mode, where
    ``rows_used[m]`` rows of mode ``m`` hold a nonzero."""
    n = len(shape)
    nbytes = sum(nnz * (4 * n + 4)
                 + 4 * rank * (sum(rows_used) - rows_used[d] + shape[d])
                 for d in range(n))
    return nbytes, n * nnz * n * rank


def ec_sweep_bound_s(shape, rows_used, nnz: int, rank: int, cards: int = 1
                     ) -> tuple[float, str]:
    """The least time ``cards`` cards could take for one sweep's EC, and
    which side bounds it (``"bytes"`` or ``"flops"``)."""
    nbytes, flops = ec_sweep_work(shape, rows_used, nnz, rank)
    t_bytes = nbytes / (cards * HBM_BYTES_PER_S)
    t_flops = flops / (cards * FP32_FLOPS_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
