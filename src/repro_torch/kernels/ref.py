"""Plain PyTorch oracles for the MTTKRP elementwise computation (EC).

The counterpart of the reference package's ``kernels/ref.py``. These define
the semantics every EC kernel must match:

    out[row] += val * prod_{w != mode} F_w[idx_w, :]

with rows already local (padded ownership layout, see core/partition.py).

Accumulation order is *slot order*: ``e`` is formed as
``((val * rows_0) * rows_1) ...`` in f32 and added into its output row with
``index_add_`` in the order of the slots. On a CPU tensor ``index_add_``
walks the indices in order, so the result is bitwise that of the
reference's ``segment_sum`` (held by the tests). On a CUDA tensor
``index_add_`` uses atomics, whose order changes from run to run; there the
oracle is exact only to a tolerance.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ec_rows_ref", "mttkrp_local_ref", "mttkrp_dense_ref"]


def ec_rows_ref(values: torch.Tensor, gathered_rows: Sequence[torch.Tensor],
                local_rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """EC from already-gathered input rows.

    values: (nnz,); gathered_rows: list of (nnz, R); local_rows: (nnz,) ints
    in [0, num_rows). Returns (num_rows, R) f32 (padding entries have value 0
    → exact no-ops).
    """
    e = values.float()[:, None]
    for rows in gathered_rows:
        e = e * rows.float()
    out = torch.zeros((num_rows, e.shape[1]), dtype=torch.float32,
                      device=e.device)
    return out.index_add_(0, local_rows, e)


def mttkrp_local_ref(indices: torch.Tensor, values: torch.Tensor,
                     local_rows: torch.Tensor,
                     factors: Sequence[torch.Tensor], mode: int,
                     num_rows: int) -> torch.Tensor:
    """Gather + EC oracle. ``indices``: (nnz, N) in padded layouts;
    ``factors[w]``: (padded_w, R)."""
    gathered = [factors[w].index_select(0, indices[:, w])
                for w in range(len(factors)) if w != mode]
    return ec_rows_ref(values, gathered, local_rows, num_rows)


def mttkrp_dense_ref(dense: torch.Tensor, factors: Sequence[torch.Tensor],
                     mode: int) -> torch.Tensor:
    """Dense MTTKRP oracle (global layout): X_(d) (B ⊙ C ...) via einsum.
    Supports 3..5 modes."""
    n = dense.dim()
    letters = "ijklm"[:n]
    terms = [dense]
    spec_in = [letters]
    for w in range(n):
        if w == mode:
            continue
        terms.append(factors[w])
        spec_in.append(letters[w] + "r")
    spec = ",".join(spec_in) + "->" + letters[mode] + "r"
    return torch.einsum(spec, *terms)
