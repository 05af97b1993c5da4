"""Backwards-compatibility shim over :mod:`repro_torch.comm`.

The counterpart of the reference package's ``core/exchange.py``: it keeps
the historical import surface (``core.exchange.ring_all_gather`` etc.); new
code imports :mod:`repro_torch.comm`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.comm import collectives as _collectives
from repro_torch.comm.collectives import (axis_size, merge_partials,
                                          ring_all_gather)

__all__ = ["ring_all_gather", "all_gather_axes", "merge_partials",
           "axis_size"]


def all_gather_axes(xs: Sequence[torch.Tensor], mesh, axis_names, *,
                    ring: bool = False) -> list[torch.Tensor]:
    """Historical signature: ``ring`` defaults to False (the plain
    all-gather) and the choice is NOT overridable by the
    ``AMPED_EXCHANGE_VARIANT`` environment variable. New code:
    :func:`repro_torch.comm.all_gather_axes`."""
    if ring:
        return _collectives.ring_all_gather(xs, mesh, axis_names)
    return _collectives.all_gather_axes(xs, mesh, axis_names,
                                        variant="allgather")
