"""Partition-spec helpers for the LM cache and batch specs.

The port's copy of the spec helpers of the reference package's
``models/sharding.py`` that the serving functions need: :func:`dp_axes` and
:func:`batch_spec`. A spec is a tuple, one entry per dimension, normalised
as ``jax.sharding.PartitionSpec`` normalises its entries (an empty tuple
is ``None``, a 1-tuple is its one axis name), so ``tuple(P(...))`` of the
reference compares equal. A mesh is any object with ``axis_names`` and a
``shape`` mapping from axis name to size. The parameter rules
(``param_specs``, ``sanitize_specs``, ``make_shardings``) belong to the
multi-device slice.
"""
from __future__ import annotations

__all__ = ["spec", "dp_axes", "batch_spec"]


def spec(*entries) -> tuple:
    """A partition spec as a tuple, normalised like ``PartitionSpec``."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            if not e:
                return None
            return e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(mesh) -> tuple:
    return spec(dp_axes(mesh))
