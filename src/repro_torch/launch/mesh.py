"""Production meshes, as descriptions.

The port's counterpart of the reference package's ``launch/mesh.py``. The
reference builds these meshes over 512 placeholder host devices, which its
dry-run creates with an XLA flag before JAX starts, and compiles every
cell against them. The port compiles nothing for a mesh: its dry-run
(``launch.dryrun``) runs each cell on tensors of the ``meta`` device and
reads the mesh only for its axis names and sizes, to place specs and to
divide the work per chip. So these meshes have no devices behind them:
:class:`DescMesh` holds ``axis_names``, a ``shape`` mapping and the
device count, which is all that ``models.sharding``,
``training.optimizer.zero1_specs`` and ``models.lm_serve.cache_specs``
read. A mesh whose logical devices really run (``models.ffn.moe_a2a`` on
the card) passes ``devices``.
"""
from __future__ import annotations

import math

__all__ = ["DescMesh", "make_production_mesh", "make_cp_production_mesh"]


class DescMesh:
    """A mesh description: axis names, sizes, and optionally one torch
    device per position in row-major order (``devices``; default none)."""

    def __init__(self, shape, axis_names, devices=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if len(self.shape) != len(tuple(shape)):
            raise ValueError(f"axis names {axis_names} for shape {shape}")
        self.devices = None if devices is None else list(devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def __repr__(self) -> str:
        return f"DescMesh({self.dims}, {self.axis_names})"


def make_production_mesh(*, multi_pod: bool = False) -> DescMesh:
    """(16,16)=("data","model") single pod; (2,16,16)=("pod","data","model")
    for 2 pods = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DescMesh(shape, axes)


def make_cp_production_mesh(*, multi_pod: bool = False,
                            replication: int = 16) -> DescMesh:
    """CP-ALS view of the same chips: ("group","sub") with |sub| =
    ``replication`` (the intra-group merge axis; 1 -> pure paper scheme).
    Total devices match the production mesh (256 / 512)."""
    total = 512 if multi_pod else 256
    if total % replication:
        raise ValueError(f"replication {replication} does not divide {total}")
    return DescMesh((total // replication, replication), ("group", "sub"))
