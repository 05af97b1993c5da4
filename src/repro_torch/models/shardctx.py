"""Scoped sharding hints for mesh-agnostic model code.

The port's copy of the reference package's ``models/shardctx.py``.
Launch and serving code installs named hints around a call, and layers read
them with :func:`get` or apply them with :func:`constrain`. The port runs
one controller over one device per model, so there is no compiler that
would re-shard a tensor: :func:`constrain` returns its input unchanged, and
no GSPMD counterpart is claimed. The hints themselves are kept, so the
multi-device slice can read them (``Model._ffn`` reads ``moe_axes``).
"""
from __future__ import annotations

import contextlib
import contextvars

_HINTS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_shard_hints", default={})


@contextlib.contextmanager
def hints(**kw):
    token = _HINTS.set({**_HINTS.get(), **kw})
    try:
        yield
    finally:
        _HINTS.reset(token)


def get(name: str):
    return _HINTS.get().get(name)


def constrain(x, name: str):
    """The identity: on one controller nothing re-shards ``x``."""
    return x
