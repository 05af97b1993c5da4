"""Opt-in runtime lock assertions backing the ``# holds: <lock>`` lint
annotation (see :mod:`repro_torch.analysis.concurrency`); a copy of the
reference package's ``analysis/runtime.py``.

Methods whose contract is "caller holds lock X" call
``assert_holds(self._x, "_x")`` at entry. In production this is a no-op;
with ``AMPED_ANALYSIS_ASSERT_LOCKS=1`` (the test suite sets it around
targeted fixtures) it raises :class:`LockNotHeldError` when the contract
is violated.

Ownership detection is exact for ``threading.RLock``/``Condition`` (which
track their owner) and best-effort for plain ``threading.Lock`` (which has
no owner): a non-blocking acquire that *succeeds* proves nobody held the
lock — the bug class this guards against — while a held-by-another-thread
lock is indistinguishable from held-by-us and passes.
"""
from __future__ import annotations

import os
import threading

__all__ = ["ENV_ASSERT", "lock_assertions_enabled", "assert_holds",
           "LockNotHeldError"]

ENV_ASSERT = "AMPED_ANALYSIS_ASSERT_LOCKS"


class LockNotHeldError(AssertionError):
    pass


def lock_assertions_enabled() -> bool:
    return os.environ.get(ENV_ASSERT, "") not in ("", "0")


def _definitely_not_held(lock) -> bool:
    owned = getattr(lock, "_is_owned", None)
    if callable(owned):                      # RLock / Condition: exact
        return not owned()
    if lock.acquire(blocking=False):         # plain Lock: best effort
        lock.release()
        return True
    return False


def assert_holds(lock, name: str = "lock") -> None:
    if not lock_assertions_enabled():
        return
    if _definitely_not_held(lock):
        raise LockNotHeldError(
            f"method requires {name} held (see '# holds: {name}' "
            f"annotation); caller did not acquire it")
