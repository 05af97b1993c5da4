"""Micro-batching request queue with admission control (a copy of the
reference package's ``serve/batcher.py``).

Individual reconstruction requests are tiny (a handful of coordinates);
dispatching each alone wastes the engine's batched kernels. The
:class:`MicroBatcher` coalesces concurrent requests into one device call:
a submit enqueues the request and blocks its caller; a single drain thread
collects everything queued (waiting up to ``max_delay_s`` for stragglers,
never beyond ``max_batch`` rows), runs the handler ONCE over the
concatenated coordinates, and scatters the per-request slices back.

Overload policy is reject-fast, not queue-forever: beyond ``max_depth``
queued requests a submit raises :class:`RejectedError` immediately, and a
request that waits past its deadline is failed with :class:`RejectedError`
instead of occupying the batch — bounded latency under overload is the
contract, unbounded queueing the failure mode this exists to prevent.
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from repro_torch.obs import clock
from repro_torch.serve.metrics import ServiceMetrics

__all__ = ["MicroBatcher", "RejectedError"]


class RejectedError(RuntimeError):
    """The service refused or abandoned the request (queue full, deadline
    exceeded, or shutdown) — retry later or shed load upstream."""


class _Pending:
    __slots__ = ("indices", "event", "result", "error", "deadline")

    def __init__(self, indices: np.ndarray, deadline: float | None):
        self.indices = indices
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.deadline = deadline


class MicroBatcher:
    """Admission-controlled micro-batching front of a batch handler.

    ``handler`` takes one ``(k, nmodes)`` int64 coordinate array and
    returns ``(k,)`` values (e.g. ``engine.reconstruct_batch``).
    """

    def __init__(self, handler: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 4096, max_delay_s: float = 0.002,
                 max_depth: int = 256, default_deadline_s: float = 1.0,
                 metrics: ServiceMetrics | None = None):
        if max_depth < 1 or max_batch < 1:
            raise ValueError("max_depth and max_batch must be >= 1")
        self.handler = handler
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_depth = int(max_depth)
        self.default_deadline_s = float(default_deadline_s)
        self.metrics = metrics or ServiceMetrics()
        self._cv = threading.Condition()
        self._queue: list[_Pending] = []  # guarded-by: _cv
        self._closed = False              # guarded-by: _cv
        self._thread = threading.Thread(target=self._drain_loop,
                                        daemon=True, name="microbatcher")
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, indices: np.ndarray, *,
               deadline_s: float | None = None) -> np.ndarray:
        """Enqueue one request and block until its slice of a batch
        returns. Raises :class:`RejectedError` when the queue is at
        ``max_depth``, the deadline passes first, or the batcher is
        closed; propagates handler exceptions (e.g. bounds errors)."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        indices = np.asarray(indices)
        req = _Pending(indices, clock.now() + deadline_s)
        with self._cv:
            if self._closed:
                raise RejectedError("service is shutting down")
            if len(self._queue) >= self.max_depth:
                self.metrics.inc("rejected_total")
                raise RejectedError(
                    f"queue at max depth {self.max_depth}; retry later")
            self._queue.append(req)
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self._cv.notify_all()
        if not req.event.wait(timeout=deadline_s):
            # still queued or mid-batch: the drain loop will discover the
            # expired deadline; the caller stops waiting either way
            self.metrics.inc("rejected_total")
            raise RejectedError(f"deadline {deadline_s:.3f}s exceeded")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        """Stop the drain thread; fail everything still queued with
        :class:`RejectedError`. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        # swap the queue out under the lock, then fail the stranded
        # requests without holding it (event.set wakes their callers)
        with self._cv:
            stranded, self._queue = self._queue, []
        for req in stranded:
            req.error = RejectedError("service is shutting down")
            req.event.set()
        self.metrics.set_gauge("queue_depth", 0)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- drain side --------------------------------------------------------
    def _take_batch(self) -> list[_Pending]:
        """Block for the first request, then linger up to ``max_delay_s``
        for more, capped at ``max_batch`` total rows."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed:
                return []
            linger_until = clock.now() + self.max_delay_s
            while True:
                rows = sum(r.indices.shape[0] for r in self._queue)
                left = linger_until - clock.now()
                if rows >= self.max_batch or left <= 0:
                    break
                self._cv.wait(timeout=left)
            batch, rows = [], 0
            while self._queue:
                nxt = self._queue[0].indices.shape[0]
                if batch and rows + nxt > self.max_batch:
                    break
                rows += nxt
                batch.append(self._queue.pop(0))
            self.metrics.set_gauge("queue_depth", len(self._queue))
            return batch

    def _drain_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed
            now = clock.now()
            live = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    req.error = RejectedError("deadline exceeded in queue")
                    req.event.set()
                    self.metrics.inc("deadline_dropped_total")
                else:
                    live.append(req)
            if not live:
                continue
            try:
                sizes = [r.indices.shape[0] for r in live]
                out = self.handler(np.concatenate(
                    [r.indices for r in live]))
                off = 0
                for req, k in zip(live, sizes):
                    req.result = out[off:off + k]
                    off += k
            except BaseException as e:
                for req in live:
                    req.error = e
            finally:
                self.metrics.inc("batches_total")
                self.metrics.inc("batched_requests_total", len(live))
                for req in live:
                    req.event.set()
