"""The process-wide clock pair every repro_torch module times against
(a copy of the reference package's ``obs/clock.py``).

Two clocks, two jobs:

* :func:`now` — monotonic high-resolution seconds (``time.perf_counter``).
  ALL durations and span timestamps in this repo come from this one clock,
  so a streamer build time, a rebalance probe and a trace span are directly comparable (and never jump under NTP slew).
* :func:`walltime` — epoch seconds (``time.time``), ONLY for values that
  must mean something outside this process (checkpoint manifests, snapshot
  ages, log lines). Never diff walltime to measure a duration.
"""
from __future__ import annotations

import time

__all__ = ["now", "walltime"]

# bound once so `from repro_torch.obs import clock; clock.now()` is one
# attribute lookup + one C call — cheap enough for per-window call sites
now = time.perf_counter
walltime = time.time
