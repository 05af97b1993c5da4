"""The arithmetic of the per-layer readers that read the port's spans.

The port's stages are ``torch.profiler`` scopes named like its spans
(``repro_torch.obs.trace``): in the traced window each stage's scope ends
in a synchronise of its cards, so the device work inside it is the
stage's; in the untraced window the scopes are bare host intervals, with
no synchronise added. Built on :mod:`chipbench.profile`; every function
returns ``None`` when the window holds no card's work or no scope of the
names it reads, so a program without the spans reports nothing.
"""
from __future__ import annotations

from chipbench import profile

__all__ = ["SWEEP", "scopes", "sweeps", "busiest_self_ns", "busiest_ns",
           "host_ns", "idle_ns_per_card", "runtime_calls"]

SWEEP = "sweep"
RUNTIME = frozenset({"cuda_runtime", "cuda_driver"})


def scopes(events, names) -> list[tuple[int, int]]:
    """The host intervals of the scopes whose name is one of ``names``."""
    return [iv for n in names for iv in profile.host_intervals(events, n)]


def sweeps(events) -> int:
    """The number of the port's ``sweep`` scopes in the window."""
    return len(profile.host_intervals(events, SWEEP))


def busiest_self_ns(events, name: str, minus=()) -> int | None:
    """ns of device work of the busiest card inside the scopes ``name``
    less the work inside the scopes ``minus`` (their children)."""
    outer, inner = scopes(events, (name,)), scopes(events, minus)
    found = profile.cards(events)
    if not outer or not found:
        return None
    return max(profile.busy_within(events, c, outer)
               - profile.busy_within(events, c, inner) for c in found)


def busiest_ns(events, names) -> int | None:
    """ns of device work of the busiest card inside the union of the
    scopes ``names``."""
    spans = scopes(events, names)
    found = profile.cards(events)
    if not spans or not found:
        return None
    return max(profile.busy_within(events, c, spans) for c in found)


def host_ns(events, name: str) -> int | None:
    """The summed host length of the scopes ``name``, where a card ran."""
    spans = scopes(events, (name,))
    if not spans or not profile.cards(events):
        return None
    return sum(b - a for a, b in spans)


def idle_ns_per_card(events, name: str) -> list[int] | None:
    """Per card, ns of the window inside the union of the scopes ``name``
    in which the card runs no work."""
    w0, w1 = profile.window(events)
    spans = profile.clip(scopes(events, (name,)), [(w0, w1)])
    found = profile.cards(events)
    if not spans or not found:
        return None
    total = sum(b - a for a, b in spans)
    return [total - profile.busy_within(events, c, spans) for c in found]


def runtime_calls(events, names) -> int | None:
    """The CUDA runtime and driver calls named one of ``names`` that begin
    inside a ``sweep`` scope."""
    spans = profile.merged(scopes(events, (SWEEP,)))
    if not spans or not profile.cards(events):
        return None
    return sum(1 for e in events
               if e.cat in RUNTIME and e.name in names
               and any(a <= e.t0 < b for a, b in spans))
