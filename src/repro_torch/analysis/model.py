"""Finding model shared by the three analysis passes (a copy of the
reference package's ``analysis/model.py``, so findings and baselines
compare one for one between the packages).

A :class:`Finding` is one rule violation: a stable rule id (``AP-*`` plan
rules, ``AH-*`` recorded-operation audit, ``AC-*`` concurrency lint), a severity, a
human-readable message, and a location string naming the offending
mode/device/block (plan rules), kernel/update (operation audit), or
``path:line`` (lint). Baselines — accepted pre-existing findings that
should not block CI — are keyed on ``(rule, location)``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Sequence

__all__ = ["Finding", "AnalysisError", "SEVERITIES", "errors", "warnings_",
           "format_findings", "baseline_key", "load_baseline",
           "save_baseline", "apply_baseline"]

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                # stable id, e.g. "AP-P003"
    severity: str            # "error" | "warning"
    message: str
    location: str = ""       # "mode=1 dev=2 block=17" / "path:line" / ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.rule} {self.severity.upper()}{loc}: {self.message}"


class AnalysisError(ValueError):
    """Raised by ``api.plan(..., analyze='strict')`` on error findings."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        super().__init__("static analysis failed:\n"
                         + format_findings(self.findings))


def errors(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]


def warnings_(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == "warning"]


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "no findings"
    return "\n".join(str(f) for f in findings)


# -- baselines ------------------------------------------------------------

def baseline_key(f: Finding) -> str:
    return f"{f.rule}|{f.location}"


def load_baseline(path) -> set[str]:
    """Read accepted findings from a JSON file:
    ``{"accepted": [{"rule": ..., "location": ...}, ...]}``."""
    with open(path) as fh:
        doc = json.load(fh)
    out = set()
    for row in doc.get("accepted", []):
        out.add(f"{row['rule']}|{row.get('location', '')}")
    return out


def save_baseline(path, findings: Sequence[Finding]) -> None:
    doc = {"accepted": [{"rule": f.rule, "location": f.location,
                         "message": f.message} for f in findings]}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply_baseline(findings: Sequence[Finding], accepted: set[str]
                   ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (kept, suppressed-by-baseline)."""
    kept, suppressed = [], []
    for f in findings:
        (suppressed if baseline_key(f) in accepted else kept).append(f)
    return kept, suppressed
