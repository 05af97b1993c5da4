"""AST-based lock-discipline lint (the ``AC-*`` pass).

A copy of the reference package's ``analysis/concurrency.py`` whose default
targets are the port's own thread-using modules (``sparse/stream.py``,
``serve/batcher.py``, ``training/checkpoint.py``, ``obs/metrics.py``,
``obs/trace.py`` under ``src/repro_torch``). Annotation convention:

- ``self.attr = ...  # guarded-by: _lock`` on the assignment line declares
  ``self.attr`` guarded by ``self._lock``. Every later read or write of
  ``self.attr`` in any method of the class (or a subclass in the same
  module) must be lexically inside ``with self._lock:`` — or in a method
  whose ``def`` line carries ``# holds: _lock``, promising the caller
  acquired it (backed at runtime by
  :func:`repro_torch.analysis.runtime.assert_holds`).
- ``__init__`` is exempt: construction happens-before publication.
- Nested functions (closures handed to executors/threads) start with an
  empty lock set — a ``with`` in the enclosing method does not protect
  code that runs later on another thread.

Rules: AC-L000 unparseable target (error), AC-L001 unguarded access
(error), AC-L002 ``guarded-by`` names an unknown lock (error), AC-L003
``holds`` names an unknown lock (error). AC-L004 is reserved.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Optional

from repro_torch.analysis.model import Finding

__all__ = ["DEFAULT_TARGETS", "lint_file", "lint_source",
           "lint_default_targets"]

# module files under src/repro_torch the sweep lints by default
DEFAULT_TARGETS = ("sparse/stream.py", "serve/batcher.py",
                   "training/checkpoint.py", "obs/metrics.py",
                   "obs/trace.py")

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][\w,\s]*)")


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.guards: dict[str, str] = {}      # attr -> lock
        self.assigned: set[str] = set()       # every self.X ever assigned


def _collect_class(node: ast.ClassDef, lines: list[str]) -> _ClassInfo:
    info = _ClassInfo(node)
    guard_lines = {}
    lo = node.lineno
    hi = max((getattr(n, "end_lineno", None) or n.lineno
              for n in ast.walk(node) if hasattr(n, "lineno")),
             default=node.lineno)
    for ln in range(lo, min(hi, len(lines)) + 1):
        m = _GUARDED_RE.search(lines[ln - 1])
        if m:
            guard_lines[ln] = m.group(1)
    for sub in ast.walk(node):
        targets = []
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
            targets = [sub.target]
        for tgt in targets:
            attr = _self_attr(tgt)
            if attr is None:
                continue
            info.assigned.add(attr)
            lock = guard_lines.get(tgt.lineno)
            if lock is not None:
                info.guards[attr] = lock
    return info


def _holds_locks(fn: ast.FunctionDef, lines: list[str]) -> set[str]:
    end = fn.body[0].lineno if fn.body else fn.lineno
    out: set[str] = set()
    for ln in range(fn.lineno, end + 1):
        if ln - 1 >= len(lines):
            break
        m = _HOLDS_RE.search(lines[ln - 1])
        if m:
            out.update(x.strip() for x in m.group(1).split(",")
                       if x.strip())
    return out


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, path, lines, guards, known_locks, holds, findings):
        self.path = path
        self.lines = lines
        self.guards = guards
        self.known_locks = known_locks
        self.findings = findings
        self.held: set[str] = set(holds)

    def visit_With(self, node: ast.With) -> None:
        added = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr not in self.held:
                added.add(attr)
        self.held |= added
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr in self.guards:
            lock = self.guards[attr]
            if lock not in self.held:
                self.findings.append(Finding(
                    "AC-L001", "error",
                    f"access to self.{attr} (guarded-by: {lock}) outside "
                    f"'with self.{lock}' and without a 'holds: {lock}' "
                    f"annotation", f"{self.path}:{node.lineno}"))
        self.generic_visit(node)

    def _nested(self, node) -> None:
        # closures run later, possibly on another thread: no inherited locks
        holds = _holds_locks(node, self.lines) \
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
            else set()
        sub = _MethodChecker(self.path, self.lines, self.guards,
                             self.known_locks, holds, self.findings)
        for stmt in node.body if not isinstance(node, ast.Lambda) \
                else [node.body]:
            sub.visit(stmt)

    visit_FunctionDef = _nested
    visit_AsyncFunctionDef = _nested
    visit_Lambda = _nested


def lint_source(src: str, path: str = "<string>") -> list[Finding]:
    findings: list[Finding] = []
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("AC-L000", "error", f"unparseable: {e}", path)]
    lines = src.splitlines()

    classes = {n.name: _collect_class(n, lines)
               for n in tree.body if isinstance(n, ast.ClassDef)}
    for info in classes.values():
        # inherit guards/assignments from same-module bases
        for base in info.node.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                parent = classes[base.id]
                for attr, lock in parent.guards.items():
                    info.guards.setdefault(attr, lock)
                info.assigned |= parent.assigned

    for info in classes.values():
        if not info.guards:
            continue
        for attr, lock in sorted(info.guards.items()):
            if lock not in info.assigned:
                findings.append(Finding(
                    "AC-L002", "error",
                    f"'guarded-by: {lock}' on self.{attr} but self.{lock} "
                    f"is never assigned in class {info.node.name}",
                    f"{path}:{info.node.lineno}"))
        for fn in info.node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            holds = _holds_locks(fn, lines)
            for lock in sorted(holds - info.assigned):
                findings.append(Finding(
                    "AC-L003", "error",
                    f"'holds: {lock}' on {info.node.name}.{fn.name} but "
                    f"self.{lock} is never assigned in the class",
                    f"{path}:{fn.lineno}"))
            checker = _MethodChecker(path, lines, info.guards,
                                     info.assigned, holds, findings)
            for stmt in fn.body:
                checker.visit(stmt)
    return findings


def lint_file(path: str) -> list[Finding]:
    with open(path) as fh:
        return lint_source(fh.read(), path)


def lint_default_targets() -> list[Finding]:
    import repro_torch
    root = list(repro_torch.__path__)[0]
    findings: list[Finding] = []
    for rel in DEFAULT_TARGETS:
        findings.extend(lint_file(os.path.join(root, rel)))
    return findings
