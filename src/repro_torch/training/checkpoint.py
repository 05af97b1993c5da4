"""Fault-tolerant checkpointing.

The port's copy of the reference package's ``training/checkpoint.py``, with
its on-disk format, so a checkpoint written by either package restores
through the other's manager:

  * **atomic** — write to a temp dir (``step_%010d.tmp``), fsync, rename; a
    crash mid-save never corrupts the latest checkpoint;
  * **verified** — SHA-256 per ``.npy`` array file recorded in
    ``manifest.json``; restore skips checkpoints that fail verification
    (torn writes, bad disks) and falls back to the previous one;
  * **async** — saves run on a background thread off the solver's loop
    (double-buffered: at most one save in flight, next save waits);
  * **bounded** — keep-latest-k retention;
  * **elastic** — checkpoints store flat numpy arrays keyed by path, so a
    restore may re-shard onto a different device count (resharding is the
    caller's concern; arrays are device-agnostic).

Payloads are nested dicts, lists and tuples of numpy arrays or torch
tensors; a tensor is copied to the host (``.cpu()``) as the payload is
flattened, on the caller's thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.obs import clock

__all__ = ["CheckpointManager"]


def _tree_flatten(payload: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten nested dict/list/tuple of arrays into path-keyed host
    arrays (torch tensors are copied to the host)."""
    out: dict[str, np.ndarray] = {}
    if isinstance(payload, dict):
        for k, v in payload.items():
            out.update(_tree_flatten(v, f"{prefix}{k}/"))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(_tree_flatten(v, f"{prefix}{i}/"))
    elif isinstance(payload, torch.Tensor):
        out[prefix.rstrip("/")] = payload.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(payload)
    return out


def _tree_unflatten(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of _tree_flatten (lists come back as lists)."""
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[k]) for k in sorted(keys, key=int)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._exc_lock = threading.Lock()
        # written by the save thread, consumed by wait()
        self._save_exc: BaseException | None = None  # guarded-by: _exc_lock
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    # -- save --------------------------------------------------------------
    def save(self, step: int, payload: Any, *, block: bool = True) -> None:
        """Write checkpoint ``step`` atomically (temp dir → fsync → rename).

        Blocking semantics: the save runs on a background thread ONLY when
        the manager was built with ``async_save=True`` AND ``block=False``;
        every other combination runs synchronously on the caller's thread
        (``block=True`` is the safe default even on an async manager — e.g.
        a final checkpoint before exit). The async hand-off is
        double-buffered: at most one save is in flight, so ``save()`` first
        waits for the previous one — meaning a failure in save *k* surfaces
        as an exception from the ``save(k+1)`` or :meth:`wait` call that
        joins it, not silently from a daemon thread. ``payload`` is
        flattened to numpy arrays before the method returns, so the caller
        may mutate its arrays immediately after an async hand-off."""
        if self.async_save and not block:
            self.wait()
            # flatten + copy on the caller's thread: the background save
            # then owns private arrays, immune to caller-side mutation
            flat = {k: np.array(v) for k, v in _tree_flatten(payload).items()}

            def run() -> None:
                try:
                    self._save_sync_flat(step, flat)
                except BaseException as e:  # surfaced by the next wait()
                    with self._exc_lock:
                        self._save_exc = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            self.wait()
            self._save_sync(step, payload)

    def wait(self) -> None:
        """Join any in-flight async save. Re-raises the exception the save
        thread hit, if any — without this a failed async save would be
        silently dropped and the training loop would believe the
        checkpoint exists. Idempotent; a raised exception is cleared (the
        next wait() does not re-raise it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._exc_lock:
            exc, self._save_exc = self._save_exc, None
        if exc is not None:
            raise exc

    def _save_sync(self, step: int, payload: Any) -> None:
        self._save_sync_flat(step, _tree_flatten(payload))

    def _save_sync_flat(self, step: int, flat: dict[str, np.ndarray]) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": clock.walltime(), "arrays": {}}
        for path, arr in flat.items():
            fname = path.replace("/", "__") + ".npy"
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["arrays"][path] = {
                "file": fname, "sha256": digest,
                "shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def _verify_and_load(self, step: int) -> Any | None:
        d = self._step_dir(step)
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            flat = {}
            for path, meta in manifest["arrays"].items():
                fpath = os.path.join(d, meta["file"])
                with open(fpath, "rb") as f:
                    raw = f.read()
                if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
                    raise IOError(f"checksum mismatch: {path}")
                with open(fpath, "rb") as f:
                    flat[path] = np.load(f)
            return _tree_unflatten(flat)
        except Exception:
            return None

    def restore(self, step: int) -> Any | None:
        return self._verify_and_load(step)

    def restore_latest(self) -> tuple[Any, int] | None:
        """Newest checkpoint that passes integrity verification."""
        for step in reversed(self.steps()):
            payload = self._verify_and_load(step)
            if payload is not None:
                return payload, step
        return None
