"""``python -m repro_torch.serve`` — CLI front of :class:`CPService`.

The counterpart of ``python -m repro.serve``, with its flags plus
``--device`` (``cuda``, the default, or ``cpu``).

One-shot mode (``--once``, what CI's serve-smoke drives) boots from a
checkpoint directory, runs a scripted query load (batched reconstructs +
top-k slices), optionally appends synthetic nonzeros to the backing store
and refreshes through the incremental-refit path, then prints the final
``metrics_report`` JSON on a greppable ``metrics_report {...}`` line.

Without ``--once`` it keeps serving: every ``--poll-s`` seconds it checks
the store manifest for appends, refreshes in the background when the store
grew, and prints a report line — Ctrl-C to stop.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="serve CP factor snapshots from a checkpoint directory")
    ap.add_argument("--ckpt", required=True,
                    help="CheckpointManager directory to boot from")
    ap.add_argument("--store", default=None,
                    help="backing TensorStore directory (enables refresh "
                         "and deploy validation)")
    ap.add_argument("--rank", type=int, default=None,
                    help="expected rank (validated against the checkpoint)")
    ap.add_argument("--once", action="store_true",
                    help="run the scripted load below, print the final "
                         "metrics_report, exit")
    ap.add_argument("--queries", type=int, default=200,
                    help="scripted reconstruct requests (default 200)")
    ap.add_argument("--batch", type=int, default=16,
                    help="coordinates per request (default 16)")
    ap.add_argument("--topk", type=int, default=8,
                    help="top-k slice queries of this k (0 disables)")
    ap.add_argument("--append-nnz", type=int, default=0,
                    help="append this many synthetic nonzeros to --store, "
                         "then refresh (exercises snapshot v2)")
    ap.add_argument("--refresh-sweeps", type=int, default=3,
                    help="ALS sweeps per incremental refresh (default 3)")
    ap.add_argument("--poll-s", type=float, default=5.0,
                    help="store poll cadence without --once (default 5s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where snapshots, queries and refits run (cpu: "
                         "the kernels' plain PyTorch versions)")
    return ap.parse_args(argv)


def _query_load(svc, rng, *, queries: int, batch: int, topk: int) -> None:
    shape = svc.engine.snapshot.shape
    nmodes = len(shape)
    for _ in range(queries):
        coords = np.stack([rng.integers(0, s, size=batch) for s in shape],
                          axis=1)
        svc.reconstruct(coords)
    if topk > 0:
        free = int(np.argmax(shape))  # richest mode as the scored one
        k = min(topk, shape[free])
        for _ in range(max(queries // 10, 1)):
            fixed = np.array([rng.integers(0, s) for s in shape])
            svc.topk(fixed, mode=free, k=k)
    # one request per bucket boundary proves the no-retrace discipline
    for n in (1, 7, 9, 100):
        coords = np.stack([rng.integers(0, s, size=n) for s in shape],
                          axis=1)
        svc.reconstruct(coords)


def _report_line(svc) -> None:
    print("metrics_report " + json.dumps(svc.metrics_report()),
          flush=True)


def main(argv=None) -> int:
    args = _parse_args(argv)
    from repro_torch.api.config import DecomposeConfig, RuntimeConfig
    from repro_torch.serve import CPService
    from repro_torch.store import TensorStore, append_to_store

    store = TensorStore(args.store) if args.store else None
    rng = np.random.default_rng(args.seed)

    config = None
    if store is not None:
        # refresh needs a solver config; rank comes from the checkpoint
        # unless pinned on the CLI
        from repro_torch.training.checkpoint import CheckpointManager
        restored = CheckpointManager(args.ckpt).restore_latest()
        if restored is None:
            print(f"error: no verified checkpoint under {args.ckpt!r}",
                  file=sys.stderr)
            return 1
        rank = args.rank or int(np.shape(restored[0]["factors"][0])[1])
        config = DecomposeConfig(
            rank=rank, runtime=RuntimeConfig(num_devices=1, tol=0.0,
                                             seed=args.seed))

    with CPService.boot(args.ckpt, store=store, config=config,
                        rank=args.rank, device=args.device) as svc:
        print(f"serving snapshot v{svc.engine.version} "
              f"(shape {svc.engine.snapshot.shape}, "
              f"rank {svc.engine.snapshot.rank}) from {args.ckpt}",
              flush=True)
        if args.once:
            _query_load(svc, rng, queries=args.queries, batch=args.batch,
                        topk=args.topk)
            if args.append_nnz > 0:
                if store is None:
                    print("error: --append-nnz needs --store",
                          file=sys.stderr)
                    return 1
                shape = store.shape
                ind = np.stack([rng.integers(0, s, size=args.append_nnz)
                                for s in shape], axis=1)
                val = rng.standard_normal(args.append_nnz
                                          ).astype(np.float32)
                append_to_store(store.path, ind, val)
                event = svc.refresh(sweeps=args.refresh_sweeps)
                print(f"refresh: published="
                      f"{event.get('published')} "
                      f"version={svc.engine.version}", flush=True)
                _query_load(svc, rng, queries=max(args.queries // 4, 1),
                            batch=args.batch, topk=0)
            _report_line(svc)
            return 0
        try:
            while True:
                time.sleep(args.poll_s)
                if store is not None:
                    event = svc.refresh(sweeps=args.refresh_sweeps,
                                        wait=False)
                    if event.get("refreshed"):
                        svc.wait_refresh()
                _report_line(svc)
        except KeyboardInterrupt:
            _report_line(svc)
            return 0


if __name__ == "__main__":
    sys.exit(main())
