"""CLI for the streaming ``.tns`` → store converter.

The port's copy of the reference package's ``store/convert.py``.

    PYTHONPATH=src python -m repro_torch.store.convert tensor.tns.gz tensor.store \
        --chunk-nnz 1048576

Prints a one-line ingest report (nnz, chunks, throughput, on-disk size) and
exits nonzero on malformed input. ``--profile``/``--scale`` instead runs
the store-native synthetic generator for a paper dataset profile.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.store.writer import convert_tns, write_profile_store


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="convert a .tns/.tns.gz tensor (or generate a synthetic "
                    "profile) into an out-of-core tensor store")
    ap.add_argument("source", help=".tns/.tns.gz path, or a DATASET_PROFILES "
                                   "name with --profile")
    ap.add_argument("dest", help="output store directory")
    ap.add_argument("--chunk-nnz", type=int, default=None,
                    help="nonzeros per chunk (default 1Mi)")
    ap.add_argument("--profile", action="store_true",
                    help="treat SOURCE as a dataset profile name and run "
                         "the store-native synthetic generator")
    ap.add_argument("--scale", type=float, default=1e-3,
                    help="profile linear scale (with --profile; 1.0 = "
                         "paper-scale)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    kw = {} if args.chunk_nnz is None else {"chunk_nnz": args.chunk_nnz}
    if args.profile:
        report = write_profile_store(args.source, args.dest,
                                     scale=args.scale, seed=args.seed, **kw)
        src_desc = f"profile {args.source}@{args.scale}"
    else:
        report = convert_tns(args.source, args.dest, **kw)
        src_desc = args.source
    size = _dir_bytes(args.dest)
    rate = report.get("nnz_per_s")
    rate_s = f" | {rate / 1e6:.2f} Mnnz/s" if rate else ""
    print(f"{src_desc} -> {args.dest}: shape={tuple(report['shape'])} "
          f"nnz={report['nnz']} chunks={len(report['chunks'])}"
          f"x{report['chunk_nnz']} | {size / 1e6:.2f} MB on disk{rate_s}")


if __name__ == "__main__":
    main()
