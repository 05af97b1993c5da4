"""Quickstart: the plan/compile/execute API on a synthetic tensor. The
port's twin of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Three staged calls — config, plan (preprocessing, reusable/cacheable),
compile (shards placed on ``--device``, default ``cuda``), then execution.
``--nnz`` shrinks the tensor (default the reference's 200,000).
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    import repro_torch.api as api
    from repro_torch.core.coo import random_sparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to decompose on (default cuda)")
    args = ap.parse_args(argv)

    # a skewed 3-mode tensor (Twitch-like hot indices)
    tensor = random_sparse((2000, 800, 400), args.nnz, seed=0,
                           distribution="zipf", zipf_a=1.3)
    print(f"tensor: shape={tensor.shape} nnz={tensor.nnz}")

    # 1. config — the paper's setup (CDF sharding, r=1, ring exchange),
    #    overridden with a smaller rank for the demo
    cfg = api.preset("paper", {"rank": 16})

    # 2. plan — partition every mode once (pure host work; pass cache_dir=
    #    to reuse this across runs and processes)
    plan = api.plan(tensor, cfg, device=args.device)

    # 3. compile + execute — the solver owns the shards on the device
    solver = api.compile(plan, cfg, device=args.device)
    result = solver.run(5, verbose=True)

    print(f"\nfits per sweep: {[round(f, 4) for f in result.fits]}")
    print(f"factor shapes: {[f.shape for f in result.factors]}")
    print(f"lambda[:5] = {np.round(result.lam[:5], 3)}")
    # balance stats the partitioner achieved (paper §5.5)
    for mode, part in enumerate(result.plan.modes):
        st = part.balance_stats()
        print(f"mode {mode}: r={part.r} nnz max/min = "
              f"{st['nnz_max']}/{st['nnz_min']}")
    solver.close()
    return result


if __name__ == "__main__":
    main()
