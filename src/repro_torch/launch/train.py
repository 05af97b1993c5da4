"""Production training launcher: the port's twin of the reference package's
``launch/train.py``, with its flags and ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_1b --smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
        --smoke --steps 6 --ckpt /tmp/ckpt --ckpt-every 3 --device cpu

``--smoke`` runs the architecture's reduced config at batch 4 × 32 tokens
(without it, the full config at 256 × 4,096); the model is seeded with a
``torch.Generator`` (seed 0) on ``--device`` (default ``cuda``) and trains
on ``SyntheticLM`` (seed 0). ``--remat`` sets the config's remat policy
(``none``, ``full`` or ``dots``). ``--ckpt`` saves every ``--ckpt-every``
steps in the reference's payload layout (``{"params", "opt"}``, the
``groups`` layout of ``models.convert``) and resumes from the latest
checkpoint there, the reference's own included; the data stream resumes
at the checkpoint's step. ``--dry`` runs the dry-run of ``--arch`` and
``--shape`` (default ``train_4k``) on ``--mesh`` instead
(``repro_torch.launch.dryrun.run_cell`` on the ``meta`` device: no card,
no allocation), writes its record to ``experiments/dryrun_torch/`` and
exits non-zero if the cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def restore_training(mgr, model):
    """``(opt_state, step)`` from the latest checkpoint in ``mgr`` (either
    package's payload), with the parameters installed in ``model``; or
    ``None`` when there is none."""
    from repro_torch.models.convert import (load_reference_opt_state,
                                            load_reference_params)
    restored = mgr.restore_latest()
    if not restored:
        return None
    payload, step = restored
    load_reference_params(model, payload["params"])
    return load_reference_opt_state(model, payload["opt"]), step


def training_payload(model, opt_state) -> dict:
    """The reference's checkpoint payload: parameters and AdamW state as
    numpy pytrees in its ``groups`` layout."""
    from repro_torch.models.convert import (reference_opt_state,
                                            reference_params)
    return {"params": reference_params(model),
            "opt": reference_opt_state(model, opt_state)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "host"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    if args.dry:
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(args.arch, args.shape,
                              multi_pod=args.mesh == "pod2", remat=args.remat,
                              microbatches=args.microbatches)
        dryrun._report(rec)
        if not rec["ok"]:
            raise SystemExit(f"--dry: {args.arch} {args.shape} failed")
        return rec

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import make_train_step

    dev = torch.device(args.device)
    cfg = get_config(args.arch, "smoke" if args.smoke else "full")
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    opt_cfg = opt_mod.AdamWConfig(total_steps=max(args.steps, 100))
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))

    batch_size, seq = (4, 32) if args.smoke else (256, 4096)
    data = SyntheticLM(vocab=cfg.vocab, batch=batch_size, seq=seq)
    mgr = CheckpointManager(args.ckpt, async_save=True) if args.ckpt else None
    start = 0
    if mgr is not None:
        restored = restore_training(mgr, model)
        if restored:
            opt_state, start = restored
            print(f"resumed at step {start}")

    for step in range(start, args.steps):
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, data.batch_at(step))
        print(f"step {step} loss={float(metrics['loss']):.4f} "
              f"dt={time.time() - t0:.2f}s", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, training_payload(model, opt_state), block=False)
    if mgr is not None:
        mgr.wait()


if __name__ == "__main__":
    main()
