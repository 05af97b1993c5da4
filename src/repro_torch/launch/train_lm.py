"""Train a small LM with the full training substrate (any assigned arch's
smoke config): AdamW + cosine schedule, grad clip, microbatching,
checkpointing with restart, deterministic data. The port's twin of the
reference's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch granite_8b --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --steps 10

The model is seeded with a ``torch.Generator`` (seed 0) on ``--device``
(default ``cuda``); ``--ckpt`` saves every 10 steps in the reference's
payload layout and resumes from the latest checkpoint there.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.train import restore_training, training_payload
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_step import make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_config(args.arch, "smoke")
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params/1e6:.2f}M params")

    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup=5,
                                  total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    opt_state = opt_mod.adamw_init(dict(model.named_parameters()))
    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr is not None:
        restored = restore_training(mgr, model)
        if restored:
            opt_state, start = restored
            print(f"resumed from step {start}")

    for step in range(start, args.steps):
        opt_state, metrics = step_fn(opt_state, data.batch_at(step))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if mgr is not None and (step + 1) % 10 == 0:
            mgr.save(step + 1, training_payload(model, opt_state))


if __name__ == "__main__":
    main()
