"""Serve a small model with batched requests: prefill + decode with KV
caches, greedy/sampled generation. The port's twin of the reference's
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch deepseek_v2_lite
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu --gen 4

Runs the architecture's smoke configuration with seeded random weights
(generator seed 0), seeded prompts (seed 1) and, with ``--temperature``,
seeded sampling (seed 2), on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.lm_serve import generate
    from repro_torch.models.transformer import Model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_v2_lite", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_config(args.arch, "smoke")
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    extra = None
    if cfg.encoder is not None:
        extra = {"frames": torch.from_numpy(np.random.default_rng(0).normal(
            size=(args.batch, 12, cfg.d_model)).astype(np.float32)).to(dev)}
    elif any(s.mixer == "cross_attn" for s in cfg.pattern):
        extra = {"images": torch.from_numpy(np.random.default_rng(0).normal(
            size=(args.batch, 10, cfg.d_model)).astype(np.float32)).to(dev)}

    t0 = time.time()
    out = generate(model, prompts, steps=args.gen,
                   cache_len=args.prompt_len + args.gen, extra=extra,
                   temperature=args.temperature,
                   generator=torch.Generator(device=dev).manual_seed(2))
    out = out.cpu()
    dt = time.time() - t0
    toks = args.batch * args.gen
    print(f"{cfg.name} on {dev}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print("sample token ids:", out[0].tolist())


if __name__ == "__main__":
    main()
