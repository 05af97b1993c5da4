"""Training step: loss, grads, microbatch accumulation, optimizer update.

The port's copy of the reference package's ``training/train_step.py``.
The reference differentiates a pure loss of a parameter pytree with
``jax.value_and_grad``; the port's :class:`~repro_torch.models.transformer.Model`
holds its parameters, autograd differentiates its forward
(``torch.autograd.grad``, no ``.grad`` fields), and AdamW updates the
parameters in place. A step keeps its loss, learning rate and gradient
norm on the device and makes no host sync, so the caller decides when to
read them.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model
from repro_torch.training import optimizer as opt_mod

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step"]


def cross_entropy(logits, targets, mask=None):
    """logits (B,S,V) f32, targets (B,S) int. Mean NLL over unmasked
    tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(model: Model):
    """``loss_fn(batch)``: the model's mean NLL on ``batch`` (``tokens``,
    ``targets``, optional ``mask``; ``frames`` / ``images`` passed to the
    forward as ``extra``)."""
    def loss_fn(batch):
        extra = {k: batch[k] for k in ("frames", "images") if k in batch}
        logits = model(batch["tokens"], extra=extra or None)
        return cross_entropy(logits, batch["targets"], batch.get("mask"))
    return loss_fn


def make_train_step(model: Model, opt_cfg: opt_mod.AdamWConfig,
                    *, microbatches: int = 1):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``,
    which updates ``model``'s parameters in place (``opt_state`` from
    ``adamw_init(dict(model.named_parameters()))``; ``metrics`` holds
    ``loss``, ``lr`` and ``grad_norm`` as device tensors). Turns the
    model's gradients on (``requires_grad_(True)``).

    ``microbatches > 1`` splits the batch on axis 0 and accumulates the
    loss and float32 gradients from zero in microbatch order, then divides
    by the count, as the reference's scan does (memory for long-sequence
    training; DP semantics unchanged)."""
    loss_fn = make_loss_fn(model)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def value_and_grad(batch):
        with torch.enable_grad():
            loss = loss_fn(batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    def train_step(opt_state, batch):
        dev = model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatches == 1:
            loss, grads = value_and_grad(batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mbs = {k: v.reshape(microbatches, b // microbatches, *v.shape[1:])
                   for k, v in batch.items()}
            loss = torch.zeros((), device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in params.items()}
            for i in range(microbatches):
                l, g = value_and_grad({k: v[i] for k, v in mbs.items()})
                loss = loss + l
                for n in names:
                    grads[n].add_(g[n])
                del g
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}
        _, opt_state, stats = opt_mod.adamw_update(opt_cfg, params, grads,
                                                   opt_state)
        return opt_state, {"loss": loss, **stats}

    return train_step
