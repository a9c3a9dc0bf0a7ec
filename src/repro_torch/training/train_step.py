"""Train step: loss and gradients, microbatch accumulation, AdamW.

Port of ``repro.training.train_step``.  Gradients come from
``torch.autograd.grad`` on detached views of the parameter leaves (no
``.grad`` fields); ``num_micro`` microbatches accumulate in ``grad_dtype``
(``"bfloat16"``: the reference's gradient compression, the moments stay
float32), in place, then the mean.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as O

F32 = torch.float32


def _value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, gradient tree) of ``transformer.loss_fn``; a leaf the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives."""
    live = O.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = [t for _, t in O.leaves(live)]
    with torch.enable_grad():
        loss = T.loss_fn(cfg, live, batch)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), O.tree_map(grad_of, live)


def microbatch_grads(cfg: ModelConfig, params, batch, num_micro: int,
                     grad_dtype):
    """Gradient accumulation over ``num_micro`` equal microbatches (the
    batch's leading dim split in order); returns (mean loss, mean
    gradients in ``grad_dtype``)."""
    if num_micro <= 1:
        loss, grads = _value_and_grad(cfg, params, batch)
        return loss, O.tree_map(lambda g: g.to(grad_dtype), grads)
    mbs = {k: v.reshape(num_micro, v.shape[0] // num_micro, *v.shape[1:])
           for k, v in batch.items()}
    acc = O.tree_map(lambda p: torch.zeros(p.shape, dtype=grad_dtype,
                                           device=p.device), params)
    ls = torch.zeros((), dtype=F32, device=next(O.leaves(params))[1].device)
    for i in range(num_micro):
        loss, grads = _value_and_grad(cfg, params,
                                      {k: v[i] for k, v in mbs.items()})
        O.tree_map(lambda a, g: a.add_(g.to(grad_dtype)), acc, grads)
        del grads
        ls = ls + loss
    inv = 1.0 / num_micro
    return ls * inv, O.tree_map(lambda g: g.mul_(inv), acc)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig,
                    num_micro: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``, stats holding ``loss``, ``grad_norm`` and ``lr``."""
    grad_dtype = getattr(torch, opt_cfg.grad_dtype)

    def train_step(params, opt_state, batch):
        loss, grads = microbatch_grads(cfg, params, batch, num_micro,
                                       grad_dtype)
        params, opt_state, stats = O.apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step
