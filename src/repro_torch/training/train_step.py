"""Train step: loss and gradients, microbatch accumulation, AdamW.

Port of ``repro.training.train_step``.  Gradients come from
``torch.autograd.grad`` on detached views of the parameter leaves (no
``.grad`` fields); ``num_micro`` microbatches accumulate in ``grad_dtype``
(``"bfloat16"``: the reference's gradient compression, the moments stay
float32), in place, then the mean.

Under ``distribution.sharding.use_mesh`` the step runs on DTensors:
``place_state`` puts the parameters and the moments where their logical
axes say (``param_logical_axes``, ZeRO-1's ``opt_logical_axes``), each
microbatch is sharded over ``batch``, and the step runs under DTensor's
implicit replication, so plain tensors made inside the model (positions,
masks, the rope table) act as replicated.
"""

from __future__ import annotations


import torch

from repro_torch.distribution import sharding as SH
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
        loss, grads = _value_and_grad(cfg, params, _sharded(batch))
        return loss, O.tree_map(lambda g: g.to(grad_dtype), grads)
    mbs = {k: v.reshape(num_micro, v.shape[0] // num_micro, *v.shape[1:])
           for k, v in batch.items()}
    acc = O.tree_map(lambda p: torch.zeros_like(p, dtype=grad_dtype), params)
    ls = torch.zeros((), dtype=F32, device=next(O.leaves(params))[1].device)
    for i in range(num_micro):
        loss, grads = _value_and_grad(
            cfg, params, _sharded({k: v[i] for k, v in mbs.items()}))
        O.tree_map(lambda a, g: a.add_(g.to(grad_dtype)), acc, grads)
        del grads
        ls = ls + loss
    inv = 1.0 / num_micro
    return ls * inv, O.tree_map(lambda g: g.mul_(inv), acc)


def _sharded(batch: dict) -> dict:
    """A (micro)batch's tensors sharded over ``batch`` on their leading dim
    (as they are without a mesh)."""
    return {k: SH.shard(v, "batch", *(None,) * (v.dim() - 1))
            for k, v in batch.items()}


def data_extent(mesh) -> int:
    """The data-parallel extent of ``mesh``: the product of the mesh axes
    that ``batch`` maps to."""
    sizes = SH.axis_sizes(mesh)
    n = 1
    for a in SH.get_rules()["batch"] or ():
        n *= sizes.get(a, 1)
    return n


def place_state(cfg: ModelConfig, opt_cfg: O.OptConfig, params,
                opt_state: O.OptState):
    """Parameters and optimizer state as DTensors on the active mesh:
    parameters by ``param_logical_axes``, the moments by
    ``opt_logical_axes`` (ZeRO-1 when ``opt_cfg.zero1``); the step count
    stays a plain tensor.  The inputs are the full tensors, the same on every rank."""
    mesh = SH.get_mesh()
    p_axes = T.param_logical_axes(cfg, params)
    o_axes = O.opt_logical_axes(p_axes, params, data_extent(mesh),
                                opt_cfg.zero1)
    return SH.distribute(params, p_axes), O.OptState(
        m=SH.distribute(opt_state.m, o_axes),
        v=SH.distribute(opt_state.v, o_axes), step=opt_state.step)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig,
                    num_micro: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``, stats holding ``loss``, ``grad_norm`` and ``lr`` (full
    tensors under a mesh too); ``batch`` holds the full tensors, the same
    on every rank under a mesh."""
    grad_dtype = getattr(torch, opt_cfg.grad_dtype)

    def train_step(params, opt_state, batch):
        with SH.mesh_context():
            loss, grads = microbatch_grads(cfg, params, batch, num_micro,
                                           grad_dtype)
            params, opt_state, stats = O.apply_updates(opt_cfg, params,
                                                       grads, opt_state)
            stats["loss"] = loss
            stats = SH.gather(stats)
        return params, opt_state, stats

    return train_step
