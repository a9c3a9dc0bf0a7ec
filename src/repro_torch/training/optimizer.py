"""AdamW, the reference's arithmetic (no ``torch.optim``).

Port of ``repro.training.optimizer``.  Master parameters are float32 (the
model casts each leaf where it uses it); the moments ``m`` and ``v`` are
float32 trees shaped as the parameters; ``step`` is a 0-d int32 tensor.
The order of operations is the reference's: clip by the global norm,
update the moments, bias-correct as ``m / c1`` and ``v / c2``, step along
``mh / (sqrt(vh) + eps)``, weight decay on leaves of two or more
dimensions, ``p - lr * (dir + wd * p)``.  ``torch.optim.AdamW`` applies
decay and bias correction in another order, so its rounding differs.

``apply_updates`` writes the parameters and moments IN PLACE (a copy of
the state of 1.9 B parameters would need 23 GB more on the card) and
returns the same trees with a new ``OptState``.  Under a mesh the
leaves are DTensors: ``opt_logical_axes`` places the moments (ZeRO-1
over the data axis), and each leaf's update runs in its moments'
placements, the gradient redistributed to them and the new value back to
the parameter's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch.distribution import sharding as SH

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10000
    zero1: bool = True
    grad_dtype: str = "float32"   # bfloat16 => compressed gradients


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor


def leaves(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of nested dicts, keys sorted (the
    reference's ``jax.tree`` order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            for path, t in leaves(v):
                yield f"{k}.{path}", t
        else:
            yield k, v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure, in
    ``leaves``' order (keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    first = next(leaves(params))[1]
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=first.device))


def schedule(cfg: OptConfig, step):
    """Linear warmup to ``lr``, then a cosine to 0.1 * ``lr`` at
    ``decay_steps``; float32, as the reference's."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup)
                    / max(cfg.decay_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for _, x in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step; returns (params, state, stats), the parameter and
    moment trees updated in place."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    c1 = 1 - cfg.b1 ** step.to(F32)
    c2 = 1 - cfg.b2 ** step.to(F32)

    def upd(p, g, m, v):
        if SH.is_dtensor(m):
            g = SH.to_placements(g, m.device_mesh, m.placements)
        g = g.to(F32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / c1
        vh = v / c2
        step_dir = mh / (torch.sqrt(vh) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        pf = p.to(F32)
        if SH.is_dtensor(m):
            pf = SH.to_placements(pf, m.device_mesh, m.placements)
            new = pf - lr * (step_dir + wd * pf)
            p.copy_(SH.to_placements(new, p.device_mesh, p.placements))
            return
        p.copy_(pf - lr * (step_dir + wd * pf))
    tree_map(upd, params, grads, state.m, state.v)
    return params, OptState(state.m, state.v, step), {"grad_norm": gn,
                                                      "lr": lr}


def opt_logical_axes(param_axes: dict, params, data_extent: int,
                     zero1: bool) -> dict:
    """Logical axes for m/v: param axes + ZeRO-1 sharding over the data axis
    on the largest divisible dim whose logical name maps to NO mesh axis
    (i.e. a dim the TP rules leave replicated)."""
    rules = SH.get_rules()

    def leaf(ax, p):
        ax = tuple(ax) if ax else (None,) * len(p.shape)
        if not zero1:
            return ax
        best, best_dim = -1, -1
        for i, (name, dim) in enumerate(zip(ax, p.shape)):
            free = name is None or not rules.get(name)
            if free and dim % data_extent == 0 and dim > best:
                best, best_dim = dim, i
        if best_dim < 0:
            return ax
        return tuple("zero" if i == best_dim else n for i, n in enumerate(ax))
    return tree_map(leaf, param_axes, params)
