"""Axis trees and per-leaf specs of every config, for
``tests/test_torch_sharding.py``.

``reference_specs`` runs in a process with 512 forced XLA host devices,
``port_specs`` in one with a fake 256- or 512-rank process group; each
prints one JSON object {config: {kind: {leaf path: [axes, spec]}}} for
the params, the optimizer moments and the cache (paged for the
full-attention families, the state cache for ssm / hybrid) at
``decode_32k`` on the production mesh.  A spec entry is None, an axis
name or a list of axis names.
"""

import json


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _flat(ax, sh, logical_spec, path=""):
    """{path: [axes, spec]} of parallel axis / shape trees (dicts sorted,
    NamedTuples by field); a None shape leaf (an absent scale) is skipped."""
    out = {}
    if isinstance(sh, dict):
        for k in sorted(sh):
            out.update(_flat(ax[k], sh[k], logical_spec, f"{path}{k}."))
    elif hasattr(sh, "_fields"):
        for f in sh._fields:
            out.update(_flat(getattr(ax, f), getattr(sh, f), logical_spec,
                             f"{path}{f}."))
    elif sh is not None:
        shape = tuple(sh.shape)
        names = tuple(ax) if ax is not None else (None,) * len(shape)
        spec = logical_spec(*names, size_of=shape)
        out[path[:-1]] = [list(names), [_entry(e) for e in spec]]
    return out


def reference_specs(multi_pod: bool) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS, get_arch
    from repro.distribution.sharding import logical_spec, use_mesh
    from repro.launch.mesh import make_production_mesh
    from repro.models import transformer as T
    from repro.models.config import SHAPES
    from repro.serving import kvcache as KC
    from repro.training import optimizer as O

    mesh = make_production_mesh(multi_pod=multi_pod)
    dp = mesh.devices.size // 16
    shape = SHAPES["decode_32k"]
    out = {}
    with use_mesh(mesh):
        for a in ARCHS:
            cfg = get_arch(a)
            ps = jax.eval_shape(
                lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
            pax = T.param_logical_axes(cfg, ps)
            oax = O.opt_logical_axes(pax, ps, dp, True)
            if cfg.family in ("ssm", "hybrid"):
                cs = jax.eval_shape(lambda: KC.create_state_cache(
                    cfg, shape.global_batch, shape.seq_len,
                    dtype=jnp.bfloat16))
                cax = KC.state_cache_logical_axes(cfg, cs)
            else:
                geom = KC.make_geometry(cfg, shape, shards=dp)
                cs = jax.eval_shape(lambda: KC.create_cache(geom))
                cax = KC.cache_logical_axes(geom, cs)
            out[a] = {"params": _flat(pax, ps, logical_spec),
                      "moments": _flat(oax, ps, logical_spec),
                      "cache": _flat(cax, cs, logical_spec)}
    return out


def port_specs(multi_pod: bool) -> dict:
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.distribution.sharding import logical_spec, use_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES
    from repro_torch.serving import kvcache as KC
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import data_extent

    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        shape = SHAPES["decode_32k"]
        out = {}
        with use_mesh(mesh):
            dp = data_extent(mesh)
            assert dp == world // 16, dp
            for a in ARCHS:
                cfg = get_arch(a)
                with FakeTensorMode():
                    ps = T.init_params(cfg, torch.Generator().manual_seed(0),
                                       master_dtype=torch.float32)
                pax = T.param_logical_axes(cfg, ps)
                oax = O.opt_logical_axes(pax, ps, dp, True)
                if cfg.family in ("ssm", "hybrid"):
                    cs = KC.create_state_cache(cfg, shape.global_batch,
                                               shape.seq_len, device="meta")
                    cax = KC.state_cache_logical_axes(cfg, cs)
                else:
                    geom = KC.make_geometry(cfg, shape, shards=dp,
                                            device="meta")
                    cs = KC.create_cache(geom)
                    cax = KC.cache_logical_axes(geom, cs)
                    t0 = cs.table[0]   # the reference's stacked table
                    cs = cs._replace(table=type(t0)(*(
                        torch.empty((dp,) + tuple(x.shape), device="meta")
                        for x in t0)))
                out[a] = {"params": _flat(pax, ps, logical_spec),
                          "moments": _flat(oax, ps, logical_spec),
                          "cache": _flat(cax, cs, logical_spec)}
        return out
    finally:
        dist.destroy_process_group()


def main(side: str):
    fn = reference_specs if side == "reference" else port_specs
    print(json.dumps({mp: fn(mp == "multi") for mp in ("single", "multi")}))
