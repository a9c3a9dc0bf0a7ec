"""The port's sharded training, run in spawned processes for
``tests/test_torch_sharded_train.py``.

``port_main`` spawns 8 gloo ranks that train ``smoke_config("yi-6b")``
for the steps the inputs ask, on a (2, 4) ``("data", "model")`` mesh from
the reference's parameters, then the same twin with 4 kv heads (so the
model axis shards them) against its own unsharded steps; rank 0 saves the
losses and the gathered parameters.  ``launcher_fake`` runs ``launch.train --mesh single`` for one
step on a fake 256-rank process group (its collectives move no data: the
run shows the launcher's mesh path goes through, not its numbers).
"""

import numpy as np


def _tree(flat: dict) -> dict:
    out = {"blocks": {}}
    for k, v in flat.items():
        if k.startswith("p.blocks."):
            out["blocks"][k[len("p.blocks."):]] = v
        elif k.startswith("p."):
            out[k[2:]] = v
    return out


def _rank(rank, world, port, inputs, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch import convert
        from repro_torch.configs import smoke_config
        from repro_torch.distribution import sharding as SH
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.training import optimizer as O
        from repro_torch.training.train_step import (make_train_step,
                                                     place_state)
        inp = dict(np.load(inputs))
        cfg = smoke_config("yi-6b")
        params = convert.params_from_numpy(_tree(inp), cfg, "cpu",
                                           master_dtype=torch.float32)
        opt_cfg = O.OptConfig(lr=float(inp["lr"]))
        batch = {"inputs": torch.from_numpy(inp["inputs"]),
                 "labels": torch.from_numpy(inp["labels"])}
        step = make_train_step(cfg, opt_cfg)
        mesh = make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
        losses = []
        with SH.use_mesh(mesh):
            p, s = place_state(cfg, opt_cfg, params, O.init(params))
            placed = {k: str(tuple(v.placements))
                      for k, v in O.leaves({"p": p, "m": s.m})}
            for _ in range(int(inp["steps"])):
                p, s, st = step(p, s, batch)
                losses.append(float(st["loss"]))
        full = SH.gather({"p": p, "m": s.m})
        kv = _kv_sharded(torch, cfg, opt_cfg, batch, mesh, int(inp["steps"]))
        if rank == 0:
            np.savez(out, losses=np.asarray(losses),
                     placed=np.asarray([f"{k}={v}" for k, v in
                                        sorted(placed.items())]),
                     **kv, **{k: v.numpy() for k, v in O.leaves(full)})
    finally:
        dist.destroy_process_group()


def _kv_sharded(torch, cfg, opt_cfg, batch, mesh, steps) -> dict:
    """The yi-6b twin with 4 kv heads, so the model axis shards them too:
    ``steps`` steps on the mesh against the same steps unsharded (the
    port's own), as {"kv_losses", "kv_ref_losses", "kv_excess",
    "kv_placed"}; excess is the largest |sharded - unsharded| beyond rtol
    2e-3 over every leaf."""
    import dataclasses
    from repro_torch.distribution import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step, place_state
    cfg = dataclasses.replace(cfg, n_kv_heads=4)
    step = make_train_step(cfg, opt_cfg)

    def fresh():
        return T.init_params(cfg, torch.Generator().manual_seed(3),
                             master_dtype=torch.float32)
    p = fresh()
    s, ref = O.init(p), []
    for _ in range(steps):
        p, s, st = step(p, s, batch)
        ref.append(float(st["loss"]))
    with SH.use_mesh(mesh):
        start = fresh()
        dp, ds = place_state(cfg, opt_cfg, start, O.init(start))
        placed = str(tuple(dp["blocks"]["wk"].placements))
        got = []
        for _ in range(steps):
            dp, ds, st = step(dp, ds, batch)
            got.append(float(st["loss"]))
    full = SH.gather(dp)
    excess = max(float(((full_leaf - a).abs() - 2e-3 * a.abs()).max())
                 for (_, a), (_, full_leaf) in zip(O.leaves(p),
                                                   O.leaves(full)))
    return {"kv_losses": np.asarray(got), "kv_ref_losses": np.asarray(ref),
            "kv_excess": np.asarray(excess), "kv_placed": np.asarray(placed)}


def port_main(inputs, out, world=8):
    import torch.multiprocessing as mp
    from _distscenarios import free_port
    mp.start_processes(_rank, args=(world, free_port(), inputs, out),
                       nprocs=world, start_method="spawn")


def launcher_fake():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import train
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        losses = train.main(["--arch", "yi-6b", "--smoke", "--steps", "1",
                             "--batch", "16", "--seq", "32", "--mesh",
                             "single", "--device", "cpu"])
        print("LOSSES", len(losses))
    finally:
        dist.destroy_process_group()

