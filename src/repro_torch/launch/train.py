"""Training launcher.

Port of ``repro.launch.train``, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 50 --batch 4 --seq 128 --ckpt DIR [--device cpu]

Float32 master weights from a ``torch.Generator`` seeded with ``--seed``;
the reference's synthetic data (a ``DeterministicSchedule`` and one Philox
stream per step, numpy), so a restarted run sees the same batches.  With
``--ckpt`` the run restores the newest committed checkpoint, saves every
``--ckpt-every`` steps (async) and at the end.

``--mesh single|multi`` trains on the production mesh, (16, 16) or
(2, 16, 16), one process per rank, under torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: the
reference's ``JAX_COORDINATOR``); the world size must be the mesh's.
Every rank builds the same masters and batches; ``train_step.place_state``
shards them (ZeRO-1 moments) and the steps run under ``use_mesh``.  The
process group is NCCL for ``cuda`` and gloo for ``cpu``; one already
started by the caller is used as it is.  Checkpoints hold the full
tensors, written by rank 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.words import resolve_device
from repro_torch.distribution import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.fault import DeterministicSchedule
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step, place_state


def synthetic_batch(cfg: ModelConfig, seed: int, step: int, batch: int,
                    seq: int, device) -> dict:
    """The reference launcher's deterministic LM batch of ``step``: tokens
    (or, for an embedding frontend, standard-normal embeddings) and the
    tokens shifted by one as labels."""
    DeterministicSchedule(seed, batch).batch_indices(step, 0, 1)
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[0, 0, step, 7]))
    toks = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    labels = torch.from_numpy(np.roll(toks, -1, 1)).to(device)
    if cfg.frontend == "embed":
        emb = rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
        return {"inputs": torch.from_numpy(emb).to(device), "labels": labels}
    return {"inputs": torch.from_numpy(toks).to(device), "labels": labels}


def main(argv=None):
    """Run the launcher; returns every step's loss (floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = _production_mesh(args.mesh, dev) if args.mesh != "none" else None
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count/1e6:.1f}M (smoke={args.smoke})")

    params = T.init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           master_dtype=torch.float32)
    opt_cfg = O.OptConfig(lr=args.lr, warmup=min(20, args.steps // 5 + 1),
                          decay_steps=args.steps)
    state = O.init(params)
    step_fn = make_train_step(cfg, opt_cfg, num_micro=args.micro)

    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, start, _ = mgr.restore({"p": params, "o": state})
        params, state = restored["p"], restored["o"]
        print(f"restored checkpoint at step {start}")

    lead = mesh is None or dist.get_rank() == 0

    def save(step):
        tree = SH.gather({"p": params, "o": state})   # every rank takes part
        if lead:
            mgr.save(step, tree)

    def run():
        nonlocal params, state
        losses = []
        t0 = time.time()
        for s in range(start, args.steps):
            params, state, stats = step_fn(params, state, synthetic_batch(
                cfg, args.seed, s, args.batch, args.seq, dev))
            losses.append(stats["loss"])
            if lead and (s % 10 == 0 or s == args.steps - 1):
                dt = time.time() - t0
                tok_s = (s - start + 1) * args.batch * args.seq / max(dt,
                                                                     1e-9)
                print(f"step {s:5d} loss {float(stats['loss']):.4f} "
                      f"gnorm {float(stats['grad_norm']):.3f} "
                      f"lr {float(stats['lr']):.2e} tok/s {tok_s:.0f}",
                      flush=True)
            if mgr is not None and (s + 1) % args.ckpt_every == 0:
                save(s + 1)
        if mgr is not None:
            save(args.steps)
            mgr.wait()
        return [float(x) for x in losses]

    if mesh is None:
        return run()
    with SH.use_mesh(mesh):
        params, state = place_state(cfg, opt_cfg, params, state)
        return run()


def _production_mesh(kind: str, dev: torch.device):
    """The production mesh of ``--mesh kind`` over torchrun's process group
    (started here from its environment unless the caller started one);
    raises when the world size is not the mesh's."""
    from repro_torch.launch.mesh import make_production_mesh
    need = 512 if kind == "multi" else 256
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(f"--mesh {kind} needs a world of {need} ranks, "
                         f"this one has {world}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"),
            rank=int(os.environ["RANK"]), world_size=world)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type=dev.type)


if __name__ == "__main__":
    main()
