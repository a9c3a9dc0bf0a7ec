"""Serving launcher: batched decode against the continuity-hash paged cache.

Port of ``repro.launch.serve`` (dense family), on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Prompts come from ``--seed`` (numpy), weights from a ``torch.Generator``
seeded the same.  The page-aligned head of each prompt is prefilled in
bulk, the tail fed step by step, then ``--gen`` tokens are decoded
greedily.  ``run_prefill`` and ``run_decode`` are the two halves, for
callers that check state between them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.words import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC


def make_geometry(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, *,
                  page_size: int = 16, shards: int = 2, kv_dtype=None,
                  device="cuda") -> KC.PageGeometry:
    """The launcher's cache geometry: room for prompt + generated tokens."""
    shape = ShapeConfig("serve", seq_len=max(prompt_len + gen, page_size * 2),
                        global_batch=batch, kind="decode")
    return KC.make_geometry(cfg, shape, shards=shards, page_size=page_size,
                            kv_dtype=kv_dtype, device=device)


def run_prefill(cfg, geom, params, prompts: torch.Tensor, cache):
    """Bulk-prefill the page-aligned head of ``prompts`` (B, S), then feed
    the tail token by token; returns (last logits (B, V), cache)."""
    S = prompts.shape[1]
    pl = max(S - S % geom.page_size, geom.page_size)
    lg, cache = E.prefill(cfg, geom, params, prompts[:, :pl], cache)
    for t in range(pl, S):
        lg, cache = E.serve_step(cfg, geom, params, prompts[:, t], cache)
    return lg, cache


def run_decode(cfg, geom, params, logits, cache, gen: int):
    """Greedy decode of ``gen`` tokens from ``logits``: the first from the
    prefill's logits, then one ``serve_step`` per further token.  Returns
    (tokens (B, gen) int32, last step's logits, cache)."""
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = E.serve_step(cfg, geom, params, tok, cache)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, 1), logits, cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(rng.randint(
        0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)
    geom = make_geometry(cfg, args.batch, args.prompt_len, args.gen,
                         page_size=args.page_size, shards=args.shards,
                         device=dev)
    cache = KC.create_cache(geom)

    t0 = time.perf_counter()
    lg, cache = run_prefill(cfg, geom, params, prompts, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, lg, cache = run_decode(cfg, geom, params, lg, cache, args.gen)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks = toks.cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"prefill: {prefill_s:.2f}s  decode: {decode_s:.2f}s "
          f"({args.batch * (args.gen - 1) / max(decode_s, 1e-9):.1f} tok/s)")
    print(f"page table: {sum(int(t.count) for t in cache.table)} mappings, "
          f"{int(cache.next_free.sum())} pages allocated, "
          f"pool={geom.pool_pages}/shard x {geom.shards} shards")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {toks[b, :16].tolist()}")


if __name__ == "__main__":
    main()
