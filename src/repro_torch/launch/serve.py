"""Serving launcher: batched decode against the continuity-hash paged cache
(full-attention families) or the recurrent state cache (ssm, hybrid).

Port of ``repro.launch.serve``, on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 [--kv-dtype int8] [--device cpu]

Prompts come from ``--seed`` (numpy), weights from a ``torch.Generator``
seeded the same.  Full-attention families (dense, moe, audio, vlm)
prefill the page-aligned head of each prompt in bulk and feed the tail
step by step; ssm and hybrid families prefill recurrently, one token per
``serve_step``, on a float32 state cache (as the reference's launcher).
Then ``--gen`` tokens are decoded greedily.  ``run_prefill`` and
``run_decode`` are the two halves, for callers that check state between
them; ``make_geometry`` / ``make_state_cache`` build the caches, and
``stepper`` gives both their step.  On a card a state cache's step is a
CUDA graph of ``serve_step`` (``GraphedStep``): a recurrent step is a
chain of a few hundred small torch ops per layer whose launches, not
the card, set its time.
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


def make_state_cache(cfg: ModelConfig, batch: int, prompt_len: int,
                     gen: int, *, device="cuda") -> dict:
    """The launcher's state cache (ssm, hybrid): float32, room for prompt +
    generated tokens in the hybrid's global layers."""
    return KC.create_state_cache(cfg, batch, prompt_len + gen,
                                 dtype=torch.float32, device=device)


class GraphedStep:
    """``engine.serve_step`` of a state-cache family (ssm, hybrid) on a
    card, as a CUDA graph captured over ``cache`` at the first call and
    replayed at every call: ``step(tokens, cache) -> (logits, cache)``
    with the eager step's kernels on the same tensors.  The cache's
    tensors are the graph's buffers: they are updated in place,
    ``seq_lens`` included, and the same dict is returned; the capture's
    warm-up steps are undone before the first replay."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.graph = None

    def _capture(self) -> None:
        cfg, params, cache = self.cfg, self.params, self.cache
        saved = {k: v.clone() for k, v in cache.items()}
        self.tokens = torch.zeros_like(cache["seq_lens"])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # lazy inits off the capture
            for _ in range(2):
                E.serve_step(cfg, None, params, self.tokens, cache)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, out = E.serve_step(cfg, None, params, self.tokens,
                                            cache)
        self.next_lens = out["seq_lens"]
        for k, v in cache.items():
            v.copy_(saved[k])

    def __call__(self, tokens: torch.Tensor, cache: dict):
        if cache["S"] is not self.cache["S"]:
            raise ValueError("a GraphedStep steps the cache it was made on")
        if self.graph is None:
            with torch.cuda.device(cache["S"].device):
                self._capture()
        self.tokens.copy_(tokens)
        self.graph.replay()
        cache["seq_lens"].copy_(self.next_lens)
        return self.logits.clone(), cache


def stepper(cfg: ModelConfig, geom, params: dict, cache):
    """The launcher's decode step on ``cache``, ``step(tokens, cache) ->
    (logits, cache)``: ``GraphedStep`` for a state cache on a card, else
    ``engine.serve_step`` itself."""
    if geom is None and cache["S"].is_cuda:
        return GraphedStep(cfg, params, cache)
    return lambda tokens, c: E.serve_step(cfg, geom, params, tokens, c)


def run_prefill(cfg, geom, params, prompts: torch.Tensor, cache):
    """Prefill ``prompts`` (B, S); returns (last logits (B, V), cache).
    With a page geometry: bulk-prefill the page-aligned head, then feed
    the tail token by token.  Without one (ssm, hybrid): feed every token
    through the ``stepper``."""
    S = prompts.shape[1]
    if geom is None:
        lg, step = None, stepper(cfg, None, params, cache)
        for t in range(S):
            lg, cache = step(prompts[:, t], cache)
        return lg, cache
    pl = max(S - S % geom.page_size, geom.page_size)
    lg, cache = E.prefill(cfg, geom, params, prompts[:, :pl], cache)
    for t in range(pl, S):
        lg, cache = E.serve_step(cfg, geom, params, prompts[:, t], cache)
    return lg, cache


def run_decode(cfg, geom, params, logits, cache, gen: int):
    """Greedy decode of ``gen`` tokens from ``logits``: the first from the
    prefill's logits, then one ``stepper`` step per further token.
    Returns (tokens (B, gen) int32, last step's logits, cache)."""
    tok = logits.argmax(-1).to(torch.int32)
    out, step = [tok], stepper(cfg, geom, params, cache)
    for _ in range(gen - 1):
        logits, cache = step(tok, cache)
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
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"])
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
    if cfg.family in ("ssm", "hybrid"):
        geom = None
        cache = make_state_cache(cfg, args.batch, args.prompt_len, args.gen,
                                 device=dev)
    else:
        geom = make_geometry(cfg, args.batch, args.prompt_len, args.gen,
                             page_size=args.page_size, shards=args.shards,
                             kv_dtype=args.kv_dtype, device=dev)
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
    if geom is not None:
        print(f"page table: {sum(int(t.count) for t in cache.table)} "
              f"mappings, {int(cache.next_free.sum())} pages allocated, "
              f"pool={geom.pool_pages}/shard x {geom.shards} shards")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {toks[b, :16].tolist()}")


if __name__ == "__main__":
    main()
