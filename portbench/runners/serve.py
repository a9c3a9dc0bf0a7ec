"""Runner of a served-model configuration: the port's paged serving path.

Set-up: the weights are made on the device from the seed
(``make_weights``, one call per stacked leaf, in the dtype they are
served in), the paged cache is built with ``launch.serve.make_geometry``
for one group, and ``warmup_groups`` groups run untimed.  The window runs
groups back to back: each group's prompts are drawn on the device, then
``launch.serve.run_prefill`` fills the cache, ``launch.serve.run_decode``
serves the greedy tokens through ``serve.stepper`` and every sequence is
freed with ``serving.engine.release_sequence``; the page table lives on
across groups, as in a server.  The window closes at the first group
boundary past ``seconds``.

Checked after the window: ``check_requests`` served requests drawn from
the seed, each prompt with its served tokens run once through the plain
float32 reference (``refs/llama.py``), by how far each served token's
logit lies below the reference's best (``logit_gap``; under the
``fp8_control`` plant the fp8 reference's first choices stand in the
served tokens' place); and each group's
page table, read after its last step, against the mappings its requests
need (``refs/pagetable.py``).
"""

from __future__ import annotations

import time

import torch

from portbench import counters as C
from portbench import harness as H
from portbench import plants, traffic
from portbench.refs import llama, pagetable

BF16 = torch.bfloat16


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_config(cj: dict):
    """The program's model configuration for the configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=cj["name"], family="dense", n_layers=cj["num_hidden_layers"],
        d_model=cj["hidden_size"], n_heads=cj["num_attention_heads"],
        n_kv_heads=cj["num_key_value_heads"], d_ff=cj["intermediate_size"],
        vocab=cj["vocab_size"], norm="rms", mlp="swiglu", rope=True,
        rope_theta=cj["rope_theta"],
        tie_embeddings=cj["tie_word_embeddings"], dtype=cj["torch_dtype"])


def make_weights(cj: dict, seed: int, device) -> dict:
    """Random weights from the seed, on the device, in the layout the
    program takes (stacked per layer, stored (in, out)): bf16 embeddings
    and projections N(0, std), the output projections ``wo`` and
    ``w_down`` scaled by 1/sqrt(2 * layers), float32 norm scales of 1 and
    a float32 output head N(0, std).  With embeddings as small as the
    projections, each layer's attention moves the residual stream, so a
    fault in the attention or the pages shows in the logits.""" 
    g = traffic.generator(seed, "weights", device)
    L, E = cj["num_hidden_layers"], cj["hidden_size"]
    H, KVH = cj["num_attention_heads"], cj["num_key_value_heads"]
    D, F, V = E // H, cj["intermediate_size"], cj["vocab_size"]
    std = cj["init_std"]

    def normal(shape, scale, dtype=BF16):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)
    out_std = std / (2 * L) ** 0.5
    ones = torch.ones((L, E), dtype=torch.float32, device=device)
    blocks = {"ln1_scale": ones, "ln2_scale": ones.clone(),
              "wq": normal((L, E, H * D), std),
              "wk": normal((L, E, KVH * D), std),
              "wv": normal((L, E, KVH * D), std),
              "wo": normal((L, H * D, E), out_std),
              "w_gate": normal((L, E, F), std),
              "w_up": normal((L, E, F), std),
              "w_down": normal((L, F, E), out_std)}
    return {"embed": normal((V, E), std), "blocks": blocks,
            "final_scale": torch.ones(E, dtype=torch.float32, device=device),
            "lm_head": normal((E, V), std, torch.float32)}


def _snapshot(table) -> object:
    return type(table)(*(x.clone() for x in table))


def run(cell: H.Cell, *, t_start: float) -> H.Outcome:
    from repro_torch.launch import serve
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC

    cj, mix, dev, rec = cell.config, cell.traffic, cell.device, cell.rec
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = model_config(cj)
    params = make_weights(cj, cell.seed, dev)
    gen = traffic.ServeTraffic(mix, cj["vocab_size"], cell.seed, dev)
    G, P, N = gen.group, gen.prompt_len, gen.output_tokens
    geom = serve.make_geometry(cfg, G, P, N, page_size=cj["page_size"],
                               shards=1, device=str(dev))
    cache = KC.create_cache(geom)
    groups = []       # per group: served tokens, page table, sequence ids

    def one_group(timed: bool):
        nonlocal cache
        prompts = gen.next()
        t0 = time.perf_counter()
        with H.label("prefill"):
            lg, cache = serve.run_prefill(cfg, geom, params, prompts, cache)
            sync(dev)
        t1 = time.perf_counter()
        with H.label("decode"):
            toks, _, cache = serve.run_decode(cfg, geom, params, lg, cache,
                                              N)
            sync(dev)
        t2 = time.perf_counter()
        groups.append((toks, _snapshot(cache.table[0]),
                       cache.seq_ids[0].clone()))
        with H.label("release"):
            for b in range(G):
                cache = E.release_sequence(geom, cache, 0, b)
            sync(dev)
        if timed:
            rec.span("prefill", t1 - t0)
            rec.span("decode", t2 - t1)
            rec.count("decode_steps", N - 1)

    with plants.planted("serve", cell.plant):
        for _ in range(int(mix["warmup_groups"])):
            one_group(False)
        first = len(groups)
        setup_s = time.perf_counter() - t_start
        t_open = time.perf_counter()
        n_groups = 0
        while True:
            one_group(True)
            n_groups += 1
            if time.perf_counter() - t_open >= cell.seconds:
                break
        window_s = time.perf_counter() - t_open

        trace = None
        if cell.trace:
            from repro_torch.kernels import paged_attn
            before = paged_attn.paged_attention.launches
            n_prof = int(mix["profile_groups"])
            trace = H.profile_slice(
                lambda: [one_group(False) for _ in range(n_prof)])
            H_, KVH = cj["num_attention_heads"], cj["num_key_value_heads"]
            rec.count("attn_bytes_profiled", n_prof * cfg.n_layers * sum(
                C.attn_bytes("bf16", G, H_, KVH, cj["hidden_size"] // H_,
                             geom.max_pages, P + k + 1)
                for k in range(N - 1)))
            rec.count("attn_launches_profiled",
                      paged_attn.paged_attention.launches - before)
            rec.count("profiled_units", n_prof)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pool_pages, max_pages = geom.pool_pages, -(-(P + N - 1) // geom.page_size)
    del cache, geom
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    per_group = G * (P + N)
    rec.count("flops_window", n_groups * C.group_flops(cj, G, P, N))
    e2e = {"tokens_s": n_groups * per_group / window_s, "setup_s": setup_s}
    checked = groups[first:]
    gap, program_gap = judge(cell, params, gen, groups, first)
    del params
    faults = sum(pagetable.audit(t, s, max_pages, pool_pages)
                 for _, t, s in checked)
    checks = [H.Check("logit_gap", gap, cj["limits"]["logit_gap"]),
              H.Check("page_map_wrong", faults, 0)]
    facts = {"groups": n_groups, "units": n_groups, "window_s": window_s}
    if program_gap is not None:
        facts["program_gap"] = program_gap
    return H.Outcome(e2e=e2e, attempted=n_groups * G, failed=0,
                     memory_peak_bytes=peak, checks=checks, trace=trace,
                     facts=facts)


def judge(cell, params, gen, groups, first):
    """The widest gap of a served token below the reference's best, over
    ``check_requests`` requests of the window's (and the profiled) groups
    drawn from the seed.  With the ``fp8_control`` plant the control is
    judged in the program's place: the widest gap of the tokens the fp8
    reference puts first at each position of the same prompts and served
    tokens, returned with the served tokens' own gap beside it."""
    cj, mix, dev = cell.config, cell.traffic, cell.device
    G, P, N = gen.group, gen.prompt_len, gen.output_tokens
    n = len(groups) - first
    k = min(int(mix["check_requests"]), n * G)
    g = traffic.generator(cell.seed, "check", dev)
    picks = sorted(torch.randperm(n * G, generator=g,
                                  device=dev)[:k].tolist())
    prompts, served = [], []
    gen.restart()
    by_group = {}
    for i in range(len(groups)):
        pr = gen.next()
        for j in picks:
            if first + j // G == i:
                by_group.setdefault(i, []).append((pr[j % G], j % G))
    for i, rows in sorted(by_group.items()):
        for pr, r in rows:
            prompts.append(pr)
            served.append(groups[i][0][r])
    control = "fp8_control" in cell.plant
    gaps, own = [], []
    block = 4
    for s in range(0, k, block):
        toks = torch.stack(served[s:s + block])
        seq = torch.cat([torch.stack(prompts[s:s + block]),
                         toks[:, :N - 1]], 1)
        ref = llama.logits(params, cj, seq, P - 1)
        own.append(llama.served_gaps(ref, toks).max())
        if control:
            low = llama.logits(params, cj, seq, P - 1, quant="fp8")
            gaps.append(llama.served_gaps(ref, low.argmax(-1)).max())
            del low
        del ref
    program = float(torch.stack(own).max())
    if not control:
        return program, None
    return float(torch.stack(gaps).max()), program
