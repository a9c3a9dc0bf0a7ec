"""The plain references against the program on small inputs on the CPU."""

import torch

from portbench import traffic, ycsb
from portbench.runners import serve as S
from portbench.runners import store as D
from portbench.refs import kvmap, llama, pagetable


def test_kvmap_follows_the_store_through_duplicate_updates(small):
    from repro_torch import api
    cfg = dict(small["store"]["config"], scheme="continuity",
               bucket_slots=4, sbuckets=3, ext_frac=0.1, stash_frac=0.125)
    store = D.make_store(cfg, torch.device("cpu"))
    table = store.create()
    n = cfg["record_count"]
    keys = ycsb.make_key(torch.arange(n))
    vals = D.record_values(cfg, 3, "cpu")
    table, res = store.insert(table, keys, vals)
    ref = kvmap.KVMap(n, vals, res.ok)
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        ids = torch.randint(0, n, (400,), generator=g)
        ids[200:300] = ids[:100]             # same-key updates in a batch
        uk, uv = ycsb.make_key(ids), ycsb.make_value(g, 400)
        table, ures = store.update(table, uk, uv)
        assert ref.update(uk, uv, ures.ok) == 0
    probe = torch.cat([keys, ycsb.make_key(ycsb.negative_ids(g, n, 300))])
    got = store.lookup(table, probe)
    found, values = ref.lookup(probe)
    assert isinstance(store, api.ContinuityStore)
    assert torch.equal(got.ok, found)
    assert torch.equal(got.values, values)


def _tiny_model(small, dtype):
    """The served configuration's file at the tests' small widths."""
    from portbench import harness as H
    cj = H.load_json(H.PKG / "configs" / "yi-6b-paged.json")
    cj.update(small["serve"]["config"], torch_dtype=dtype)
    return cj


def test_llama_reference_equals_the_programs_forward_in_float32(small):
    """The reference's equations against the program's forward, both at
    the program's norm epsilon (its rmsnorm fixes 1e-6; the served
    configuration states the source's 1e-5)."""
    from repro_torch.models import transformer as T
    cj = dict(_tiny_model(small, "float32"), rms_norm_eps=1e-6)
    w = S.make_weights(cj, 11, "cpu")
    w["embed"] = w["embed"].float()
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w["blocks"][k] = w["blocks"][k].float()
    cfg = S.model_config(cj)
    toks = torch.randint(0, cj["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(2))
    x, _ = T.forward(cfg, w, toks)
    want = T.logits_fn(cfg, w, x[:, 10:])
    got = llama.logits(w, cj, toks, 10)
    assert float((got - want).abs().max()) < 1e-4


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 1.125, -448.0]])
    q = llama.fp8(t, -1)
    assert q[0, 0] == 1.0 and q[0, 2] == 1.125 and q[0, 3] == -448.0
    assert q[0, 1] in (1.0, 1.125)


def test_page_audit_passes_the_programs_table_and_fails_a_broken_one(small):
    from repro_torch.launch import serve
    cj = _tiny_model(small, "bfloat16")
    cfg = S.model_config(cj)
    w = S.make_weights(cj, 5, "cpu")
    G, P, N = 4, 16, 5
    geom = serve.make_geometry(cfg, G, P, N, page_size=4, shards=1,
                               device="cpu")
    from repro_torch.serving import kvcache as KC
    cache = KC.create_cache(geom)
    prompts = traffic.ServeTraffic(
        {"kind": "serve", "group": G, "prompt_len": P, "output_tokens": N},
        cj["vocab_size"], 1, "cpu").next()
    lg, cache = serve.run_prefill(cfg, geom, w, prompts, cache)
    _, _, cache = serve.run_decode(cfg, geom, w, lg, cache, N)
    t, seqs = cache.table[0], cache.seq_ids[0]
    pages = -(-(P + N - 1) // 4)
    assert pagetable.audit(t, seqs, pages, geom.pool_pages) == 0
    assert pagetable.audit(t, seqs, pages + 1, geom.pool_pages) == G
    live = (t.indicator != 0).nonzero()[0, 0]
    t.indicator[live] = 0                 # a pair's entries lost
    assert pagetable.audit(t, seqs, pages, geom.pool_pages) > 0
