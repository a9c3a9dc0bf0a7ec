"""The paged serving step under a (2, 2) mesh, run on either package for
``tests/test_torch_sharded_serving.py``.

``CASES`` names each run: a smoke config, its model dtype, its KV pages'
dtype, the merged path or not, and whether it starts with a prefill (the
int8 case decodes token by token from an empty cache: the reference's
int8 prefill writes zeros, ROADMAP Queue 3).  The geometry is
``tests/test_serving.py``'s: 2 data shards, page size 16, batch 4; a
prefill of 32 tokens keeps ``PROMPT_LEN`` of them, so the decode steps
write the last slots of the second page (the model axis's second slice
of it) and then open a third page (its first slice).

``reference_main`` runs each case on the JAX package over 4 forced XLA
host devices as a (2, 2) ``("data", "model")`` mesh, jitted with the
shardings of its dry run (``src/repro/launch/dryrun.py``: parameters and
cache placed by their logical axes), and saves the logits and the
global cache.  ``port_main`` spawns 4 gloo ranks that run each case on
the port from the reference's parameters (``inputs``), every rank on its
shard of the cache (``kvcache.shard_cache``); each saves its logits and
its own shard's page tables, sequence fields and pools, rank 0 also the
gathered cache (``kvcache.gather_cache``) and the port's unsharded run of
the same case.  Rank 0 then runs every case again alone on a (1, 1) mesh
(a one-rank gloo group; under ``world1/``), where every placement is
``Replicate()`` and each slice a whole page.
"""

import numpy as np

MESH = (2, 2)
WORLD = MESH[0] * MESH[1]
SHARDS, PAGE, BATCH, SEQ = 2, 16, 4, 128
PROMPT, PROMPT_LEN = 32, 27
CASES = {
    "float32": dict(arch="yi-6b", dtype="float32", kv=None, merged=False,
                    prefill=True, steps=6),
    "bfloat16": dict(arch="yi-6b", dtype="bfloat16", kv=None, merged=False,
                     prefill=True, steps=6),
    "int8": dict(arch="yi-6b", dtype="float32", kv="int8", merged=False,
                 prefill=False, steps=10),
    "merged": dict(arch="yi-6b", dtype="float32", kv=None, merged=True,
                   prefill=True, steps=6),
    "moe": dict(arch="granite-moe-1b-a400m", dtype="float32", kv=None,
                merged=False, prefill=True, steps=6),
}
SMALL = ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")
POOLS = ("kpool", "vpool", "kscale", "vscale")


def tokens(case, vocab):
    """(prompt (B, PROMPT), fed tokens (B, steps)) int32 of a case."""
    rng = np.random.RandomState(sorted(CASES).index(case))
    return (rng.randint(0, vocab, (BATCH, PROMPT)).astype(np.int32),
            rng.randint(0, vocab, (BATCH, CASES[case]["steps"]))
            .astype(np.int32))


def _flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _tree(flat: dict, prefix: str) -> dict:
    out = {"blocks": {}}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k.startswith("blocks."):
            out["blocks"][k[len("blocks."):]] = v
        else:
            out[k] = v
    return out


def _jax_setup(case):
    import dataclasses
    import jax
    from repro.configs import smoke_config
    from repro.models import transformer as JT
    c = CASES[case]
    cfg = dataclasses.replace(smoke_config(c["arch"]), dtype=c["dtype"])
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def make_inputs(path):
    """Every case's reference parameters (float32 values) in one file."""
    out = {}
    for case in CASES:
        _, params = _jax_setup(case)
        out.update(_flat(params, f"{case}/"))
    np.savez(path, **out)


def _state(cache) -> dict:
    """The reference's cache as numpy (uint32 words as int32 bits)."""
    out = {f: _bits(np.asarray(getattr(cache, f))) for f in SMALL}
    for f in POOLS:
        if getattr(cache, f) is not None:
            a = np.asarray(getattr(cache, f))
            out[f] = a if a.dtype == np.int8 else a.astype(np.float32)
    for f in cache.table._fields:
        out[f"table.{f}"] = _bits(np.asarray(getattr(cache.table, f)))
    return out


def reference_main(out):
    import jax
    import jax.numpy as jnp
    from repro.distribution.sharding import named_sharding, use_mesh
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as JT
    from repro.models.config import ShapeConfig
    from repro.serving import engine as JE
    from repro.serving import kvcache as JKC

    def named(axes, structs):
        return jax.tree.map(
            lambda ax, s: None if s is None else named_sharding(
                *(ax if ax is not None else (None,) * s.ndim),
                size_of=s.shape),
            axes, structs,
            is_leaf=lambda x: x is None or (isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x)))

    assert jax.device_count() == WORLD, jax.devices()
    mesh = make_debug_mesh(MESH, ("data", "model"))
    rec = {}
    for case, c in CASES.items():
        cfg, params = _jax_setup(case)
        prompt, toks = tokens(case, cfg.vocab)
        with use_mesh(mesh):
            geom = JKC.make_geometry(
                cfg, ShapeConfig("t", seq_len=SEQ, global_batch=BATCH,
                                 kind="decode"),
                shards=SHARDS, page_size=PAGE, kv_dtype=c["kv"],
                merged_attn=c["merged"])
            cache = JKC.create_cache(geom)
            p_sh = named(JT.param_logical_axes(cfg, params), params)
            c_sh = named(JKC.cache_logical_axes(geom, cache), cache)
            params = jax.device_put(params, p_sh)
            cache = jax.device_put(cache, c_sh)
            logits = []
            if c["prefill"]:
                fill = jax.jit(
                    lambda p, x, c_: JE.prefill(cfg, geom, p, x, c_,
                                                prompt_len=PROMPT_LEN),
                    in_shardings=(p_sh, named_sharding(
                        "batch", None, size_of=prompt.shape), c_sh),
                    out_shardings=(None, c_sh))
                lg, cache = fill(params, jnp.asarray(prompt), cache)
                logits.append(np.asarray(lg, np.float32))
            step = jax.jit(
                lambda p, t, c_: JE.serve_step(cfg, geom, p, t, c_),
                in_shardings=(p_sh, named_sharding(
                    "batch", size_of=(BATCH,)), c_sh),
                out_shardings=(None, c_sh))
            for t in range(toks.shape[1]):
                lg, cache = step(params, jnp.asarray(toks[:, t]), cache)
                logits.append(np.asarray(lg, np.float32))
        rec[f"{case}/logits"] = np.stack(logits)
        rec.update({f"{case}/{k}": v for k, v in _state(cache).items()})
    np.savez(out, **rec)


def _bits(a):
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _port_state(convert, cache) -> dict:
    """The port's cache as ``_state`` gives the reference's."""
    st = convert.cache_to_numpy(cache)
    out = {f: _bits(st[f]) for f in SMALL}
    out.update({f: st[f] for f in POOLS if st[f] is not None})
    out.update({f"table.{k}": _bits(v) for k, v in st["table"].items()})
    return out


def _port_case(torch, case, inp, mesh, rank):
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.distribution import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    c = CASES[case]
    cfg = dataclasses.replace(smoke_config(c["arch"]), dtype=c["dtype"])
    params = convert.params_from_numpy(_tree(inp, f"{case}/"), cfg, "cpu")
    prompt, toks = (torch.from_numpy(a) for a in tokens(case, cfg.vocab))
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="decode")

    def run(geom, cache, p):
        logits = []
        if c["prefill"]:
            lg, cache = E.prefill(cfg, geom, p, prompt, cache,
                                  prompt_len=PROMPT_LEN)
            logits.append(lg.float().numpy())
        for t in range(toks.shape[1]):
            lg, cache = E.serve_step(cfg, geom, p, toks[:, t], cache)
            logits.append(lg.float().numpy())
        return np.stack(logits), cache

    geom = KC.make_geometry(cfg, shape, shards=SHARDS, page_size=PAGE,
                            kv_dtype=c["kv"], merged_attn=c["merged"],
                            device="cpu")
    out = {}
    with SH.use_mesh(mesh):
        p = SH.distribute(params, T.param_logical_axes(cfg, params))
        lgeom, local = KC.shard_cache(geom, KC.create_cache(geom))
        out["slice"] = np.asarray([lgeom.shards, lgeom.page_slices,
                                   lgeom.page_slice, lgeom.token_offset])
        out["logits"], local = run(lgeom, local, p)
        out.update({f"local.{k}": v for k, v in
                    _port_state(convert, local).items()})
        full = KC.gather_cache(geom, local)
    if rank == 0:
        out.update({f"gathered.{k}": v for k, v in
                    _port_state(convert, full).items()})
        geom = KC.make_geometry(cfg, shape, shards=SHARDS, page_size=PAGE,
                                kv_dtype=c["kv"], merged_attn=c["merged"],
                                device="cpu")
        out["unsharded_logits"], cache = run(geom, KC.create_cache(geom),
                                             params)
        out.update({f"unsharded.{k}": v for k, v in
                    _port_state(convert, cache).items()})
    return {f"{case}/{k}": v for k, v in out.items()}


def _rank(rank, world, ports, inputs, outdir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_debug_mesh
    inp = dict(np.load(inputs))
    rec = {}
    for shape, n, at in ((MESH, world, ports[0]), ((1, 1), 1, ports[1])):
        if rank >= n:
            break
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{at}",
                                rank=rank, world_size=n)
        try:
            mesh = make_debug_mesh(shape, ("data", "model"),
                                   device_type="cpu")
            tag = "" if n == world else "world1/"
            with torch.no_grad():
                for case in CASES:
                    rec.update({tag + k: v for k, v in _port_case(
                        torch, case, inp, mesh, rank).items()})
        finally:
            dist.destroy_process_group()
    np.savez(f"{outdir}/rank{rank}.npz", **rec)


def port_main(inputs, outdir, world=WORLD):
    import torch.multiprocessing as mp
    from _distscenarios import free_port
    ports = (free_port(), free_port())    # the mesh's group, world 1's
    mp.start_processes(_rank, args=(world, ports, inputs, outdir),
                       nprocs=world, start_method="spawn")
