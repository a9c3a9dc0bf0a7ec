"""Multi-pod dry run: build and run every (arch x shape x mesh) cell's step
on the production mesh without a card and without allocation.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step with XLA over 512 placeholder devices and reads XLA's memory and cost
analyses and the compiled HLO.  Here, for each cell:
  1. a fake process group of 256 or 512 ranks (``torch.distributed``'s
     ``fake`` backend, whose collectives move no data) carries the
     production mesh, (16, 16) or (2, 16, 16);
  2. parameters, optimizer state, caches and inputs are meta tensors
     (shapes, no storage), placed as DTensors by their logical axes;
  3. the step runs once on rank 0's shards under ``CollectiveBytes``,
     ``CommDebugMode`` counting every collective by kind with its bytes
     taken from its input's shape and its group's size;
  4. one JSON per cell under ``experiments/dryrun/`` in the reference's
     layout: bytes per device from the local shard shapes, the analytic
     FLOPs / HBM model (``launch.analytic``), the collectives and the
     roofline terms.  Fields only XLA produces (the compiled cost
     analysis, temp / alias bytes and the peak built on them, the compile
     time) are null and listed under ``"absent"``.

The HLO text parsers (``collective_bytes``, ``collective_bytes_weighted``)
are the reference's, kept for HLO text a caller has.  The continuity KV
service itself runs as pseudo-arch ``continuity-kv`` (read / write /
level-style 4-fetch read).  The paged prefill and decode cells of the
full-attention families run the serving engine on rank 0's shard of the
paged cache (``kvcache.shard_cache``: its data shard's pages, its slice of
each page's tokens, split-KV over the model axis), with the reference's
overrides (``page_size``, ``oversub``, ``kv_dtype``, ``paged_merged``,
``serve_bf16``); on meta tensors the page-table upkeep and the attention
kernel give shapes only.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback

import torch
from torch.distributed.tensor.debug import CommDebugMode

# hardware constants: one NVIDIA H100 SXM5, from NVIDIA's datasheet
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink bytes/s per direction (900 GB/s both)

_COLL_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64)"
                       r"\[([0-9,]*)\]")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_EXPL_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
          "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
          "u64": 8}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _BYTES[dtype]


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    m = _GROUPS_EXPL_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 1


def _ring(op: str, r: int, g: int):
    """(operand bytes, wire bytes per device) of collective ``op`` whose
    RESULT is ``r`` bytes over a group of ``g`` (ring model):
      operand bytes: all-gather = result/g; reduce-scatter = result*g;
                     others = result.
      wire bytes: all-reduce 2*r*(g-1)/g; all-gather r*(g-1)/g;
        reduce-scatter r*(g-1); all-to-all r*(g-1)/g; collective-permute r.
    """
    if op == "all-gather":
        return r // g, r * (g - 1) // g
    if op == "reduce-scatter":
        return r * g, r * (g - 1)
    if op == "all-reduce":
        return r, 2 * r * (g - 1) // g
    if op == "all-to-all":
        return r, r * (g - 1) // g
    return r, r                              # collective-permute


def collective_bytes(hlo_text: str) -> dict:
    """Per-collective accounting from the per-device optimized HLO.

    Optimized HLO prints operands as bare names, so sizes are derived from
    the RESULT shape + replica-group size g (``_ring``).  The roofline
    collective term uses wire bytes.
    """
    out = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or "= " not in line:
            continue
        op = m.group(1)
        shapes = [_shape_bytes(d, s)
                  for d, s in _SHAPE_RE.findall(line[:m.start()])]
        if not shapes:
            continue
        operand, wire = _ring(op, max(shapes), _group_size(line))
        rec = out.setdefault(op, {"count": 0, "bytes": 0, "wire_bytes": 0})
        rec["count"] += 1
        rec["bytes"] += operand
        rec["wire_bytes"] += wire
    return out


_COMP_RE = re.compile(r"^(ENTRY )?%?([\w\.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$")
_WHILE_RE = re.compile(r"while\(.*?\)\s*,\s*condition=%?([\w\.\-]+)\s*,\s*"
                       r"body=%?([\w\.\-]+)")
_CALLEE_RE = re.compile(r"(?:to_apply|body|condition|branch_computations)="
                        r"\{?%?([\w\.\-]+(?:,\s*%?[\w\.\-]+)*)\}?")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _split_computations(text: str):
    """HLO text -> ({name: [lines]}, entry_name)."""
    comps, cur, entry = {}, None, None
    for line in text.splitlines():
        m = _COMP_RE.match(line.strip())
        if m and ("{" in line):
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
            continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    return comps, entry


def _trip_count(cond_lines) -> int:
    """Scan-style while conditions compare the induction var to a constant:
    the largest (sane) integer constant in the condition is the trip count."""
    best = 1
    for line in cond_lines:
        for m in _CONST_RE.finditer(line):
            v = int(m.group(1))
            if v <= 1_000_000:           # ignore sentinel/mask constants
                best = max(best, v)
    return best


def collective_bytes_weighted(text: str) -> dict:
    """Collective accounting with while-bodies weighted by their trip counts
    (naive text scans count scan bodies once)."""
    comps, entry = _split_computations(text)
    if entry is None:
        return collective_bytes(text)
    out = {}

    def add(line, mult):
        m = _COLL_RE.search(line)
        if not m or "= " not in line:
            return
        op = m.group(1)
        shapes = [_shape_bytes(d, s)
                  for d, s in _SHAPE_RE.findall(line[:m.start()])]
        if not shapes:
            return
        operand, wire = _ring(op, max(shapes), _group_size(line))
        rec = out.setdefault(op, {"count": 0, "bytes": 0, "wire_bytes": 0})
        rec["count"] += mult
        rec["bytes"] += operand * mult
        rec["wire_bytes"] += wire * mult

    def walk(name, mult, depth=0):
        if name not in comps or depth > 32:   # HLO call graphs are DAGs
            return
        for line in comps[name]:
            wm = _WHILE_RE.search(line)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trip = _trip_count(comps.get(cond, []))
                walk(body, mult * trip, depth + 1)
                continue
            add(line, mult)
            cm = _CALLEE_RE.search(line)
            if cm and "while(" not in line:
                for callee in cm.group(1).replace("%", "").split(","):
                    walk(callee.strip(), mult, depth + 1)

    walk(entry, 1)
    return out


# -- collectives of a run ------------------------------------------------------

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "collective-permute"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _group_of(args) -> int:
    """The size of the process group a collective's arguments name: a
    functional collective's group name (its last string argument), or a
    c10d op's boxed ``ProcessGroup``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # another boxed argument (ReduceOp)
                continue
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError(f"no process group among {args!r}")


class CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that also adds up, per kind, each collective's
    operand and ring-model wire bytes on this rank, from its input's
    shape and its group's size (the reference's per-device HLO
    accounting, ``_ring``)."""

    def __init__(self):
        super().__init__()
        self.colls: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func,
                                               torch._ops.HigherOrderOperator):
            return out
        name = func._overloadpacket.__name__
        kind = next((k for s, k in _KINDS if s in name), None)
        if kind is None:
            return out
        # the input: c10d's alltoall_base_ takes (output, input, ...)
        src = args[1] if name.startswith("alltoall_base") else args[0]
        t = next(_tensors(src))
        nbytes = t.numel() * t.element_size()
        g = _group_of(args)
        result = {"all-gather": nbytes * g,
                  "reduce-scatter": nbytes // g}.get(kind, nbytes)
        operand, wire = _ring(kind, result, g)
        rec = self.colls.setdefault(kind, {"count": 0, "bytes": 0,
                                           "wire_bytes": 0})
        rec["count"] += 1
        rec["bytes"] += operand
        rec["wire_bytes"] += wire
        return out


@contextlib.contextmanager
def fake_world(ranks: int):
    """A fake process group of ``ranks`` ranks in this process (rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_mesh(multi_pod: bool):
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _meta_params(cfg):
    """The config's parameters (float32 masters) as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    with FakeTensorMode():
        fake = T.init_params(cfg, torch.Generator().manual_seed(0),
                             master_dtype=torch.float32)
    return O.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), fake)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def local_bytes(*trees) -> int:
    """Bytes this rank holds of the trees' tensors (a DTensor's local
    shard)."""
    from repro_torch.distribution.sharding import is_dtensor
    n = 0
    for tree in trees:
        for t in _leaves(tree):
            loc = t.to_local() if is_dtensor(t) else t
            n += loc.numel() * loc.element_size()
    return n


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


_ABSENT_CELL = ["compile_seconds", "memory.temp_bytes_per_device",
                "memory.alias_bytes_per_device",
                "memory.peak_estimate_per_device", "cost_hlo_floor"]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None):
    """Build and run one cell's step on the fake production mesh; returns
    (record, None) (the reference's second value is XLA's executable)."""
    from repro_torch.configs import get_arch
    from repro_torch.distribution import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.config import (SHAPES, input_specs,
                                           shape_applicable)
    from repro_torch.serving import kvcache as KC
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step, place_state

    cfg = get_arch(arch)
    if overrides:
        fields = {f.name for f in dataclasses.fields(cfg)}
        cfg_over = {k: v for k, v in overrides.items() if k in fields}
        if "moe_impl" in overrides and cfg.moe is not None:
            cfg_over["moe"] = dataclasses.replace(
                cfg.moe, impl=overrides["moe_impl"])
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_tag(multi_pod),
                "status": "skipped", "reason": why}, None
    chips = 512 if multi_pod else 256
    dp = chips // 16                      # pod x data extent
    # sequence parallelism (Megatron-SP): shard the residual stream's seq
    # dim over the model axis
    rules = ({"seq": ("model",)} if (overrides or {}).get("seq_parallel")
             else None)
    # meta tensors hold no data: a data-dependent size (the MoE dispatch's
    # kept assignments) is taken at its bound, every element kept
    from torch.fx.experimental import _config as fx_config
    with fake_world(chips), fx_config.patch(
            meta_nonzero_assume_all_nonzero=True):
        mesh = build_mesh(multi_pod)
        with SH.use_mesh(mesh, rules), torch.no_grad():
            params = _meta_params(cfg)
            batch = input_specs(cfg, shape)
            t0 = time.time()
            counter = CollectiveBytes()
            if shape.kind == "train":
                opt_cfg = O.OptConfig()
                p, s = place_state(cfg, opt_cfg, params, O.init(params))
                placed = {k: SH.shard(v, "batch", *(None,) * (v.dim() - 1))
                          for k, v in batch.items()}
                args = local_bytes(p, s, placed)
                step = make_train_step(
                    cfg, opt_cfg,
                    num_micro=(overrides or {}).get("num_micro", 1))
                with torch.enable_grad(), counter:
                    p, s, _ = step(p, s, batch)
                outs = local_bytes(p, s)
            else:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                if (overrides or {}).get("serve_bf16"):
                    # serving reads bf16 weights (the f32 masters live
                    # with the trainer)
                    params = O.tree_map(
                        lambda t: t.to(torch.bfloat16)
                        if t.dtype == torch.float32 else t, params)
                p = SH.distribute(params, T.param_logical_axes(cfg, params))
                x = SH.shard(batch["inputs"], "batch",
                             *(None,) * (batch["inputs"].dim() - 1))
                from repro_torch.serving import engine as E
                if cfg.family not in ("ssm", "hybrid"):
                    # the paged cache, this rank's shard of it (its data
                    # shard's pages, its slice of each page's tokens)
                    over = overrides or {}
                    geom = KC.make_geometry(
                        cfg, shape, shards=dp,
                        page_size=over.get("page_size", 512),
                        oversub=over.get("oversub", 1.0),
                        kv_dtype=over.get("kv_dtype"),
                        merged_attn=(shape.kind == "decode"
                                     and over.get("paged_merged", False)),
                        device="meta")
                    geom, cache = KC.shard_cache(geom,
                                                 KC.create_cache(geom))
                    args = local_bytes(p, x, cache)
                    with counter:
                        if shape.kind == "prefill":
                            logits, cache = E.prefill(cfg, geom, p, x, cache)
                        else:
                            logits, cache = E.serve_step(cfg, geom, p, x,
                                                         cache)
                    outs = local_bytes(logits, cache)
                elif shape.kind == "prefill":
                    # recurrent archs: prefill = full forward
                    with counter, implicit_replication():
                        logits = T.logits_fn(
                            cfg, p, T.forward(cfg, p, x)[0][:, -1])
                    args, outs = local_bytes(p, x), local_bytes(logits)
                else:
                    cache = KC.create_state_cache(
                        cfg, shape.global_batch, shape.seq_len,
                        dtype=torch.bfloat16, device="meta")
                    cache = SH.distribute(
                        cache, KC.state_cache_logical_axes(cfg, cache))
                    args = local_bytes(p, x, cache)
                    with counter, implicit_replication():
                        logits, cache = E.serve_step(cfg, None, p, x, cache)
                    outs = local_bytes(logits, cache)
            trace_s = time.time() - t0

    from repro_torch.launch.analytic import model_cell
    colls = counter.colls
    coll_total = sum(v["wire_bytes"] for v in colls.values())
    kvb = 1 if (overrides or {}).get("kv_dtype") == "int8" else 2
    am = model_cell(cfg, shape, chips, tp=16, kv_bytes=kvb)
    flops_dev = am.flops_total / chips
    bytes_dev = am.hbm_bytes_dev
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": coll_total / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    step_s = max(sum(terms.values()), 1e-30)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
        "chips": chips, "status": "ok",
        "compile_seconds": None,
        "trace_seconds": round(trace_s, 1),
        "overrides": overrides or {},
        "memory": {
            "argument_bytes_per_device": args,
            "output_bytes_per_device": outs,
            "temp_bytes_per_device": None,
            "alias_bytes_per_device": None,
            "peak_estimate_per_device": None,
        },
        "cost_hlo_floor": None,
        "analytic": {"flops_total": am.flops_total,
                     "flops_useful": am.flops_useful,
                     "hbm_bytes_per_device": am.hbm_bytes_dev,
                     "notes": am.notes},
        "collectives": colls,
        "collective_wire_bytes_per_device": coll_total,
        "roofline": {**terms, "dominant": dominant,
                     "bound_fraction": terms[dominant] / step_s},
        "model_flops": am.flops_useful,
        "useful_flops_ratio": am.flops_useful / max(am.flops_total, 1.0),
        # fraction of hardware peak the USEFUL flops achieve at the modeled
        # step time (higher = closer to roofline)
        "roofline_fraction": am.flops_useful / chips / PEAK_FLOPS / step_s,
        "absent": list(_ABSENT_CELL),
    }
    return rec, None


def lower_kv_cell(shape_name: str, multi_pod: bool):
    """Dry-run the distributed continuity KV service itself: one client
    batch of 4,096 requests on rank 0 of the production mesh, against its
    shard of the 2^22-bucket service table (meta tensors)."""
    import repro_torch.core.distributed as D
    from repro_torch.core import continuity as ch

    chips = 512 if multi_pod else 256
    dp = chips // 16
    # production-scale service: 2^22 buckets (~42M slot capacity), 4096
    # requests per client device batch
    scfg = D.StoreConfig(
        table=ch.ContinuityConfig(num_buckets=1 << 22, ext_frac=0.0),
        num_shards=dp,
        axis_names=("pod", "data") if multi_pod else ("data",))
    B = 4096

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    t0 = time.time()
    with fake_world(chips):
        mesh = build_mesh(multi_pod)
        table = D.create_sharded(scfg, "meta")
        keys, vals, ops = meta((B, 4)), meta((B, 4)), meta((B,))
        counter = CollectiveBytes()
        if shape_name in ("kv_read", "kv_read_level"):
            fn = (D.make_lookup(scfg, mesh) if shape_name == "kv_read"
                  else D.make_lookup_multifetch(scfg, mesh, fetches=4))
            mask = meta((B,), torch.bool)
            with counter:
                fn(table, keys, mask)
            args = local_bytes(table, keys, mask)
        else:
            fn = D.make_write(scfg, mesh)
            with counter:
                fn(table, ops, keys, vals)
            args = local_bytes(table, ops, keys, vals)
    colls = counter.colls
    coll_total = sum(v["wire_bytes"] for v in colls.values())
    rec = {
        "arch": "continuity-kv", "shape": shape_name,
        "mesh": _mesh_tag(multi_pod), "chips": chips,
        "status": "ok", "compile_seconds": None,
        "trace_seconds": round(time.time() - t0, 1),
        "memory": {"argument_bytes_per_device": args,
                   "temp_bytes_per_device": None},
        "cost": None,
        "collectives": colls,
        "collective_bytes_per_device": coll_total,
        "roofline": {"compute_s": None, "memory_s": None,
                     "collective_s": coll_total / LINK_BW,
                     "dominant": None},
        "absent": ["compile_seconds", "memory.temp_bytes_per_device", "cost",
                   "roofline.compute_s", "roofline.memory_s",
                   "roofline.dominant"],
    }
    return rec, None


def run_cell(arch, shape, multi_pod, outdir, force=False, overrides=None,
             tag=""):
    name = f"{arch}_{shape}_{_mesh_tag(multi_pod)}{tag}.json"
    path = os.path.join(outdir, name)
    if os.path.exists(path) and not force:
        print(f"[skip-cached] {name}")
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    try:
        if arch == "continuity-kv":
            rec, _ = lower_kv_cell(shape, multi_pod)
        else:
            rec, _ = lower_cell(arch, shape, multi_pod, overrides)
    except Exception as e:  # a failure here is a bug in the system
        rec = {"arch": arch, "shape": shape, "mesh": _mesh_tag(multi_pod),
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = " ".join(f"{k[:-2]}={r[k]:.2e}s" for k in
                         ("compute_s", "memory_s", "collective_s")
                         if r[k] is not None)
        extra = f" dom={r['dominant']} {extra}"
    print(f"[{status}] {name} ({time.time()-t0:.0f}s){extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    from repro_torch.models.config import SHAPES

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
        cells += [("continuity-kv", "kv_read"), ("continuity-kv", "kv_write"),
                  ("continuity-kv", "kv_read_level")]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    out = []
    for mp in meshes:
        for arch, shape in cells:
            out.append(run_cell(arch, shape, mp, args.out, force=args.force))
    return out


if __name__ == "__main__":
    main()
