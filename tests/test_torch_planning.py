"""The port's planning tools against the JAX package's.

``launch.analytic``: every ``CellModel`` field equal as a Python float for
every (arch x shape x 256 / 512 chips) cell.  ``launch.dryrun``'s HLO
text parsers on the JAX package's synthetic line
(``tests/test_distributed.py``) and on a small HLO text with a ``while``
loop, equal to the reference's parsers.  One dry-run train cell
(``yi-6b`` x ``train_4k`` on the (16, 16) fake mesh), one paged serving
cell (``yi-6b`` x ``decode_32k``: split-KV decode on rank 0's shard of the
paged cache), the first rung of the hillclimb's ``qwen`` ladder and the
KV service's read and write cells, in a subprocess (the fake 256-rank
process group is global to its process): the reference's record layout,
the XLA-only fields null and listed as absent, the KV routes' and the
attention merge's collectives as their shapes give them.  The hillclimb
ladders equal the reference's.

The reference's ``launch.dryrun`` and ``launch.hillclimb`` set
``XLA_FLAGS`` when imported; it is put back at once, before any JAX
backend starts.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget
from repro.launch import analytic as JA
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import analytic as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.models.config import SHAPES

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _reference(name):
    """Import a reference launch module without keeping its XLA_FLAGS."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def test_configs_and_shapes_are_the_references():
    assert list(ARCHS) == list(JARCHS) and sorted(SHAPES) == sorted(JSHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_the_reference_in_every_cell(arch):
    for shape in SHAPES:
        for chips in (256, 512):
            for kvb in (1, 2):
                want = JA.model_cell(jget(arch), JSHAPES[shape], chips,
                                     tp=16, kv_bytes=kvb)
                got = A.model_cell(get_arch(arch), SHAPES[shape], chips,
                                   tp=16, kv_bytes=kvb)
                assert dataclasses.astuple(got) == dataclasses.astuple(want), \
                    (arch, shape, chips, kvb)
                assert all(type(x) is float for x in
                           dataclasses.astuple(got)[:3])


SYNTHETIC = ("  %all-gather.3 = bf16[16,4096,1024]{2,1,0} all-gather(%p), "
             "channel_id=4, replica_groups=[16,16]<=[256], dimensions={0}")

HLO_WHILE = """HloModule m

%body.1 (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %ar.1 = f32[8,128]{1,0} all-reduce(%x), channel_id=1, replica_groups={{0,1,2,3}}, to_apply=%add
  %rs.2 = bf16[2,128]{1,0} reduce-scatter(%y), channel_id=2, replica_groups=[64,4]<=[256], dimensions={0}
}

%cond.1 (p: (s32[], f32[8,128])) -> pred[] {
  %c = s32[] constant(12)
  %lt = pred[] compare(%i, %c), direction=LT
}

ENTRY %main.9 (a: f32[8,128]) -> f32[8,128] {
  %w = (s32[], f32[8,128]) while(%t), condition=%cond.1, body=%body.1
  %a2a = u32[16,513,3]{2,1,0} all-to-all(%s), channel_id=3, replica_groups=[1,16]<=[16], dimensions={0}
  %cp = f32[4]{0} collective-permute(%z), channel_id=4, source_target_pairs={{0,1}}
}
"""


def test_collective_bytes_on_the_synthetic_line():
    c = D.collective_bytes(SYNTHETIC)
    assert c["all-gather"]["count"] == 1
    assert c["all-gather"]["bytes"] == 16 * 4096 * 1024 * 2 // 16
    assert c == _reference("dryrun").collective_bytes(SYNTHETIC)


def test_weighted_parser_equals_the_reference_on_a_while_loop():
    J = _reference("dryrun")
    got = D.collective_bytes_weighted(HLO_WHILE)
    assert got == J.collective_bytes_weighted(HLO_WHILE)
    assert got["all-reduce"]["count"] == 12        # the body, 12 trips
    assert got["all-to-all"]["count"] == 1
    assert D._split_computations(HLO_WHILE) == J._split_computations(HLO_WHILE)
    assert D._trip_count(["%c = s32[] constant(12)",
                          "%m = s32[] constant(4294967295)"]) == 12
    assert D.collective_bytes(HLO_WHILE) == J.collective_bytes(HLO_WHILE)


def test_hillclimb_ladders_equal_the_references():
    assert H.LADDERS == _reference("hillclimb").LADDERS
    fields = {f.name for f in dataclasses.fields(get_arch("yi-6b"))}
    handled = {"num_micro", "moe_impl", "seq_parallel", "serve_bf16",
               "paged_merged", "kv_dtype", "oversub", "page_size"}
    for ladder in H.LADDERS.values():
        for _, _, over, _ in ladder:
            assert set(over) <= fields | handled, over


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dry"))
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun as D\n"
            "from repro_torch.launch import hillclimb as H\n"
            f"D.main(['--arch', 'yi-6b', '--shape', 'train_4k', '--out', {out!r}])\n"
            f"D.main(['--arch', 'yi-6b', '--shape', 'decode_32k', '--out', {out!r}])\n"
            "arch, shape, over, tag = H.LADDERS['qwen'][0]\n"
            f"D.run_cell(arch, shape, False, {out!r}, overrides=over, tag=tag)\n"
            "recs = {s: D.lower_kv_cell(s, False)[0] "
            "for s in ('kv_read', 'kv_write')}\n"
            "print(json.dumps(recs))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    cells = {"cell": "yi-6b_train_4k_16x16.json",
             "decode": "yi-6b_decode_32k_16x16.json",
             "qwen": "qwen1.5-32b_decode_32k_16x16_hc0_merged.json"}
    assert sorted(os.listdir(out)) == sorted(cells.values())
    recs = {}
    for key, name in cells.items():
        with open(os.path.join(out, name)) as f:
            recs[key] = json.load(f)
    return {**recs, **json.loads(r.stdout.strip().splitlines()[-1])}


def test_dryrun_train_cell_keeps_the_reference_layout(records):
    rec = records["cell"]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == {"arch", "shape", "mesh", "chips", "status",
                        "compile_seconds", "trace_seconds", "overrides",
                        "memory", "cost_hlo_floor", "analytic", "collectives",
                        "collective_wire_bytes_per_device", "roofline",
                        "model_flops", "useful_flops_ratio",
                        "roofline_fraction", "absent"}
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "yi-6b", "train_4k", "16x16", 256)
    for path in rec["absent"]:
        node = rec
        for k in path.split("."):
            node = node[k]
        assert node is None, path
    assert rec["memory"]["argument_bytes_per_device"] > 0
    am = A.model_cell(get_arch("yi-6b"), SHAPES["train_4k"], 256)
    assert rec["analytic"]["flops_total"] == am.flops_total
    assert rec["roofline"]["compute_s"] == am.flops_total / 256 / D.PEAK_FLOPS
    assert {"all-gather", "all-reduce"} <= set(rec["collectives"])
    assert rec["collective_wire_bytes_per_device"] == sum(
        v["wire_bytes"] for v in rec["collectives"].values())


def test_dryrun_kv_cells_count_their_routes(records):
    """16 shards, capacity int(4096 / 16 * 2) + 1 = 513 per destination:
    the lookup sends (pair, parity, live) words and gets back a row of
    20 keys, 20 values and the indicator; the ledger is 4 int64 counters."""
    S, CAP, SL = 16, 513, 20
    rd = records["kv_read"]["collectives"]
    assert rd["all-to-all"]["count"] == 2
    assert rd["all-to-all"]["bytes"] == S * CAP * (3 + SL * 8 + 1) * 4
    assert rd["all-reduce"] == {"count": 1, "bytes": 32,
                                "wire_bytes": 2 * 32 * 15 // 16}
    wr = records["kv_write"]["collectives"]
    assert wr["all-to-all"]["bytes"] == S * CAP * (3 + 8 + 1 + 1) * 4
    assert records["kv_read"]["memory"]["temp_bytes_per_device"] is None


def test_dryrun_paged_decode_cell_merges_slices_over_the_model_axis(records):
    """yi-6b x decode_32k on (16, 16): 16 data shards of 8 sequences, pages
    of 512 tokens split 16 ways over the model axis.  Each layer's
    attention partials cross the model group in one all-to-all by head
    group: rank 0 sends its 8 sequences x 32 heads x 1 split (meta) x
    (D 128 + (m, l)) float32 words."""
    rec = records["decode"]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == set(records["cell"])
    cfg = get_arch("yi-6b")
    a2a = rec["collectives"]["all-to-all"]
    assert a2a["count"] == cfg.n_layers
    assert a2a["bytes"] == cfg.n_layers * 8 * cfg.n_heads * (cfg.hd + 2) * 4
    assert rec["memory"]["argument_bytes_per_device"] > 0
    am = A.model_cell(cfg, SHAPES["decode_32k"], 256, tp=16, kv_bytes=2)
    assert rec["analytic"]["flops_total"] == am.flops_total


def test_hillclimb_qwen_ladder_first_rung_runs(records):
    """The ``qwen`` ladder's base rung (the merged path): an ``ok`` record
    with its overrides; merging each page's token slices gathers them over
    the model axis, so the step has no attention all-to-all."""
    rec = records["qwen"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["overrides"] == H.LADDERS["qwen"][0][2] == {
        "paged_merged": True}
    assert "all-to-all" not in rec["collectives"]
    assert rec["collectives"]["all-gather"]["count"] > 0
