"""The port's chaos matrix CLI (`python -m repro_torch.chaos.matrix`) on
the CPU.

  * seeds 1-3 with the ``smoke`` profile: every gate holds (zero committed
    loss, every stale ack detected, every retry path and both degradation
    paths observed) and every cell's own checks pass;
  * ``--trace BASE`` at seed 0: the export passes
    ``python -m repro_torch.obs.report BASE --check``, prints what the
    reference's report prints for it, and carries the cells of the
    untraced run;
  * the scenario cells ``tests/test_chaos.py`` drives on their own
    (read-only degradation and retry exhaustion at seed 5, the fenced
    partition under YCSB-E scans at seed 2) equal the reference's.

The grid at seed 0 against the reference, cell by cell and export byte
for byte: ``tests/test_torch_chaos_grid_a.py`` and ``_grid_b.py``.
"""

import contextlib
import io
import json

import pytest

from repro.chaos import scenarios as jscen
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.chaos import matrix, scenarios
from repro_torch.obs import report
from test_torch_cluster import assert_same


def _main(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_matrix_passes_every_gate(tmp_path, seed):
    path = tmp_path / "m.json"
    rc, out = _main(matrix.main, ["--smoke", "--seed", str(seed),
                                  "--device", "cpu", "--json", str(path)])
    payload = json.loads(path.read_text())
    assert rc == 0 and payload["ok"], payload["gates"]
    assert all(payload["gates"].values())
    assert payload["grid_cells"] == 14
    assert all(c["ok"] for c in payload["cells"])
    assert [c["seed"] for c in payload["cells"]] == \
        [seed * 1000 + i for i in range(14)]
    assert out.rstrip().endswith("chaos matrix: PASS")


def test_traced_matrix_passes_the_report_check(tmp_path):
    base = str(tmp_path / "chaos")
    rc, _ = _main(matrix.main, ["--smoke", "--seed", "0", "--device", "cpu",
                                "--trace", base, "--json", base + ".json"])
    assert rc == 0
    rc, ours = _main(report.main, [base, "--check"])
    jrc, theirs = _main(jreport.main, [base, "--check"])
    assert rc == jrc == 0 and ours == theirs
    assert "maintenance SLO burns: 0" in ours
    trace, metrics = obs.load_export(base + obs.TRACE_SUFFIX)
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"cluster.round", "cluster.write", "cluster.failover",
            "cluster.resync"} <= spans
    assert metrics["meta"]["grid_cells"] == 14
    traced = json.loads(open(base + ".json").read())
    plain = matrix.run_matrix(seed=0, device="cpu", verbose=False)
    assert_same(json.loads(json.dumps(plain, sort_keys=True)),
                {k: v for k, v in traced.items() if k != "obs_export"})


@pytest.mark.parametrize("name,workload,seed", [
    ("read_only_degrade", "A", 5), ("timeout_giveup", "A", 5),
    ("partition_fence", "E", 2)])
def test_scenario_cell_equals_reference(name, workload, seed):
    port = scenarios.run_scenario(name, workload=workload, seed=seed,
                                  device="cpu")
    ref = jscen.run_scenario(name, workload=workload, seed=seed)
    assert_same(ref, port)
    assert port["ok"], port["checks"]
    if name == "partition_fence":
        assert port["chaos"]["stale_acks_injected"] > 0
        assert port["events"][:2] == ["partition", "stale"]
