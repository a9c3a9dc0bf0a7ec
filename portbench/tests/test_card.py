"""On a card: every cell through ``portbench/run.py`` at a short window,
its line whole and correct.  Skips without one."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.sizes import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.manifest()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    bench = harness.manifest()
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
