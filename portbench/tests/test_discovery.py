"""A new mix and a new per-layer metric are new files and new entries:
the harness finds them by name, with nothing else edited."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness
from portbench.tests.sizes import ROOT, STORE, with_held_out


@pytest.mark.parametrize("held_out", [False, True])
def test_the_manifest_names_files_that_exist(held_out):
    bench = harness.manifest()
    if held_out:
        bench = with_held_out(bench)
    for c in bench["configs"]:
        cj = harness.load_json(harness.config_file(c))
        assert cj["name"] == c["name"]
        assert (harness.PKG / "runners" / f"{cj['runner']}.py").is_file()
        assert all((harness.PKG / r).is_file() for r in cj["reference"])
    for w in bench["workloads"]:
        assert harness.traffic_file(w["traffic"]).is_file()
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)
        moves = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moves.get("workloads", cells)), m["name"]


def test_a_new_mix_and_metric_run_from_files_alone(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_held_out(harness.manifest())
    (tmp_path / "portbench" / "traffic" / "ycsb-b.zipf.json").write_text(
        json.dumps({"kind": "store", "mix": {"read": 0.95, "update": 0.05},
                    "distribution": "zipfian", "theta": 0.99,
                    "batch": 512, "warmup_batches": 1, "check_rows": 512,
                    "profile_batches": 2}))
    (tmp_path / "portbench" / "metrics" / "update_share.b.py").write_text(
        textwrap.dedent('''\
            def read(run):
                n = len(run.spans.get("update", []))
                return n / len(run.spans["batch"]) * 100 if n else None
            '''))
    bench["workloads"].append({"name": "ycsb-b.zipf", "config": "ycsb-50m",
                               "traffic": "ycsb-b.zipf", "chips": 1,
                               "why": "read-mostly"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ycsb-a.uniform" in m["workloads"]:
            m["workloads"].append("ycsb-b.zipf")
    bench["per_layer"].append({"name": "update_share.b", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "Write engines", "moves": "ops_s",
                               "workloads": ["ycsb-b.zipf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f'''\
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / "src")!r}]
        from portbench import harness
        small = {{"config": {STORE["config"]!r},
                  "traffic": {{"check_rows": 512}}}}
        for trace in (0, 1):
            print(json.dumps(harness.run_cell(
                "ycsb-b.zipf", 5, 0.2, bool(trace), "cpu",
                t_start=time.perf_counter(), overrides=small)))
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert lines[0]["correct"] and set(lines[0]["metrics"]) == {
        "ops_s", "batch_p95_ms", "setup_s"}
    assert set(lines[1]["metrics"]) == {"update_share.b"}
    assert lines[1]["metrics"]["update_share.b"]["value"] == 100.0
