"""What the benchmark runs loads neither JAX nor the JAX package, and
opens nothing under ``benchmarks/`` nor ``BENCH_hash.json``."""

import json
import subprocess
import sys
import textwrap

from portbench.tests.sizes import ROOT, SERVE, STORE

AUDIT = textwrap.dedent(f'''\
    import json, sys, time
    opened = []
    def hook(event, args):
        if event == "open" and isinstance(args[0], str):
            opened.append(args[0])
    sys.addaudithook(hook)
    sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
    import portbench.run, portbench.control
    from portbench import harness
    from portbench.tests.sizes import with_held_out
    bench = with_held_out(harness.manifest())
    for w, small in (("ycsb-a.uniform", {STORE!r}),
                     ("yi6b.docqa", {SERVE!r})):
        for trace in (0, 1):
            harness.run_cell(w, 3, 0.1, bool(trace), "cpu",
                             t_start=time.perf_counter(), bench=bench,
                             overrides=small)
    print(json.dumps({{"modules": sorted(sys.modules), "opened": opened}}))
    ''')


def test_a_run_loads_no_jax_and_reads_no_reference_benchmark():
    out = subprocess.run([sys.executable, "-c", AUDIT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.splitlines()[-1])
    tops = {m.split(".")[0] for m in seen["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    assert "repro_torch" in tops
    bad = [p for p in seen["opened"]
           if "benchmarks/" in p or p.endswith("BENCH_hash.json")]
    assert not bad, bad


def test_run_prints_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ycsb-c.zipf",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ycsb-c.zipf",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
