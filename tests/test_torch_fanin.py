"""The port's 100-client fan-in drill (`repro_torch.cache.fanin`) against
the JAX package's, on the CPU.

  * ``python -m repro_torch.cluster.sim --cache --smoke --device cpu
    --json OUT`` against ``python -m repro.cluster.sim --cache --smoke
    --json OUT``: the same exit status, the same printout and the same
    JSON payload byte for byte — both passes field for field, the
    `LinkModel` latencies and ratios to the last bit — and every gate of
    `check_gates` holds (the batched load is held against the
    reference's in ``tests/test_torch_fanin_load.py``);
  * `default_events` is the reference's at every round count, and the
    entry points default to the card.
"""

import contextlib
import inspect
import io
import json

import pytest
import torch

from repro.cache import fanin as jfanin
from repro.cluster import sim as jsim
from repro_torch.cache import fanin
from repro_torch.cluster import sim
from test_torch_cluster import assert_same


def _main(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    d = tmp_path_factory.mktemp("fanin")
    rc, out = _main(sim.main, ["--cache", "--smoke", "--device", "cpu",
                               "--json", str(d / "port.json")])
    jrc, jout = _main(jsim.main, ["--cache", "--smoke",
                                  "--json", str(d / "ref.json")])
    return ((rc, out, (d / "port.json").read_text()),
            (jrc, jout, (d / "ref.json").read_text()))


def test_cache_cli_output_equals_reference(smoke):
    (rc, out, text), (jrc, jout, jtext) = smoke
    assert rc == jrc == 0
    assert out == jout
    assert text == jtext                     # the payload, byte for byte
    assert "fanin continuity x100 clients (hotspot, seed=0)" in out


@pytest.mark.parametrize("part", ["uncached", "cached"])
def test_smoke_pass_equals_reference_field_for_field(smoke, part):
    port = json.loads(smoke[0][2])[part]
    ref = json.loads(smoke[1][2])[part]
    assert_same(ref, port)
    assert port["wrong_reads"] == 0
    assert [e["event"] for e in port["events"]] == [
        "partition", "stale", "heal", "resync", "join", "kill", "failover"]


def test_smoke_gates_hold_as_in_the_reference(smoke):
    port, ref = json.loads(smoke[0][2]), json.loads(smoke[1][2])
    assert_same({k: v for k, v in ref.items()
                 if k not in ("uncached", "cached")},
                {k: v for k, v in port.items()
                 if k not in ("uncached", "cached")})
    assert fanin.check_gates(port) == jfanin.check_gates(ref) == []
    assert fanin.GATES == jfanin.GATES
    assert port["cached"]["hit_rate"] >= fanin.GATES["hit_rate_floor"]
    assert port["doorbell_reduction"] >= 2.0
    assert port["p99_ratio"] <= 1.0 and port["cached"]["stale_served"] == 0
    broken = json.loads(smoke[0][2])
    broken["cached"]["stale_served"] = 1
    broken["doorbell_reduction"] = 1.5
    assert fanin.check_gates(broken) == jfanin.check_gates(broken)
    assert len(fanin.check_gates(broken)) == 2


@pytest.mark.parametrize("rounds", [1, 2, 5, 7, 9, 14, 18, 40])
def test_default_events_equal_reference(rounds):
    assert fanin.default_events(rounds) == jfanin.default_events(rounds)


def test_entry_points_default_to_the_card():
    from repro_torch.chaos import matrix, scenarios
    for fn in (fanin.run_fanin, scenarios.run_scenario, matrix.run_matrix):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fanin.run_fanin(clients=1, rounds=1, num_records=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scenarios.run_scenario("lag_reads")
