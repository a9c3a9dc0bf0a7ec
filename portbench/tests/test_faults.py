"""A run with its timed path broken underneath must come out not correct.

Each fault a cell can have is planted under a whole run at a small size
on the CPU (the harness's look for a chip skipped): a step that leaves
its state as it was, half of a batch left out, an answer or a token
altered where it is produced, every update or half of the load's inserts
refused; and the controls.  A sound run of each
cell at the same size comes out correct."""

import time

import pytest

from portbench import harness
from portbench.tests.sizes import with_held_out

STORE_CELLS = ("ycsb-c.zipf", "ycsb-a.uniform", "search.uniform-miss50")
SEED = 2 ** 31 + 77


def _run(workload, small, plant=(), seconds=0.2):
    kind = "serve" if workload == "yi6b.docqa" else "store"
    return harness.run_cell(workload, SEED, seconds, False, "cpu",
                            t_start=time.perf_counter(),
                            bench=with_held_out(harness.manifest()),
                            overrides=small[kind], plant=plant)


@pytest.mark.parametrize("workload", STORE_CELLS + ("yi6b.docqa",))
def test_a_sound_run_is_correct(workload, small):
    line = _run(workload, small)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload,plant", [
    *((w, p) for w in STORE_CELLS
      for p in ("drop_tails", "half_batch", "alter_answer",
                "refuse_inserts")),
    ("ycsb-a.uniform", "stale_update"), ("ycsb-a.uniform", "refuse_updates"),
    ("yi6b.docqa", "stale_step"), ("yi6b.docqa", "half_batch"),
    ("yi6b.docqa", "alter_token")])
def test_a_planted_fault_makes_the_run_incorrect(workload, plant, small):
    line = _run(workload, small, (plant,))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("plant,check", [("refuse_updates", "refused_share"),
                                         ("refuse_inserts", "load_refused")])
def test_refusals_fail_their_own_check(plant, check, small):
    """Refusing every update reads a share of 1; refusing half the load's
    inserts leaves half the records unacknowledged."""
    line = _run("ycsb-a.uniform", small, (plant,))
    got = line["checks"][check]
    assert got["value"] > got["limit"], line["checks"]
