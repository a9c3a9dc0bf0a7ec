"""The controls at a size a test run can hold: each must come out not
correct where a sound run is correct.  On the chip ``portbench/control.py``
reads them at the cells' own sizes."""

import copy
import time

import pytest

from portbench import harness
from portbench.tests.sizes import with_held_out


def _run(workload, overrides, plant, seed):
    return harness.run_cell(workload, seed, 0.2, False, "cpu",
                            t_start=time.perf_counter(),
                            bench=with_held_out(harness.manifest()),
                            overrides=overrides, plant=plant, with_facts=True)


@pytest.mark.parametrize("workload", ["ycsb-c.zipf", "search.uniform-miss50"])
def test_the_read_path_without_its_tails_fails(workload, small):
    line = _run(workload, small["store"], ("drop_tails",), 2 ** 31 + 9)
    assert line["checks"]["wrong_reads"]["value"] > 0


def test_the_fp8_reference_fails_the_logit_limit(small):
    """At a width of 256, four layers and a vocabulary of 2,048 (logits
    spread as the full model's), the fp8 reference's first choices, judged
    in the served tokens' place, lie further below the float32
    reference's best than the limit allows, so the run is not correct;
    and further than the program's served tokens by three times or
    more."""
    o = copy.deepcopy(small["serve"])
    o["config"].update(hidden_size=256, num_hidden_layers=4,
                       vocab_size=2048, intermediate_size=512,
                       num_attention_heads=4, num_key_value_heads=1,
                       init_std=0.08)
    o["traffic"].update(prompt_len=64, output_tokens=8)
    line = _run("yi6b.docqa", o, ("fp8_control",), 3)
    gap = line["checks"]["logit_gap"]
    assert not line["correct"]
    assert gap["value"] > gap["limit"]
    assert line["facts"]["program_gap"] <= gap["limit"]
    assert gap["value"] >= 3 * line["facts"]["program_gap"]
