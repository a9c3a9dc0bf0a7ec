"""The small sizes every CPU test runs a cell at, and the cells out of the
manifest that the tests run beside its own."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# a store at load 0.78 of its main slots (its extension groups and stash
# in use) and a two-layer model whose logits spread as the full model's
# (the output head's std times the root of the width: 0.16 * 8 = 0.02 *
# 64): cells a test run can hold.  The served cell checks every request
# a short window serves (up to 64), so a fault planted in one request of
# each group, or a control judged on the first group, shows however many
# groups the window holds
# at that load a sound run refuses 7.7-11.5 % of its updates (10 seeds),
# against the cell's 2.4 %, so the small store takes a refused-share
# limit of its own, between those readings and refuse-all's 1
STORE = {"config": {"num_buckets": 2 ** 7, "record_count": 1000,
                    "load_batch": 256, "limits": {"refused_share": 0.3}},
         "traffic": {"batch": 512, "check_rows": 512, "warmup_batches": 1,
                     "profile_batches": 2}}
SERVE = {"config": {"num_hidden_layers": 2, "hidden_size": 64,
                    "num_attention_heads": 4, "num_key_value_heads": 2,
                    "intermediate_size": 128, "vocab_size": 256,
                    "page_size": 4, "init_std": 0.16},
         "traffic": {"group": 4, "prompt_len": 16, "output_tokens": 5,
                     "check_requests": 64}}
SIZES = {"store": STORE, "serve": SERVE}


def with_held_out(bench: dict) -> dict:
    """``bench`` with the cells that are out of ``BENCHMARK.json`` added
    from ``held_out.json``: the served-model cell ``yi6b.docqa``, out while
    the port's norm epsilon departs from its configuration's, and
    ``ycsb-a.uniform``, out while the port refuses some updates of resident
    keys.  Their runners, references, files and entries stay, and the tests
    run them.  Its ``widen`` names, for each held-out cell, the manifest's
    metrics that cell reports too."""
    held = json.loads(Path(__file__).with_name("held_out.json").read_text())
    out = {k: copy.deepcopy(v) + held.get(k, []) if isinstance(v, list)
           else v for k, v in bench.items()}
    for cell, names in held["widen"].items():
        for m in out["end_to_end"] + out["per_layer"]:
            if m["name"] in names:
                m["workloads"] = m["workloads"] + [cell]
    return out
