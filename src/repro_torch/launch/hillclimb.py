"""Perf hillclimb: runs the three chosen cells through their
iteration ladders, each variant as a tagged dry-run record.

Port of ``repro.launch.hillclimb``: the same ladders, each rung a
``launch.dryrun.run_cell`` on the fake production mesh (no card).  A rung
whose record is not "ok" (a paged serving cell, which the port's dry run
skips) is left out of the summary.

Usage: python -m repro_torch.launch.hillclimb [--cell yi|granite|qwen|all]
"""

import argparse
import json
import os

LADDERS = {
    # worst-roofline dense train cell: fit memory, halve attention waste,
    # then trade remat recompute back once memory allows
    "yi": [
        ("yi-6b", "train_4k", {}, "_hc0_base"),
        ("yi-6b", "train_4k", {"num_micro": 8}, "_hc1_micro8"),
        ("yi-6b", "train_4k", {"num_micro": 8, "attn_mode": "causal_skip"},
         "_hc2_causal"),
        ("yi-6b", "train_4k",
         {"num_micro": 8, "attn_mode": "causal_skip", "remat": "dots"},
         "_hc3_dots"),
        ("yi-6b", "train_4k",
         {"num_micro": 16, "attn_mode": "causal_skip", "remat": "dots"},
         "_hc4_micro16"),
        # drop explicit qkv constraints: the kv_heads degrade-to-replicated
        # constraint forces ~14 resharding all-reduces per layer
        ("yi-6b", "train_4k",
         {"num_micro": 16, "attn_mode": "causal_skip", "remat": "dots",
          "constrain_qkv": False}, "_hc5_noqkv"),
        # Megatron-style sequence parallelism: residual stream seq-sharded
        # over the model axis; the TP all-reduce pairs decompose into
        # reduce-scatter + all-gather (~half the wire bytes)
        ("yi-6b", "train_4k",
         {"num_micro": 16, "attn_mode": "causal_skip", "remat": "dots",
          "seq_parallel": True}, "_hc6_seqpar"),
    ],
    # most collective-bound cell: dense-MoE kills the dispatch collectives
    "granite": [
        ("granite-moe-1b-a400m", "train_4k", {}, "_hc0_base"),
        ("granite-moe-1b-a400m", "train_4k", {"moe_impl": "dense"},
         "_hc1_dense"),
        ("granite-moe-1b-a400m", "train_4k",
         {"moe_impl": "dense", "num_micro": 8}, "_hc2_micro8"),
        ("granite-moe-1b-a400m", "train_4k",
         {"moe_impl": "dense", "num_micro": 8, "attn_mode": "causal_skip"},
         "_hc3_causal"),
        # vocab 49155 doesn't divide TP=16 -> logits replicate; pad to 49168
        ("granite-moe-1b-a400m", "train_4k",
         {"moe_impl": "dense", "num_micro": 8, "attn_mode": "causal_skip",
          "vocab_pad_to": 16}, "_hc4_vpad"),
        # refutation follow-up: micro8 DUPLICATED per-microbatch collectives;
        # revert to num_micro=1 with the other wins kept
        ("granite-moe-1b-a400m", "train_4k",
         {"moe_impl": "dense", "attn_mode": "causal_skip",
          "vocab_pad_to": 16, "constrain_qkv": False}, "_hc5_micro1"),
    ],
    # paper-representative cell (hash-paged KV serving): un-merge the page
    # dims (kill the involuntary remat), quantize the pool, oversubscribe,
    # then tune the segment/page size (the paper's own size_se trade-off)
    "qwen": [
        ("qwen1.5-32b", "decode_32k", {"paged_merged": True}, "_hc0_merged"),
        ("qwen1.5-32b", "decode_32k", {}, "_hc1_unmerged"),
        ("qwen1.5-32b", "decode_32k", {"kv_dtype": "int8"}, "_hc2_int8"),
        ("qwen1.5-32b", "decode_32k", {"kv_dtype": "int8", "oversub": 0.5},
         "_hc3_oversub"),
        ("qwen1.5-32b", "decode_32k",
         {"kv_dtype": "int8", "oversub": 0.5, "page_size": 1024},
         "_hc4_page1k"),
        ("qwen1.5-32b", "decode_32k",
         {"kv_dtype": "int8", "oversub": 0.5, "page_size": 256},
         "_hc5_page256"),
        # serving weights in bf16 (masters stay with the trainer)
        ("qwen1.5-32b", "decode_32k",
         {"kv_dtype": "int8", "oversub": 0.5, "serve_bf16": True},
         "_hc6_bf16w"),
    ],
}



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    choices=["all"] + sorted(LADDERS))
    ap.add_argument("--out", default="experiments/hillclimb")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell
    cells = (LADDERS.keys() if args.cell == "all" else [args.cell])
    summary = []
    for name in cells:
        for arch, shape, over, tag in LADDERS[name]:
            rec = run_cell(arch, shape, False, args.out, force=args.force,
                           overrides=over, tag=tag)
            if rec.get("status") == "ok":
                summary.append({
                    "cell": name, "tag": tag, "overrides": over,
                    "dominant": rec["roofline"]["dominant"],
                    "compute_s": rec["roofline"]["compute_s"],
                    "memory_s": rec["roofline"]["memory_s"],
                    "collective_s": rec["roofline"]["collective_s"],
                    "argument_gb":
                        rec["memory"]["argument_bytes_per_device"] / 1e9,
                    "roofline_fraction": rec.get("roofline_fraction", 0),
                })
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for s in summary:
        print(f"{s['cell']:8s}{s['tag']:14s} dom={s['dominant'][:-2]:10s} "
              f"step={(s['compute_s']+s['memory_s']+s['collective_s'])*1e3:9.1f}ms "
              f"args={s['argument_gb']:6.1f}GB rf={s['roofline_fraction']:.3f}")
    return summary


if __name__ == "__main__":
    main()
