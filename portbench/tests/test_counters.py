"""The byte and FLOP counters against shapes worked by hand."""

import torch

from portbench import counters as C


def test_probe_bytes_by_hand():
    # 3 distinct rows of 20 slots: 3 * (20 * 16 + 4 + 8) = 996; 4 queries
    # of 16 + 4 + 4 + 4 bytes in and 8 out: 4 * 36 = 144
    assert C.probe_bytes(4, 3, 20, 8) == 996 + 144
    assert C.probe_bytes(4, 3, 20, 12) == 996 + 4 * 40


def test_attn_bytes_by_hand():
    # K and V of 5 tokens, 2 kv heads, 8 dims, bf16: 2 * 5 * 2 * 32 = 640;
    # q and out 2 * (2 * 4 * 8 * 2) = 256; page table 2 * 3 * 4; lengths 8
    assert C.attn_bytes("bf16", 2, 4, 2, 8, 3, 5) == 640 + 256 + 24 + 8
    # int8 adds two float32 scales per token and head: 2 * 5 * 2 * 8 = 160
    assert C.attn_bytes("int8", 2, 4, 2, 8, 3, 5) == 320 + 160 + 256 + 32


def test_group_flops_by_hand():
    cfg = {"hidden_size": 8, "intermediate_size": 16,
           "num_attention_heads": 2, "num_key_value_heads": 1,
           "num_hidden_layers": 1, "vocab_size": 10}
    # per token and layer: q 8*8, k and v 2 * 8*4, o 8*8, mlp 3 * 8*16
    mm = 2 * (64 + 64 + 64 + 384)
    assert C.layer_matmul_flops(cfg) == mm
    # a prompt of 3: attention over 1 + 2 + 3 keys, 4 * heads * dim each
    assert C.causal_attn_flops(cfg, 0, 3) == 4 * 8 * 6
    # decode steps at positions 3 and 4: 4 + 5 keys
    assert C.causal_attn_flops(cfg, 3, 2) == 4 * 8 * 9
    head = 2 * 8 * 10
    want = 2 * (3 * mm + 4 * 8 * 6 + head + 2 * (mm + head) + 4 * 8 * 9)
    assert C.group_flops(cfg, 2, 3, 3) == want


def test_home_pairs_equal_the_programs_placement():
    from repro_torch.core import continuity as ch
    g = torch.Generator().manual_seed(1)
    keys = torch.randint(-2 ** 31, 2 ** 31, (4096, 4), generator=g,
                         dtype=torch.int64).to(torch.int32)
    cfg = ch.ContinuityConfig(num_buckets=2 ** 12)
    assert torch.equal(C.home_pairs(keys, 2 ** 12), ch.locate(cfg, keys)[0])
