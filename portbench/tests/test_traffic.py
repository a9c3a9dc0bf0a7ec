"""The traffic generator: the mix, the skew and the draws' repeatability."""

import numpy as np
import torch

from portbench import traffic, ycsb


def test_zipf_top_one_percent_mass_matches_its_partial_zeta():
    z = ycsb.Zipf(200_000, 0.99, "cpu")
    g = torch.Generator().manual_seed(7)
    ranks = z.sample(g, 400_000)
    k = 2_000
    measured = float((ranks < k).double().mean())
    assert abs(measured - z.top_mass(k)) < 0.01
    assert int(ranks.min()) >= 0 and int(ranks.max()) < 200_000


def test_zipf_constants_equal_the_programs_generator():
    from repro_torch.data import ycsb as port
    ours, theirs = ycsb.Zipf(1_000_003, 0.99, "cpu"), port.Zipf(1_000_003)
    assert abs(ours.zetan - theirs.zetan) < 1e-9 * theirs.zetan
    assert abs(ours.eta - theirs.eta) < 1e-12


def test_keys_equal_the_programs_generator():
    from repro_torch.data import ycsb as port
    ids = np.array([0, 1, 2, 12345, 50_331_647, 2 ** 31 + 3, 2 ** 33 + 9])
    want = port.make_key(ids).view(np.int32)
    got = ycsb.make_key(torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)
    assert torch.equal(ycsb.key_ids(torch.from_numpy(want)),
                       torch.from_numpy(ids))


def _mix(**kw):
    spec = {"kind": "store", "mix": {"read": 0.5, "update": 0.5},
            "distribution": "uniform", "batch": 1000}
    spec.update(kw)
    return traffic.StoreTraffic(spec, {"record_count": 10_000}, 2 ** 31 + 1,
                                "cpu")


def test_store_batches_hold_exact_shares_and_absent_misses():
    gen = _mix(mix={"read": 1.0}, miss_share=0.5)
    for _ in range(3):
        b = gen.next()
        ids = ycsb.key_ids(b["read_keys"])
        assert len(ids) == 1000 and "update_keys" not in b
        assert int((ids >= 10_000 + ycsb.NEG_OFFSET).sum()) == 500
        assert int((ids < 10_000).sum()) == 500
    b = _mix().next()
    assert len(b["read_keys"]) == len(b["update_keys"]) == 500
    assert b["update_vals"].shape == (500, 4)
    assert int(b["update_vals"].min()) >= 0


def test_the_same_seed_draws_the_same_batches_again():
    gen = _mix(distribution="zipfian", theta=0.99)
    first = [gen.next() for _ in range(3)]
    gen.restart()
    again = [gen.next() for _ in range(3)]
    for a, b in zip(first, again):
        assert all(torch.equal(a[k], b[k]) for k in a)
    other = _mix(distribution="zipfian").next()
    other_seed = traffic.StoreTraffic(
        {"kind": "store", "mix": {"read": 0.5, "update": 0.5},
         "distribution": "zipfian", "batch": 1000},
        {"record_count": 10_000}, 5, "cpu").next()
    assert torch.equal(first[0]["read_keys"], other["read_keys"])
    assert not torch.equal(other["read_keys"], other_seed["read_keys"])


def test_a_mix_with_an_unknown_operation_is_refused():
    import pytest
    with pytest.raises(ValueError):
        _mix(mix={"read": 0.5, "insert": 0.5})


def test_serve_prompts_are_groups_of_token_ids():
    spec = {"kind": "serve", "group": 3, "prompt_len": 8,
            "output_tokens": 2}
    gen = traffic.ServeTraffic(spec, 50, 9, "cpu")
    p = gen.next()
    assert p.shape == (3, 8) and p.dtype == torch.int32
    assert int(p.min()) >= 0 and int(p.max()) < 50
    gen.restart()
    assert torch.equal(gen.next(), p)
