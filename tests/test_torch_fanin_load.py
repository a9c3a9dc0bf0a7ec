"""The fan-in drill's load (`repro_torch.cache.fanin._load`) against the
JAX package's, on the CPU.

The values are drawn one ``make_value`` per 256 records as the reference
draws them; inserted in batches of 65,536 (the cut the full-size run
takes) they leave every node table byte-equal to the 256-record batches
of the reference's load, at a record count where the batch counts differ
(79 against 1), with the same acked records and the same random state
after the load; only the load's own write posts count differently.
"""

import numpy as np

from repro.cluster.store import ClusterStore as JCluster
from repro_torch.cache import fanin
from repro_torch.data import ycsb
from test_torch_cluster import _table_np, assert_same


N_LOAD = 20_000                  # 79 batches of 256, one of 65,536
LOAD_SLOTS = int(N_LOAD * 2 / 4 * 2.5) + 256


def _ref_load():
    """The reference's load, as its `_run_pass` makes it."""
    cluster = JCluster("continuity", nodes=4, replicas=2,
                       node_slots=LOAD_SLOTS)
    rng = np.random.RandomState(0)
    truth = {}
    for lo in range(0, N_LOAD, 256):
        ids = np.arange(lo, min(lo + 256, N_LOAD))
        vals = ycsb.make_value(rng, len(ids))
        okn = np.asarray(cluster.insert(ycsb.make_key(ids), vals).ok)
        for i, v in zip(ids[okn], vals[okn]):
            truth[int(i)] = v
    return cluster, rng, truth


def _tables(c) -> dict:
    return {n: _table_np(c.node(n).table) for n in c.node_names()}


def test_batched_load_equals_the_256_record_load():
    small = fanin._load(scheme="continuity", num_records=N_LOAD, nodes=4,
                        replicas=2, node_slots=LOAD_SLOTS, seed=0,
                        device="cpu", load_batch=256)
    big = fanin._load(scheme="continuity", num_records=N_LOAD, nodes=4,
                      replicas=2, node_slots=LOAD_SLOTS, seed=0,
                      device="cpu", load_batch=65_536)
    ref, rng, truth = _ref_load()
    assert_same(_tables(ref), _tables(small.cluster))
    assert_same(_tables(ref), _tables(big.cluster))
    for loaded in (small, big):
        acked = loaded.acked
        assert np.array_equal(acked.ids(), np.array(sorted(truth)))
        assert np.array_equal(acked.vals[acked.ids()],
                              np.stack([truth[i] for i in sorted(truth)]))
        assert_same(rng.get_state()[1], loaded.rng_state[1])
        assert rng.get_state()[2:] == loaded.rng_state[2:]
    assert small.acked.n == N_LOAD
    # only the load's own write posts count differently
    posts = [sum(st["wire"]["posts"]
                 for st in lo.cluster.stats()["nodes"].values())
             for lo in (small, big)]
    assert posts[0] > posts[1] > 0
