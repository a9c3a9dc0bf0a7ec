"""The port's continuous batcher against the JAX package's, on the CPU.

The port of ``tests/test_scheduler.py::test_continuous_batching_drains_queue``:
7 requests through 4 slots on ``smoke_config("yi-6b")``, with the JAX
package's weights carried across by ``convert.params_from_numpy``.  Both
batchers get the same prompts; greedy decode on float32 logits that agree
within ~1e-6 must give the same finished token lists.  Under a simulated
transport, both batchers post the same per-step verb plans.
"""

import jax
import numpy as np

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.config import ShapeConfig as JShape
from repro.api import ExecPolicy as JExecPolicy
from repro.serving import kvcache as JKC
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch import convert
from repro_torch.api import ExecPolicy
from repro_torch.configs import smoke_config
from repro_torch.models.config import ShapeConfig
from repro_torch.rdma import RemoteMemory
from repro_torch.serving import kvcache as KC
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def requests(cls, vocab, n_req=7):
    rng = np.random.RandomState(0)
    return [cls(rid=rid, prompt=rng.randint(0, vocab, size=(
        rng.randint(3, 10),)).astype(np.int32), max_new_tokens=4 + rid % 3)
        for rid in range(n_req)]


def test_continuous_batching_matches_reference():
    jcfg, cfg = jax_smoke_config("yi-6b"), smoke_config("yi-6b")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu")
    jgeom = JKC.make_geometry(jcfg, JShape("s", seq_len=128, global_batch=4,
                                           kind="decode"), shards=2,
                              page_size=16)
    geom = KC.make_geometry(cfg, ShapeConfig("s", seq_len=128, global_batch=4,
                                             kind="decode"), shards=2,
                            page_size=16, device="cpu")
    jb = JBatcher(jcfg, jgeom, jparams)
    tb = ContinuousBatcher(cfg, geom, params)
    for jr, tr in zip(requests(JRequest, cfg.vocab),
                      requests(Request, cfg.vocab)):
        jb.submit(jr)
        tb.submit(tr)
    want = jb.run(max_steps=300)
    finished = tb.run(max_steps=300)

    assert sorted(finished) == list(range(7))
    for rid, out in finished.items():
        assert len(out) == 4 + rid % 3
        assert all(0 <= t < cfg.vocab for t in out)
    assert finished == want
    # all pages released at the end, slots reused (7 requests, 4 slots)
    assert sum(int(t.count) for t in tb.cache.table) == 0
    assert all(s is None for s in tb.slots)
    assert np.array_equal(convert.cache_to_numpy(tb.cache)["seq_ids"],
                          np.asarray(jb.cache.seq_ids))


def test_transport_waits_for_its_port():
    """A transport passed to the batcher is the one it posts to; the
    default policy (``transport="none"``) gives none.  (The name is from
    before the transport's port, when passing one raised; it is kept so
    that the test's history stays one test.)"""
    cfg = smoke_config("yi-6b")
    geom = KC.make_geometry(cfg, ShapeConfig("s", seq_len=64, global_batch=2,
                                             kind="decode"), shards=1,
                            page_size=16, device="cpu")
    mem = RemoteMemory()
    assert ContinuousBatcher(cfg, geom, params={}, transport=mem).transport \
        is mem
    assert ContinuousBatcher(cfg, geom, params={}).transport is None


def test_sim_transport_counters_match_reference():
    """Under ``ExecPolicy(transport="sim")`` the batcher builds its own
    endpoint and posts each step's page-translation plan, as the
    reference's does: every doorbell, verb, byte and simulated-time
    counter equals the reference batcher's over the same requests (greedy
    decode with no EOS, so each request ends at its token budget)."""
    jcfg, cfg = jax_smoke_config("yi-6b"), smoke_config("yi-6b")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu")
    jgeom = JKC.make_geometry(jcfg, JShape("s", seq_len=64, global_batch=2,
                                           kind="decode"), shards=2,
                              page_size=16,
                              policy=JExecPolicy(transport="sim"))
    geom = KC.make_geometry(cfg, ShapeConfig("s", seq_len=64, global_batch=2,
                                             kind="decode"), shards=2,
                            page_size=16, policy=ExecPolicy(transport="sim"),
                            device="cpu")
    jb = JBatcher(jcfg, jgeom, jparams)
    tb = ContinuousBatcher(cfg, geom, params)
    assert isinstance(tb.transport, RemoteMemory)
    for jr, tr in zip(requests(JRequest, cfg.vocab, 3),
                      requests(Request, cfg.vocab, 3)):
        jb.submit(jr)
        tb.submit(tr)
    jb.run(max_steps=100)
    tb.run(max_steps=100)
    want, got = jb.transport.stats(), tb.transport.stats()
    assert want["posts"] > 0 and want["verbs"] > 0
    assert got == want
