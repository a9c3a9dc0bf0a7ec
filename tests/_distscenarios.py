"""The distributed store's scenarios, driven on either package, for
``tests/test_torch_distributed.py``.

``make_inputs`` writes the batches (numpy, from seeds; the crafted ones
picked with the port's ``locate`` on the CPU) to one ``.npz``.
``reference_main`` drives them on the JAX package over 8 forced XLA host
devices and saves one ``.npz``; ``port_main`` spawns 8 gloo ranks that
drive them on the port, each saving the global view it gathers over its
store group (every shard's table, every client's results) to
``rank<r>.npz``.  The record keys are the same on both sides.

Scenarios (the JAX package's ``tests/test_distributed.py`` and more):
  rt   (4, 2) mesh, 4 shards: insert, lookup, count, absent keys, delete;
  sem  (8,) mesh, 8 shards: inserts retried until every key lands, lookups
       retried until every key is routed, the 4-fetch lookup;
  mix  (8,) mesh, 8 shards of 8 pairs: inserts that overflow the capacity
       buckets and fill a segment, then mixed insert / update / delete
       batches with a key repeated across clients in one batch.
"""

import os

import numpy as np

OP_INSERT, OP_UPDATE, OP_DELETE = 1, 2, 3
SCEN = {
    "rt": dict(buckets=256, shards=4, shape=(4, 2), axes=("data", "model")),
    "sem": dict(buckets=512, shards=8, shape=(8,), axes=("data",)),
    "mix": dict(buckets=128, shards=8, shape=(8,), axes=("data",)),
}
TABLE_FIELDS = ("keys", "vals", "indicator", "version", "ext_keys",
                "ext_vals", "ext_map", "ext_count", "count", "fp",
                "stash_keys", "stash_vals", "stash_meta")


def _rand(rng, n):
    return rng.randint(0, 2 ** 31, size=(n, 4)).astype(np.uint32)


def make_inputs(path):
    import torch
    from repro_torch.core.continuity import ContinuityConfig, locate
    out = {}
    rng = np.random.RandomState(0)
    out["rt_K"], out["rt_V"], out["rt_NEG"] = (_rand(rng, 64), _rand(rng, 64),
                                               _rand(rng, 64))
    rng = np.random.RandomState(1)
    out["sem_K"], out["sem_V"] = _rand(rng, 128), _rand(rng, 128)
    out["sem_NEG"] = _rand(rng, 128)

    rng = np.random.RandomState(2)
    pool = _rand(rng, 40000)
    pair, parity = locate(ContinuityConfig(num_buckets=128, ext_frac=0.0),
                          torch.from_numpy(pool.view(np.int32)))
    bucket = (2 * pair + parity).numpy()
    hot = pool[bucket == 6][:24]                  # one segment overflows
    own0 = pool[(bucket < 16) & (bucket != 6)][:100]   # shard 0's pairs
    rest = pool[bucket >= 16][:132]
    K0 = np.concatenate([hot, own0, rest])[rng.permutation(256)]
    fresh = pool[bucket >= 16][132:196]
    out["mix_K0"], out["mix_V0"] = K0, _rand(rng, 256)
    out["mix_op0"] = np.full(256, OP_INSERT, np.int32)
    # a mixed batch: updates, deletes, duplicate inserts, new inserts, no-ops
    idx = rng.permutation(256)
    keys1 = np.concatenate([K0[idx[:64]], K0[idx[64:96]], K0[idx[96:128]],
                            fresh, K0[idx[128:192]]])
    op1 = np.concatenate([np.full(64, OP_UPDATE), np.full(32, OP_DELETE),
                          np.full(32, OP_INSERT), np.full(64, OP_INSERT),
                          np.zeros(64)]).astype(np.int32)
    perm = rng.permutation(256)
    out["mix_K1"], out["mix_op1"] = keys1[perm], op1[perm]
    out["mix_V1"] = _rand(rng, 256)
    # repeated keys: 16 keys x 8 ops each, the copies spread over clients
    rep = np.concatenate([hot[:8], fresh[:4], rest[:4]])
    pattern = [OP_INSERT, OP_UPDATE, OP_DELETE, OP_INSERT, OP_UPDATE,
               OP_UPDATE, OP_DELETE, OP_INSERT]
    keys2 = np.concatenate([np.repeat(rep, 8, 0).reshape(16, 8, 4)
                            .transpose(1, 0, 2).reshape(128, 4),
                            K0[rng.permutation(256)[:128]]])
    op2 = np.concatenate([np.repeat(pattern, 16),
                          rng.randint(0, 4, 128)]).astype(np.int32)
    out["mix_K2"], out["mix_op2"], out["mix_V2"] = keys2, op2, _rand(rng, 256)
    out["mix_L"] = np.concatenate([fresh, K0[:192]])
    np.savez(path, **out)


def drive(side, inp) -> dict:
    """Run every scenario on ``side`` (an adapter of one package); returns
    {record: numpy array} of global results and table snapshots."""
    rec = {}
    for name in ("rt", "sem", "mix"):
        side.open(name, **SCEN[name])

        def snap(tag):
            for f, a in side.table().items():
                rec[f"{name}/{tag}/table/{f}"] = a

        def look(tag, K, mask=None):
            found, vals, routed, ledger = side.lookup(K, mask)
            rec[f"{name}/{tag}/found"] = found
            rec[f"{name}/{tag}/values"] = vals
            rec[f"{name}/{tag}/routed"] = routed
            rec[f"{name}/{tag}/ledger"] = ledger
            return found, vals, routed

        def write(tag, op, K, V):
            ok, routed = side.write(op, K, V)
            rec[f"{name}/{tag}/ok"], rec[f"{name}/{tag}/wrouted"] = ok, routed
            snap(tag)
            return ok, routed

        if name == "rt":
            K, V = inp["rt_K"], inp["rt_V"]
            B = K.shape[0]
            write("ins", np.full(B, OP_INSERT, np.int32), K, V)
            look("get", K)
            rec["rt/count_ins"] = np.asarray(side.count())
            look("neg", inp["rt_NEG"])
            write("del", np.full(B, OP_DELETE, np.int32), K, V)
            rec["rt/count_del"] = np.asarray(side.count())
        elif name == "sem":
            K, V = inp["sem_K"], inp["sem_V"]
            B = K.shape[0]
            pending = np.full(B, OP_INSERT, np.int32)
            done = np.zeros(B, bool)
            for it in range(6):   # clients retry capacity overflows
                ok, _ = write(f"ins{it}", pending, K, V)
                done |= ok
                pending = np.where(done, 0, OP_INSERT).astype(np.int32)
                if done.all():
                    break
            rec["sem/inserted"] = done
            resolved = np.zeros(B, bool)
            for it in range(6):   # retry unrouted keys with a new mask
                _, _, routed = look(f"get{it}", K, ~resolved)
                resolved |= routed
                if resolved.all():
                    break
            rec["sem/resolved"] = resolved
            rec["sem/multi_K"] = side.multifetch(K)
            rec["sem/multi_NEG"] = side.multifetch(inp["sem_NEG"])
        else:
            for b in range(3):
                write(f"w{b}", inp[f"mix_op{b}"], inp[f"mix_K{b}"],
                      inp[f"mix_V{b}"])
                look(f"get{b}", inp["mix_K0"])
                look(f"fresh{b}", inp["mix_L"])
            rec["mix/count"] = np.asarray(side.count())
            rec["mix/multi"] = side.multifetch(inp["mix_L"])
    return rec


# -- the reference -------------------------------------------------------------

class _Reference:
    def open(self, name, buckets, shards, shape, axes):
        import repro.core.distributed as D
        from repro.core import continuity as ch
        from repro.launch.mesh import make_debug_mesh
        self.D = D
        self.mesh = make_debug_mesh(shape, axes)
        cfg = D.StoreConfig(table=ch.ContinuityConfig(num_buckets=buckets,
                                                      ext_frac=0.0),
                            num_shards=shards)
        self.tbl = D.create_sharded(cfg)
        self.w = D.make_write(cfg, self.mesh)
        self.lk = D.make_lookup(cfg, self.mesh)
        self.mf = D.make_lookup_multifetch(cfg, self.mesh)

    def write(self, op, K, V):
        import jax.numpy as jnp
        with self.mesh:
            self.tbl, ok, routed = self.w(self.tbl, jnp.asarray(op),
                                          jnp.asarray(K), jnp.asarray(V))
        return np.asarray(ok), np.asarray(routed)

    def lookup(self, K, mask):
        import jax.numpy as jnp
        m = None if mask is None else jnp.asarray(mask)
        with self.mesh:
            r = self.lk(self.tbl, jnp.asarray(K), m)
        return (np.asarray(r.found), np.asarray(r.values).view(np.int32),
                np.asarray(r.routed),
                np.asarray([int(x) for x in r.ledger], np.int64))

    def multifetch(self, K):
        import jax.numpy as jnp
        with self.mesh:
            return np.asarray(self.mf(self.tbl, jnp.asarray(K)))

    def count(self):
        with self.mesh:
            return int(self.D.sharded_count(self.tbl))

    def table(self):
        return {f: np.asarray(getattr(self.tbl, f)).view(np.int32)
                for f in TABLE_FIELDS}


def reference_main(inputs, out):
    inp = dict(np.load(inputs))
    np.savez(out, **drive(_Reference(), inp))


# -- the port ------------------------------------------------------------------

class _Port:
    def open(self, name, buckets, shards, shape, axes):
        import repro_torch.core.distributed as D
        from repro_torch.core import continuity as ch
        from repro_torch.launch.mesh import make_debug_mesh
        self.D = D
        self.mesh = make_debug_mesh(shape, axes, device_type="cpu")
        self.cfg = D.StoreConfig(table=ch.ContinuityConfig(
            num_buckets=buckets, ext_frac=0.0), num_shards=shards)
        self.group = D.store_group(self.cfg, self.mesh)
        self.s = __import__("torch").distributed.get_rank(self.group)
        self.tbl = D.create_sharded(self.cfg, "cpu")
        self.w = D.make_write(self.cfg, self.mesh)
        self.lk = D.make_lookup(self.cfg, self.mesh)
        self.mf = D.make_lookup_multifetch(self.cfg, self.mesh)

    def _mine(self, x):
        """This rank's client batch: the reference's dim-0 split."""
        n = x.shape[0] // self.cfg.num_shards
        return x[self.s * n:(self.s + 1) * n]

    def _all(self, t):
        """The global array of every shard's local ``t`` (group order)."""
        import torch
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.cfg.num_shards)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts).numpy()

    def write(self, op, K, V):
        import torch
        _, ok, routed = self.w(self.tbl, torch.from_numpy(self._mine(op)),
                               self._mine(K), self._mine(V))
        return self._all(ok), self._all(routed)

    def lookup(self, K, mask):
        import torch
        m = None if mask is None else torch.from_numpy(self._mine(mask))
        r = self.lk(self.tbl, self._mine(K), m)
        return (self._all(r.found), self._all(r.values), self._all(r.routed),
                np.asarray([int(x) for x in r.ledger], np.int64))

    def multifetch(self, K):
        return self._all(self.mf(self.tbl, self._mine(K)))

    def count(self):
        return int(self.D.sharded_count(self.tbl, self.group))

    def table(self):
        pairwise = {"keys", "vals", "indicator", "version", "ext_map", "fp"}
        return {f: (self._all(getattr(self.tbl, f)) if f in pairwise
                    else getattr(self.tbl, f).numpy())
                for f in TABLE_FIELDS}


def _port_rank(rank, world, port, inputs, outdir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        rec = drive(_Port(), dict(np.load(inputs)))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **rec)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def port_main(inputs, outdir, world=8):
    import torch.multiprocessing as mp
    mp.start_processes(_port_rank, args=(world, free_port(), inputs, outdir),
                       nprocs=world, start_method="spawn")
