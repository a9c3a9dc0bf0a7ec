"""Shard directory: rendezvous (highest-random-weight) key -> node routing.

Port of ``repro.cluster.directory`` (the port keeps its own copy).  The
cluster serves ONE keyspace from N PM nodes.  The directory is the pure
routing function every client and every server agrees on: for a 16-byte
key and a node name, a deterministic 64-bit weight; the key's replica set
is the R highest-weighted nodes, its primary the highest.

Rendezvous hashing gives the minimal-movement property the elastic
cluster needs without a ring or a central table: when a node JOINS, the
only keys that move are those whose new weight ranks it into their
replica set (~1/N per role); when a node LEAVES, only the keys it owned
move, and they scatter evenly over the survivors.

Weights mix the key's 128-bit lanes with a per-node salt derived ONLY
from the node name — membership changes never perturb other nodes'
weights (that is where minimal movement comes from).  The reference's
uint64 arithmetic runs as wrapping int64 torch ops on the keys' device
(`key_hash64_t`, `replica_sets_t`, `owned_mask_t`: right shifts masked to
be logical, unsigned order by flipping the sign bit); the numpy API over
(B, 4) uint32 key batches (`replica_sets`, `replica_names`, ...) wraps
them on the CPU.  The directory is a frozen value object, so replacing it
(join/leave/failover) is an atomic host-side swap.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

U64 = np.uint64
_I64_MIN = -(1 << 63)
# keys routed per chunk on the device: bounds the (B, N) weight temporaries
ROUTE_CHUNK = 1 << 22


def _signed(v: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _node_salt(name: str) -> np.uint64:
    """Stable 64-bit salt of a node name (membership-independent)."""
    return U64(int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little"))


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64_t(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer, a full-avalanche 64-bit mixer, on int64 bit
    patterns (multiplication wraps mod 2**64)."""
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _words(keys: np.ndarray) -> torch.Tensor:
    """(B, 4) uint32 key lanes as a CPU int32 tensor of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(keys, np.uint32).reshape(-1, 4).view(np.int32))


def key_hash64_t(keys: torch.Tensor) -> torch.Tensor:
    """(B, 4) int32 word keys -> (B,) int64 holding the full-width uint64
    key hash's bits, on the keys' device."""
    k = keys.reshape(-1, 4).to(torch.int64) & 0xFFFFFFFF
    lo = k[:, 0] | (k[:, 1] << 32)
    return _mix64_t(lo ^ _mix64_t(k[:, 2] | (k[:, 3] << 32)))


def key_hash64(keys: np.ndarray) -> np.ndarray:
    """(B, 4) uint32 key lanes -> (B,) uint64 full-width key hash."""
    return key_hash64_t(_words(keys)).numpy().view(U64)


@dataclasses.dataclass(frozen=True)
class Directory:
    """Frozen rendezvous routing table over the current membership.

    ``nodes`` is kept sorted so equal memberships compare equal regardless
    of join order; ``replicas`` is the replica-set size R (primary
    included).  R > live node count is clamped at routing time, so a
    cluster can lose nodes below R without the router failing.
    """

    nodes: Tuple[str, ...]
    replicas: int = 2

    def __post_init__(self):
        assert self.nodes, "directory needs at least one node"
        assert len(set(self.nodes)) == len(self.nodes), "duplicate node"
        assert self.replicas >= 1
        object.__setattr__(self, "nodes", tuple(sorted(self.nodes)))

    # -- membership (returns a NEW directory: host-side atomic swap) --------
    def with_node(self, name: str) -> "Directory":
        assert name not in self.nodes, name
        return dataclasses.replace(self, nodes=self.nodes + (name,))

    def without_node(self, name: str) -> "Directory":
        assert name in self.nodes, name
        assert len(self.nodes) > 1, "cannot remove the last node"
        return dataclasses.replace(
            self, nodes=tuple(n for n in self.nodes if n != name))

    # -- routing ------------------------------------------------------------
    def replica_sets(self, keys: np.ndarray) -> np.ndarray:
        """(B, R) node indices, weight-descending: column 0 is the primary.

        Indices point into ``self.nodes``; use `replica_names` when the
        caller holds nodes by name (indices shift across membership
        changes, names do not)."""
        return self.replica_sets_t(_words(keys)).numpy()

    def replica_sets_t(self, keys: torch.Tensor) -> torch.Tensor:
        """`replica_sets` of (B, 4) int32 word keys, computed on their
        device in chunks of `ROUTE_CHUNK`: (B, R) int64 node indices.  A
        key's weights never tie (the mixer is a bijection and the salts
        differ), so the order is the reference's."""
        keys = keys.reshape(-1, 4)
        r = min(self.replicas, len(self.nodes))
        salts = torch.tensor([_signed(int(_node_salt(n))) for n in self.nodes],
                             dtype=torch.int64, device=keys.device)
        out = torch.empty((keys.shape[0], r), dtype=torch.int64,
                          device=keys.device)
        for s in range(0, keys.shape[0], ROUTE_CHUNK):
            h = key_hash64_t(keys[s:s + ROUTE_CHUNK])
            w = _mix64_t(h[:, None] ^ salts[None])
            # the reference ranks by ``-w`` as uint64, ascending
            out[s:s + ROUTE_CHUNK] = torch.sort(
                (-w) ^ _I64_MIN, dim=1).indices[:, :r]
        return out

    def owned_mask_t(self, keys: torch.Tensor, name: str,
                     role: str = "any") -> torch.Tensor:
        """(B,) bool on the keys' device — keys this node serves as
        ``primary`` / ``replica`` / ``any`` member of the replica set
        (all-False for a name that is not a member)."""
        if name not in self.nodes:
            return torch.zeros(keys.reshape(-1, 4).shape[0], dtype=torch.bool,
                               device=keys.device)
        sets = self.replica_sets_t(keys) == self.nodes.index(name)
        if role == "primary":
            return sets[:, 0]
        hit = sets.any(dim=1)
        if role == "replica":
            return hit & ~sets[:, 0]
        assert role == "any", role
        return hit

    def primaries(self, keys: np.ndarray) -> np.ndarray:
        """(B,) primary node index per key (= replica_sets column 0)."""
        return self.replica_sets(keys)[:, 0]

    def replica_names(self, keys: np.ndarray) -> np.ndarray:
        """(B, R) node NAMES (object array) — the stable form of
        `replica_sets`."""
        return np.asarray(self.nodes, object)[self.replica_sets(keys)]

    def owned_mask(self, keys: np.ndarray, name: str,
                   role: str = "any") -> np.ndarray:
        """`owned_mask_t` of (B, 4) uint32 key lanes, as numpy."""
        return self.owned_mask_t(_words(keys), name, role).numpy()

    def placement(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """{node name: (B,) primary-ownership mask} over the whole batch."""
        prim = self.primaries(keys)
        return {n: prim == i for i, n in enumerate(self.nodes)}
