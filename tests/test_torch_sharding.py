"""The port's logical-axis sharding against the JAX package's.

Every config's axis trees and per-leaf specs (params, AdamW moments under
ZeRO-1, the paged cache or the state cache at ``decode_32k``) on both
production meshes, (16, 16) and (2, 16, 16), equal the reference's leaf
for leaf.  Each side runs once per module in a process of its own: the
reference with 512 forced XLA host devices (the device count is fixed at
JAX's first use), the port on a fake process group of 256, then 512 ranks
(a process group is global to its process).  Both run at once.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.distribution import sharding as SH

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def specs():
    """{side: {mesh: {config: {kind: {leaf: [axes, spec]}}}}}."""
    procs = {}
    for side in ("reference", "port"):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"), HERE]))
        if side == "reference":
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        procs[side] = subprocess.Popen(
            [sys.executable, "-c",
             f"import _shardspecs; _shardspecs.main({side!r})"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    out = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"{side}:\n{stderr[-4000:]}"
        out[side] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("kind", ["params", "moments", "cache"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axis_trees_and_specs_equal_the_reference(specs, arch, mesh, kind):
    ref = specs["reference"][mesh][arch][kind]
    port = specs["port"][mesh][arch][kind]
    assert sorted(port) == sorted(ref)
    for leaf in ref:
        assert port[leaf] == ref[leaf], (leaf, port[leaf], ref[leaf])


def test_specs_shard_something(specs):
    """The comparison is not vacuous: ZeRO-1 and the model axis both show."""
    p = specs["port"]["multi"]["yi-6b"]
    assert p["moments"]["blocks.wq"] == [["layers", "zero", "heads"],
                                         [None, "data", "model"]]
    assert p["cache"]["kpool"][1][1] == ["pod", "data"]


def test_shard_is_the_identity_without_a_mesh():
    assert SH.get_mesh() is None
    x = torch.from_numpy(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert SH.shard(x, "batch", "seq", "embed") is x
    assert SH.logical_spec("batch", "heads") == (None, None)
    assert SH.named_sharding("batch") is None
    assert SH.distribute({"w": x}, {"w": ("embed", "mlp", None)})["w"] is x


def test_rules_and_placements_on_a_stand_in_mesh():
    """``logical_spec``'s degrade-to-replicated rule and the placements of a
    dim sharded over two axes, on an object with a mesh's two fields."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.zeros(2, 4, 8)
    with SH.use_mesh(Mesh(), {"seq": ("model",)}):
        assert SH.get_rules()["seq"] == ("model",)
        assert SH.logical_spec("batch", "seq", "kv_heads",
                               size_of=(16, 64, 4)) == (
            ("pod", "data"), "model", None)
        assert SH.placements((("pod", "data"), None, "model"), Mesh()) == (
            Shard(0), Shard(0), Shard(2))
        assert SH.placements((None,), Mesh()) == (Replicate(),) * 3
    assert SH.get_mesh() is None and SH.get_rules()["seq"] is None
