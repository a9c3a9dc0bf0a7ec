"""The port's sharded training against the JAX package's unsharded run.

The JAX package's ``test_sharded_train_step_matches_single_device`` for
the port: ``smoke_config("yi-6b")`` from the reference's parameters
(``PRNGKey(0)``) on a batch of 8 x 64 tokens, lr 1e-3, two steps.  The
reference runs unsharded here; the port runs on 8 gloo ranks as a (2, 4)
``("data", "model")`` mesh, parameters and ZeRO-1 moments placed by their
logical axes (spawned once, in a subprocess: process groups are global to
a process).  Tolerances are the reference test's: loss 1e-3, every leaf
atol 2e-4 / rtol 2e-3.  Also the launcher's ``--mesh single``: one step
on a fake 256-rank group goes through the production mesh (the wrong
world size is ``tests/test_torch_checkpoint.py``'s).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training.train_step import make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
STEPS = 2


def _flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), HERE]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shardtrain")
    cfg = smoke_config("yi-6b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, cfg.vocab)
    batch = {"inputs": toks, "labels": jnp.roll(toks, -1, 1)}
    inputs = str(d / "inputs.npz")
    np.savez(inputs, lr=1e-3, steps=STEPS,
             inputs=np.asarray(toks, np.int32),
             labels=np.asarray(batch["labels"], np.int32),
             **_flat(params, "p."))
    out = str(d / "port.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import _shardtrain as t\n"
         "if __name__ == '__main__':\n"
         f"    t.port_main({inputs!r}, {out!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(d))
    step = jax.jit(make_train_step(cfg, JO.OptConfig(lr=1e-3)))
    p, s = params, JO.init(params)
    losses = []
    for _ in range(STEPS):
        p, s, st = step(p, s, batch)
        losses.append(float(st["loss"]))
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return {"losses": losses, "params": _flat(p, "p."), "m": _flat(s.m, "m."),
            "port": dict(np.load(out))}


def test_losses_equal_the_unsharded_reference(runs):
    got = runs["port"]["losses"]
    assert len(got) == STEPS
    for a, b in zip(runs["losses"], got):
        assert abs(a - b) < 1e-3, (runs["losses"], got)


@pytest.mark.parametrize("tree", ["params", "m"])
def test_leaves_equal_the_unsharded_reference(runs, tree):
    want = runs[tree]
    for k, a in want.items():
        np.testing.assert_allclose(runs["port"][k], a, atol=2e-4, rtol=2e-3,
                                   err_msg=k)


def test_leaves_were_sharded(runs):
    """Tensor parallel over model, ZeRO-1 over data: the run was sharded."""
    placed = dict(x.split("=", 1) for x in runs["port"]["placed"])
    assert placed["p.blocks.wq"] == "(Replicate(), Shard(dim=2))"
    assert placed["m.blocks.wq"] == "(Shard(dim=1), Shard(dim=2))"


def test_sharded_kv_heads_equal_the_unsharded_steps(runs):
    """With 4 kv heads the model axis shards k and v (and q's groups with
    them): the sharded steps equal the port's unsharded ones within the
    same tolerances."""
    port = runs["port"]
    assert str(port["kv_placed"]) == "(Replicate(), Shard(dim=2))"
    for a, b in zip(port["kv_ref_losses"], port["kv_losses"]):
        assert abs(a - b) < 1e-3
    assert float(port["kv_excess"]) <= 2e-4


def test_launcher_mesh_runs_on_a_fake_production_group():
    r = subprocess.run(
        [sys.executable, "-c", "import _shardtrain as t; t.launcher_fake()"],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "LOSSES 1" in r.stdout
