"""The port's checkpoint manager and train launcher, on the CPU.

The intents of ``tests/test_checkpoint.py`` (two-phase commit, invisible
.tmp, digests, gc, async save, resume) and of
``tests/test_system.py::test_train_short_run_with_checkpoint_restart``
with the port's manager; checkpoints written by either package restore
in the other byte for byte (the same leaf names, files and digests); the
launcher resumes from its newest committed step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "opt": {"m": torch.zeros(8, 4),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def same(a, b):
    fa = dict(O.leaves(a)) if isinstance(a, dict) else a
    fb = dict(O.leaves(b)) if isinstance(b, dict) else b
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = tree()
    mgr.save(7, t, extra={"loss": 1.5})
    out, step, extra = mgr.restore(tree(1))
    assert step == 7 and extra["loss"] == 1.5
    same(out, t)


def test_uncommitted_tmp_is_invisible(tmp_path):
    """A crash before the atomic rename (payload written, no manifest, no
    commit) is invisible to restart."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = tree()
    mgr.save(1, t)
    tmp = tmp_path / "step_000000002.tmp"
    os.makedirs(tmp)
    np.save(tmp / "w.npy", np.zeros((8, 4), np.float32))
    assert mgr.latest_step() == 1
    _, step, _ = mgr.restore(t)
    assert step == 1


def test_digest_verification(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t = tree()
    mgr.save(1, t)
    d = tmp_path / "step_000000001"
    arr = np.load(d / "w.npy")
    arr[0, 0] += 1
    np.save(d / "w.npy", arr)
    with pytest.raises(IOError):
        mgr.restore(t)


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree())
    assert mgr.committed_steps() == [3, 4]


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The async save copies to the host before it returns: the optimizer's
    in-place update that follows does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = tree()
    want = {k: v.clone() for k, v in O.leaves(t)}
    mgr.save(5, t)
    t["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    out, _, _ = mgr.restore(tree())
    same(dict(O.leaves(out)), want)


def test_restore_into_train_state_and_resume(tmp_path):
    """Train 3 steps, checkpoint, restart from a fresh init, resume: the
    restored step is 3 and the next loss continues below step 3's."""
    cfg = smoke_config("yi-6b")

    def fresh():
        p = T.init_params(cfg, torch.Generator().manual_seed(0),
                          master_dtype=torch.float32)
        return p, O.init(p)
    params, state = fresh()
    step_fn = make_train_step(cfg, O.OptConfig(lr=1e-3))
    b = launch_train.synthetic_batch(cfg, 1, 0, 2, 64, "cpu")
    for _ in range(3):
        params, state, stats = step_fn(params, state, b)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"params": params, "opt": state})
    params2, state2 = fresh()
    restored, step, _ = mgr.restore({"params": params2, "opt": state2})
    assert step == 3 and int(restored["opt"].step) == 3
    assert isinstance(restored["opt"], O.OptState)
    same(restored["params"], params)
    _, _, stats2 = step_fn(restored["params"], restored["opt"], b)
    assert float(stats2["loss"]) <= float(stats["loss"]) + 1e-3


@pytest.fixture
def one_thread():
    """One intra-op thread: a multithreaded CPU matmul may split its sums
    by the cores free at the time (the async save's thread competes), so
    the last bits of two runs would differ."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_short_run_with_checkpoint_restart(tmp_path, one_thread):
    """The MoE smoke twin: train, save at step 4, crash, restore into a
    fresh init through a new manager, train on: the losses equal the
    uninterrupted run's exactly (one process, one thread, deterministic
    CPU ops) and fall below the first."""
    cfg = smoke_config("granite-moe-1b-a400m")
    step_fn = make_train_step(cfg, O.OptConfig(lr=3e-3, warmup=2,
                                               decay_steps=60))
    b = launch_train.synthetic_batch(cfg, 1, 0, 4, 64, "cpu")

    def fresh():
        p = T.init_params(cfg, torch.Generator().manual_seed(0),
                          master_dtype=torch.float32)
        return p, O.init(p)
    params, state = fresh()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    losses = []
    for i in range(8):
        params, state, stats = step_fn(params, state, b)
        losses.append(float(stats["loss"]))
        if i == 3:
            mgr.save(4, {"p": params, "o": state})
    mgr.wait()
    p2, s2 = fresh()
    restored, at, _ = CheckpointManager(str(tmp_path)).restore(
        {"p": p2, "o": s2})
    assert at == 4 and int(restored["o"].step) == 4
    params, state = restored["p"], restored["o"]
    again = []
    for _ in range(4):
        params, state, stats = step_fn(params, state, b)
        again.append(float(stats["loss"]))
    assert again == losses[4:]
    assert again[-1] < losses[0]


def jax_state(seed=0):
    """The reference's {"p": params, "o": OptState} of the yi-6b smoke twin
    after one step's moments (numpy-free jax arrays)."""
    jcfg = jax_smoke_config("yi-6b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    m = jax.tree.map(lambda a: jnp.asarray(
        rng.randn(*a.shape).astype(np.float32)), jp)
    v = jax.tree.map(lambda a: jnp.asarray(np.abs(
        rng.randn(*a.shape)).astype(np.float32)), jp)
    return {"p": jp, "o": JO.OptState(m, v, jnp.asarray(7, jnp.int32))}


def port_state(js):
    """The same state carried into the port (float32 masters)."""
    cfg = smoke_config("yi-6b")
    p = convert.params_from_numpy(jax.tree.map(np.asarray, js["p"]), cfg,
                                  "cpu", master_dtype=torch.float32)
    return {"p": p, "o": convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, js["o"]), "cpu")}


def manifest(path, step):
    with open(os.path.join(path, f"step_{step:09d}", "MANIFEST.json")) as f:
        return json.load(f)


def test_checkpoints_cross_packages_byte_for_byte(tmp_path):
    js = jax_state()
    ts = port_state(js)
    ja, ta = tmp_path / "jax", tmp_path / "port"
    JaxManager(str(ja), async_save=False).save(2, js, extra={"k": 1})
    CheckpointManager(str(ta), async_save=False).save(2, ts, extra={"k": 1})
    # the same leaf names, files, shapes, dtypes and digests
    mj, mt = manifest(ja, 2), manifest(ta, 2)
    assert mj == mt
    assert "o.m.blocks.wq" in mt["arrays"] and "o.step" in mt["arrays"]
    assert "p.embed" in mt["arrays"]
    # the port restores the reference's checkpoint ...
    template = port_state(jax_state(1))
    got, step, extra = CheckpointManager(str(ja)).restore(template)
    assert step == 2 and extra == {"k": 1}
    assert isinstance(got["o"], O.OptState)
    same(got["p"], ts["p"])
    same(dict(O.leaves(got["o"].m)), dict(O.leaves(ts["o"].m)))
    assert got["o"].step.dtype == torch.int32 and int(got["o"].step) == 7
    # ... and the reference restores the port's
    back, step, _ = JaxManager(str(ta)).restore(jax_state(1))
    assert step == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "yi-6b", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt", ck, "--ckpt-every", "4", "--device", "cpu"]
    first = launch_train.main(args + ["--steps", "6"])
    assert len(first) == 6 and all(np.isfinite(first))
    assert CheckpointManager(ck).committed_steps() == [4, 6]
    more = launch_train.main(args + ["--steps", "9"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 6" in out
    assert len(more) == 3 and CheckpointManager(ck).latest_step() == 9


@pytest.mark.parametrize("argv,env,match", [
    (["--mesh", "single"], {}, "256 ranks, this one has 1"),
    (["--mesh", "multi"], {"WORLD_SIZE": "4"}, "512 ranks, this one has 4")])
def test_launcher_multi_device_waits_for_its_slice(argv, env, match,
                                                   monkeypatch):
    """The multi-device launch (torchrun's environment in place of the
    reference's JAX_COORDINATOR) refuses a world that is not its mesh's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        launch_train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu"]
                          + argv)
