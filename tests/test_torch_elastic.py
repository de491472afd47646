"""The port's checkpoints, Supervisor and gradient accumulation on the CPU:
the checkpointer's format against the reference's (either package
restores the other's files), CRC corruption and uncommitted directories,
the kill and straggler drills of ``tests/multidevice/run_fault_drill.py``
on stacked CPU workers held to that runner's limits, a pod mesh through
the CLI's Supervisor, a resumed plain
loop against an uninterrupted one, and ``grad_accum.accumulate`` against
the reference's.

Tolerances: checkpoints bitwise; the kill drill's replay 1e-6
normalized (the runner's); a resumed plain loop bitwise (same code, same
bytes); ``accumulate`` 1e-6 (the optimizer pieces' bound in
``tests/test_torch_train.py``)."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.optimizer import adamw as jadamw
from repro.optimizer import grad_accum as jaccum
from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ParallelConfig, TrainConfig, smoke_config
from repro_torch.launch import drills
from repro_torch.launch import train as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw, grad_accum
from test_torch_threads import intra_op_share  # noqa: F401


# the fault drill's geometry (N0 4 workers, smoke widths)
N0, TPW0, BS = 4, 512, 128
CKPT_EVERY = 2
FAIL_STEP, FAIL_WORKER, FAIL_ROUND = 7, 1, 2
TOTAL = 12


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {
        "w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "emb": torch.from_numpy(rng.normal(size=(5, 2)).astype(
            np.float32)).to(torch.bfloat16),
        "ids": [torch.arange(6, dtype=torch.int32),
                (np.int64(7), torch.tensor(3.5))]},
        "opt": adamw.AdamWState(step=torch.tensor(4, dtype=torch.int32),
                                m={"w": torch.ones(4, 3)},
                                v={"w": torch.full((4, 3), 2.0)})}


def _leaves(tree):
    return [x for _, x in checkpointer._flatten(tree)]


def test_checkpoint_round_trip(tmp_path):
    t = _tree()
    checkpointer.save(tmp_path / "ck", t, extra={"step": 3})
    got = checkpointer.restore(tmp_path / "ck", t)
    assert isinstance(got["opt"], adamw.AdamWState)
    assert isinstance(got["params"]["ids"][1], tuple)
    for a, b in zip(_leaves(got), _leaves(t)):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert checkpointer.read_extra(tmp_path / "ck") == {"step": 3}
    # async: the host copy is taken at the call, the IO runs on a thread
    th = checkpointer.save_async(tmp_path / "ck2", t)
    t["params"]["w"].add_(1.0)
    th.join(timeout=60)
    assert not th.is_alive()
    w = checkpointer.restore(tmp_path / "ck2", t)["params"]["w"]
    assert torch.equal(w + 1.0, t["params"]["w"])


def test_flipped_byte_raises_corruption(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep_n=3)
    mgr.save(4, t)
    mgr.save(6, t)
    arr = sorted(mgr.path(6).glob("arr_*.npy"))[0]
    raw = bytearray(arr.read_bytes())
    raw[-1] ^= 0x40                 # payload tail, past the .npy header
    arr.write_bytes(bytes(raw))
    with pytest.raises(checkpointer.CheckpointCorruption, match="CRC32"):
        checkpointer.restore(mgr.path(6), t)
    _, extra = mgr.restore(t)       # falls back to the newest intact
    assert extra["step"] == 4


def test_uncommitted_directory_is_ignored(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, t)
    checkpointer.save(tmp_path / "step_5", t)
    (tmp_path / "step_5" / "COMMIT").unlink()     # died before COMMIT
    (tmp_path / "step_9.tmp").mkdir()             # died mid-write
    assert mgr.latest_step() == 2
    with pytest.raises(FileNotFoundError):
        checkpointer.restore(tmp_path / "step_5", t)
    CheckpointManager(tmp_path)                   # sweeps both
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2"]


def test_checkpoints_cross_packages(tmp_path):
    """Params (bf16) and AdamW state written by the reference restore in
    the port equal to ``params_from_numpy``, and the port's in the
    reference, leaf for leaf and bit for bit."""
    cfg = j_smoke("stablelm_1_6b")
    assert cfg.param_dtype == "bfloat16"
    jparams = JModel(cfg).init(jax.random.key(0))
    jopt = jadamw.init(jparams)
    jopt = jadamw.AdamWState(jnp.int32(5), jopt.m,
                             jax.tree.map(lambda x: x + 0.5, jopt.v))
    jtree = {"params": jparams, "opt": jopt}
    jckpt.save(tmp_path / "ref", jtree, extra={"step": 5})

    np_tree = jax.device_get(jtree)
    want = {"params": params_from_numpy(np_tree["params"], "cpu"),
            "opt": adamw.AdamWState(
                torch.tensor(5, dtype=torch.int32),
                params_from_numpy(np_tree["opt"].m, "cpu"),
                params_from_numpy(np_tree["opt"].v, "cpu"))}
    got = checkpointer.restore(tmp_path / "ref", want)
    assert len(_leaves(got)) == len(jax.tree.leaves(jtree))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    checkpointer.save(tmp_path / "port", want, extra={"step": 5})
    back = jckpt.restore(tmp_path / "port", np_tree)   # CRCs checked
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _cfg():
    return dataclasses.replace(smoke_config("stablelm_1_6b"),
                               param_dtype="float32")


def _pcfg(**kw):
    kw.setdefault("block_size", BS)
    kw.setdefault("remat", False)
    kw.setdefault("coalesce", 4)
    kw.setdefault("in_dtype_bytes", 4.0)
    kw.setdefault("checkpoint_every", CKPT_EVERY)
    return ParallelConfig(**kw)


def _sup_factory(pcfg):
    def make(ckpt_dir, **kw):
        tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TOTAL)
        # keep every checkpoint: the reference run restores from a
        # pruned copy of the directory
        return T.Supervisor(_cfg(), pcfg, tcfg, n_workers=N0,
                            tokens_per_worker=TPW0, dist="real_world",
                            checkpoint_dir=ckpt_dir, checkpoint_keep=8,
                            verbose=False, device="cpu",
                            attn_impl="fused_xla", **kw)
    return make


def test_kill_drill(tmp_path):
    out = drills.kill_drill(_sup_factory(_pcfg()), tmp_path, total=TOTAL,
                            fail_step=FAIL_STEP, fail_worker=FAIL_WORKER,
                            fail_round=FAIL_ROUND, every=CKPT_EVERY)
    assert out["n_workers"] == N0 - 1 and out["steps_lost"] <= CKPT_EVERY
    assert out["steps_compared"] == TOTAL - out["resume_step"]


def test_kill_drill_waits_for_inflight_saves(tmp_path, monkeypatch):
    """Checkpoint file IO slower than the steps between a save and the
    failure: a save stays uncommitted until someone waits on its manager
    with it in flight.  The Supervisor runs one save at a time, so with
    the failure before the second save none has committed when it
    strikes; recovery must wait for the one in flight and resume after
    it, not from the seed (a card's steps outrun its disk writes the
    same way)."""
    released = threading.Event()
    save, wait = checkpointer.save, CheckpointManager.wait

    def slow_save(*a, **kw):
        released.wait(timeout=60)
        save(*a, **kw)

    def releasing_wait(self):
        if self._pending:
            released.set()
        wait(self)

    monkeypatch.setattr(checkpointer, "save", slow_save)
    monkeypatch.setattr(CheckpointManager, "wait", releasing_wait)
    fail_step = CKPT_EVERY + 1
    out = drills.kill_drill(_sup_factory(_pcfg()), tmp_path, total=TOTAL,
                            fail_step=fail_step, fail_worker=FAIL_WORKER,
                            fail_round=FAIL_ROUND, every=CKPT_EVERY)
    assert out["steps_lost"] == 1 and out["resume_step"] == fail_step - 1


def test_straggler_drill():
    window, cooldown = 3, 4
    pcfg = _pcfg(checkpoint_every=0, health_window=window,
                 demote_cooldown=cooldown)
    out = drills.straggler_drill(_sup_factory(pcfg), total=TOTAL,
                                 window=window, cooldown=cooldown)
    assert out["demoted_at"] < window + cooldown


def test_plain_loop_resumes_from_checkpoint(tmp_path):
    """A new Trainer on the directory resumes at the newest committed
    step: its steps are the uninterrupted run's, bit for bit."""
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1",
            "--dist", "real_world", "--block-size", "32",
            "--tokens-per-worker", "128", "--device", "cpu",
            "--no-supervised", "--checkpoint-every", "2",
            "--attn-impl", "fused_xla"]
    full = T.main(argv + ["--steps", "4"])
    first = T.main(argv + ["--steps", "2", "--checkpoint-dir",
                           str(tmp_path)])
    resumed = T.main(argv + ["--steps", "4", "--checkpoint-dir",
                             str(tmp_path)])
    assert resumed.start == 2 and [r.step for r in resumed.history] == [2, 3]
    assert [(r.loss, r.gnorm) for r in first.history + resumed.history] \
        == [(r.loss, r.gnorm) for r in full.history]
    for a, b in zip(adamw.tree_leaves(resumed.state.params),
                    adamw.tree_leaves(full.state.params)):
        assert torch.equal(a, b)


def test_grad_accum_matches_reference():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(8, 3)).astype(np.float32)
    xs = rng.normal(size=(4, 5, 8)).astype(np.float32)     # 4 microbatches
    ys = rng.normal(size=(4, 5, 3)).astype(np.float32)

    def jloss(p, mb):
        return jnp.mean((jnp.tanh(mb["x"] @ p["w"]) - mb["y"]) ** 2)

    def tloss(p, mb):
        return torch.mean((torch.tanh(mb["x"] @ p["w"]) - mb["y"]) ** 2)

    jl, jg = jaccum.accumulate(jloss, {"w": jnp.asarray(w)},
                               {"x": jnp.asarray(xs), "y": jnp.asarray(ys)})
    tl, tg = grad_accum.accumulate(
        tloss, {"w": torch.from_numpy(w)},
        {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
    assert abs(float(tl) - float(jl)) <= 1e-6
    assert tg["w"].dtype == torch.float32
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               atol=1e-6, rtol=1e-6)


def test_supervised_pod_mesh_runs():
    """The CLI sends a pod mesh to the Supervisor, which runs P pods of
    the data axis's workers (the pod drill: ``tests/test_torch_pods.py``)."""
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "2x4x1",
            "--dist", "real_world", "--block-size", "32",
            "--tokens-per-worker", "64", "--steps", "2", "--device", "cpu",
            "--supervised", "--attn-impl", "fused_xla"]
    sup = T.main(argv)
    assert isinstance(sup, T.Supervisor) and (sup.p0, sup.n0) == (2, 4)
    out = sup.summary()
    assert (out["pods"], out["n_workers"], out["steps"]) == (2, 4, 2)
    assert sup.monitor.topology.n_total == 8
    assert all(r.pods == 2 and np.isfinite(r.loss) for r in sup.history)
    direct = T.Supervisor(_cfg(), _pcfg(), TrainConfig(), n_workers=2,
                          tokens_per_worker=TPW0, pods=2, device="cpu",
                          start_fleet=(1, 2))
    assert (direct.p0, direct.pods, direct.n) == (2, 1, 2)
    assert direct._mesh(1, 2).shape == {"pod": 1, "data": 2, "model": 1}
    direct.close()
