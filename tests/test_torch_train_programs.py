"""The training loops' compiled step programs (``launch/train.py`` over
``repro_torch.runtime.graphs``) on the CPU.

The reference jits its training step once per plan key
(``repro.launch.train.jit_train_step``, the parameters, moments and
residuals donated) and its ``Supervisor`` records each build in
``compiled_at``.  The port's loops run every step through one
``graphs.Program`` per plan key (a CUDA graph on the card; on the CPU
the same static-buffer path without a capture), reading and updating
the train state in place.  On the smoke StableLM (one layer, f32
weights) over 4 workers of 256 tokens, the loader's four compositions
set to ``COMPS`` (three distinct: three plan keys, built at steps 0, 1
and 3; the loader's own draws need a budget of 4096 tokens for two
distinct ones, whose plain attention took 5 s a step here):

* (a) programs give the eager closure's bytes over two rounds of the
  stream, for the plain ``Trainer`` and for the ``Supervisor``: losses,
  gradient norms and every parameter bitwise (same code on the CPU);
* (b) the port's ``compiled_at`` equals the reference ``Supervisor``'s
  on the same stream, run through JAX on the CPU (one worker: the
  suite's JAX has one device);
* (c) after the first round nothing is built: the plain loop, the
  healthy Supervisor and the bf16 wire;
* (d) the pod drill (the geometry of the reference's
  ``tests/multidevice/run_fault_drill.py``, ``launch/drills.pod_drill``:
  survivor and post-rejoin losses within its 1e-6 of the drill's
  uninterrupted reference run) builds no program at the rejoin;
* (e) a recovery from the seed (no checkpoint), the residual reset and
  the rejoin keep the held tensors (same ``data_ptr``), and the seed's
  restore writes ``init_state``'s bytes;
* (f) ``compress_grads`` updates the error-feedback residuals in place,
  the bytes of the same arithmetic out of place;
* (g) a rebound held tensor raises; an evicted key drops its program;
* (h) the CLI prints ``N compiles`` for both loops.

Torch runs on one thread here: with eight, two eager runs of (a) already
differ in their last bits (the CPU's multi-threaded reductions), so the
bitwise comparison would read the CPU's order of summation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import smoke_config as j_smoke
from repro.launch import train as JT
from repro_torch.configs.base import ParallelConfig, TrainConfig, smoke_config
from repro_torch.launch import drills
from repro_torch.launch import train as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw
from repro_torch.runtime import compression, wire
from test_torch_threads import intra_op_share  # noqa: F401

N, TPW, BS = 4, 256, 64
COMPS = [[700, 324], [1024], [1024], [300, 724]]
ROUND = len(COMPS)                          # the loader's n_buckets
STEPS = 2 * ROUND
# the pod drill: the reference runner's geometry
P0, POD_WORKERS, POD_TPW, POD_BS = 2, 2, 256, 128
CKPT_EVERY, TOTAL = 2, 12
POD_FAIL_STEP, POD_REJOIN = 5, 9


@pytest.fixture(autouse=True, scope="module")
def one_thread(intra_op_share):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(smoke_config("stablelm_1_6b"), n_layers=1,
                               param_dtype="float32")


def _stream(loop):
    """The loop's stream of compositions set to ``COMPS``."""
    loop.loader.compositions = [list(c) for c in COMPS]
    return loop


def _pcfg(**kw):
    kw.setdefault("block_size", BS)
    kw.setdefault("coalesce", 4)
    kw.setdefault("in_dtype_bytes", 4.0)
    kw.setdefault("checkpoint_every", 0)
    return ParallelConfig(**kw)


def _tcfg(**kw):
    return TrainConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS, **kw)


def _trainer(**pkw):
    return _stream(T.Trainer(_cfg(), _pcfg(**pkw), _tcfg(),
                             T.StackedMesh((N, 1)), tokens_per_worker=TPW,
                             dist="real_world", device="cpu", log_every=100,
                             attn_impl="fused_xla"))


def _supervisor(n=N, tpw=TPW, bs=BS, **pkw):
    return _stream(T.Supervisor(_cfg(), _pcfg(block_size=bs, **pkw),
                                _tcfg(), n_workers=n, tokens_per_worker=tpw,
                                dist="real_world", verbose=False,
                                device="cpu", attn_impl="fused_xla"))


def _eager(name, fn):
    """In place of a loop's ``_program``: the eager step, called as a
    program is."""
    def call(*inputs, held=None):
        return fn(*inputs)
    call.fn, call.builds = fn, 1
    return call


def _builds(loop) -> int:
    cache = loop.step_cache if isinstance(loop, T.Trainer) \
        else loop._step_cache
    return sum(p.builds for p in cache.values())


def _run(loop, steps):
    out = loop.run(steps)
    loop.close()
    return out


@pytest.mark.parametrize("loop", ["trainer", "supervisor"])
def test_programs_give_the_eager_bytes(loop):
    make = _trainer if loop == "trainer" else _supervisor
    prog, eager = make(), make()
    eager._program = _eager
    for tr in (prog, eager):
        _run(tr, STEPS)
    assert prog.compiled_at == eager.compiled_at == [0, 1, 3]
    assert [(r.loss, r.gnorm) for r in prog.history] \
        == [(r.loss, r.gnorm) for r in eager.history]
    for a, b in zip(adamw.tree_leaves(prog.state.params),
                    adamw.tree_leaves(eager.state.params)):
        assert torch.equal(a, b)


def test_compiled_at_matches_the_reference_supervisor():
    """One worker of the whole budget in one block (the suite's JAX has
    one device; its compiles are the test's time): the same stream, so
    the same three plan keys."""
    jcfg = dataclasses.replace(j_smoke("stablelm_1_6b"), n_layers=1,
                               param_dtype="float32")
    jsup = JT.Supervisor(
        jcfg, JParallel(block_size=N * TPW, remat=False, coalesce=4,
                        in_dtype_bytes=4.0, checkpoint_every=0,
                        attention_impl="fused_xla"),
        JTrain(lr=1e-3, warmup_steps=2, total_steps=STEPS),
        n_workers=1, tokens_per_worker=N * TPW, dist="real_world",
        verbose=False)
    jsup.loader.compositions = [list(c) for c in COMPS]
    jsup.run(STEPS)
    sup = _supervisor(n=1, tpw=N * TPW, bs=N * TPW)
    out = sup.run(STEPS)
    assert sup.compiled_at == jsup.compiled_at == [0, 1, 3]
    assert out["compiles"] == len(jsup.compiled_at)


@pytest.mark.parametrize("setting", ["plain", "supervisor", "bf16_wire"])
def test_nothing_is_built_after_the_first_round(setting):
    kw = {"comm_dtype": "bf16"} if setting == "bf16_wire" else {}
    tr = (_supervisor if setting == "supervisor" else _trainer)(**kw)
    _run(tr, STEPS)
    assert len(tr.history) == STEPS
    # every build in the first round, one per key
    assert tr.compiled_at == [0, 1, 3] and _builds(tr) == 3
    if setting == "supervisor":
        assert tr.monitor.events == []      # no build step demoted a worker


def _pod_factory():
    cfg = _cfg()
    pcfg = ParallelConfig(block_size=POD_BS, remat=False, coalesce=4,
                          in_dtype_bytes=4.0, checkpoint_every=CKPT_EVERY)

    def make(ckpt_dir, **kw):
        tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TOTAL,
                           grad_compression=True)
        return T.Supervisor(cfg, pcfg, tcfg, n_workers=POD_WORKERS,
                            tokens_per_worker=POD_TPW, pods=P0,
                            dist="real_world", checkpoint_dir=ckpt_dir,
                            verbose=False, device="cpu",
                            attn_impl="fused_xla", **kw)
    return make


def test_pod_drill_rejoin_builds_nothing(tmp_path):
    out = drills.pod_drill(_pod_factory(), tmp_path, total=TOTAL,
                           fail_step=POD_FAIL_STEP, fail_round=1,
                           rejoin_step=POD_REJOIN, every=CKPT_EVERY)
    assert out["replay_max_diff"] <= drills.REPLAY_TOL
    assert out["post_rejoin_steps"] == TOTAL - POD_REJOIN
    rj = out["rejoin"]
    assert rj["builds_after"] == rj["builds_before"]
    assert rj["compiles_after"] == rj["compiles_before"]


def _ptrs(state):
    return [x.data_ptr() for x in adamw.tree_leaves(
        {"p": state.params, "m": state.opt.m, "v": state.opt.v,
         "r": state.residual}) + [state.opt.step]]


def test_recovery_and_rejoin_keep_the_held_tensors():
    """A pod loss with no checkpoint: the Supervisor restores the seed's
    state, resets the residuals and later regrows; every program keeps
    reading the tensors it was built on."""
    from repro_torch.runtime import elastic
    make = _pod_factory()
    sup = make(None)
    before = _ptrs(sup.state)
    sup.run(8, fail=elastic.InjectedFailure(pod=1, step=3, round=1),
            rejoin_step=6)
    assert _ptrs(sup.state) == before
    assert sup.recoveries[0]["resume_step"] == 0
    assert sup.recoveries[0]["ef_reset"] and len(sup.rejoins) == 1
    assert [(r.step, r.pods) for r in sup.history][-2:] == [(6, 2), (7, 2)]
    # the seed's restore writes init_state's bytes into the held tensors
    fresh = T.init_state(sup.model, sup.tcfg, "cpu")
    T.reset_state(sup.state, sup.model, sup.tcfg, "cpu")
    assert _ptrs(sup.state) == before
    for a, b in zip(adamw.tree_leaves({"p": sup.state.params,
                                       "m": sup.state.opt.m,
                                       "v": sup.state.opt.v}),
                    adamw.tree_leaves({"p": fresh.params, "m": fresh.opt.m,
                                       "v": fresh.opt.v})):
        assert torch.equal(a, b)
    assert int(sup.state.opt.step) == 0


def test_residuals_are_updated_in_place():
    """``compress_grads`` writes the new residuals into the ones it is
    given (a step program holds them), the bytes of the error-feedback
    arithmetic out of place; ``reset_residuals`` zeroes them there."""
    rng = np.random.default_rng(3)
    tree = {"b": rng.normal(size=(3, 4)),
            "a": {"w": rng.normal(size=(5,)), "v": rng.normal(size=(2, 2))}}
    grads = params_from_numpy(tree, "cpu", torch.float32)
    res = params_from_numpy(adamw.tree_map(lambda x: x * 1e-3, tree), "cpu",
                            torch.float32)
    fmt = wire.WIRE_BF16

    def out_of_place(g, r):
        g32 = g + r
        gc, _ = wire.encode(g32, fmt)
        return gc, g32 - wire.decode(gc, None, fmt, torch.float32)
    want = adamw.tree_map(out_of_place, grads, res)
    ptrs = [r.data_ptr() for r in adamw.tree_leaves(res)]
    got_c, got_r = compression.compress_grads(grads, res, fmt)
    assert got_r is res
    assert [r.data_ptr() for r in adamw.tree_leaves(res)] == ptrs
    for (wc, wr), c, r in zip(adamw.tree_leaves(want),
                              adamw.tree_leaves(got_c),
                              adamw.tree_leaves(got_r)):
        assert torch.equal(c, wc) and torch.equal(r, wr)
    compression.reset_residuals(res)
    assert [r.data_ptr() for r in adamw.tree_leaves(res)] == ptrs
    assert all(not r.any() for r in adamw.tree_leaves(res))


def test_rebound_held_tensor_raises_and_eviction_drops_programs():
    tr = _trainer(plan_cache_size=1)
    tr.run(ROUND + 1)
    # a one-entry cache: every change of key builds again
    assert tr.compiled_at == [0, 1, 3, 4] and len(tr.step_cache) == 1
    # the last key's batch again, its state rebound: its graph would read
    # the old tensor
    tr.loader.state.step -= 1
    tr.state.opt.step = tr.state.opt.step.clone()
    with pytest.raises(ValueError, match="held tensors"):
        tr.step()
    tr.close()


@pytest.mark.parametrize("supervised", [True, False])
def test_cli_prints_compiles(capsys, supervised):
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1",
            "--dist", "real_world", "--block-size", "32",
            "--tokens-per-worker", "128", "--steps", "2", "--device", "cpu",
            "--attn-impl", "fused_xla",
            "--supervised" if supervised else "--no-supervised"]
    tr = T.main(argv)
    out = capsys.readouterr().out
    assert isinstance(tr, T.Supervisor if supervised else T.Trainer)
    assert f"{len(tr.compiled_at)} compiles" in out
    assert len(tr.compiled_at) == 1
