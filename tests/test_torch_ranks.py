"""FCP across processes on the CPU: ranks of a gloo process group, each
holding a share of the CP workers (``runtime/wire`` ``Ranks``), against
the stacked transport, the stacked executor and train step, and the
reference's train step.

The ranks are spawned processes (``tests/torch_ranks_jobs.py``, which
imports neither JAX nor the reference), one group of two ranks for every
two-rank case and one of four for the ships, each under its own
deadline.

Tolerances: ships byte for byte, forward and backward, under every wire
format (a payload crosses whole, encoded before and decoded after, as
the stacked index copy does); the executor's o, dq, dk and dv within
1e-6 of the stacked executor's, normalized by the largest entry; the
ranked train step against the reference's jitted dense step at
``tests/test_torch_train.py``'s tolerances (1e-4 per leaf, the three
steps' (loss, gnorm) within rtol 1e-4) and against the port's stacked
step within 1e-6 (loss, relative) and 1e-5 (each leaf, normalized: the
gradient is summed over the ranks in another order); the parameters
after three steps the same bytes on both ranks; the bytes each rank puts
on the wire in a step exactly the ``WireFormat.group_bytes`` pricing of
its cross-rank pairs (``runtime.wire.rank_wire_bytes``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks_jobs as J
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import smoke_config as j_smoke
from repro.data import SyntheticLoader as JLoader
from repro.launch import train as JT
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.optimizer import adamw as jadamw
from repro_torch.configs.base import ParallelConfig
from repro_torch.core import executor as ex
from repro_torch.core.schedule import make_schedule
from repro_torch.data import SyntheticLoader
from repro_torch.launch import train as T
from repro_torch.runtime import wire
from test_torch_threads import intra_op_share  # noqa: F401


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def np_params():
    jcfg = dataclasses.replace(j_smoke(J.ARCH), param_dtype="float32")
    return jcfg, jax.device_get(JModel(jcfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def two(np_params, tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    torch.save(np_params[1], d / "params.pt")
    return J.run(2, "two", d, timeout=150, params_path=str(d / "params.pt"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return J.run(4, "ships", tmp_path_factory.mktemp("four_ranks"))


# --------------------------------------------------------------------------
# (a) the transport
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", J.FORMATS)
@pytest.mark.parametrize("size", [2, 4])
def test_ship_across_ranks_matches_stacked_bytes(size, fmt, request):
    got = (request.getfixturevalue("two") if size == 2
           else request.getfixturevalue("four"))
    ships = [r["ships"] if size == 2 else r for r in got]
    x, g = J.ship_inputs()
    for p, perm in enumerate(J.PERMS):
        y, dx = J.ship_case(x, g, perm, fmt)
        y_r = np.concatenate([s[p, fmt][0] for s in ships])
        dx_r = np.concatenate([s[p, fmt][1] for s in ships])
        assert y_r.tobytes() == y.tobytes(), (perm, "forward")
        assert dx_r.tobytes() == dx.tobytes(), (perm, "backward")


def test_rank_ship_refuses_what_this_slice_does_not_run():
    ranks = wire.Ranks(2, 0, "gloo")
    assert ranks.share(4) == (0, 2) and wire.Ranks(2, 1, "gloo").share(4) \
        == (2, 4)
    # after a worker loss the survivors split as floor division allows;
    # the plain loop's and the serving loop's even rule still refuses
    assert ranks.share(3) == (0, 1) and wire.Ranks(2, 1, "gloo").share(3) \
        == (1, 3)
    with pytest.raises(ValueError, match="do not divide"):
        ranks.share(3, even=True)
    with pytest.raises(ValueError, match="ranks without a process group"):
        wire.Ranks(2, 0, None)
    sched = make_schedule(J.SEQLENS, J.N, J.TPW, J.BS, n_q_heads=J.H,
                          n_kv_heads=J.KH, head_dim=J.D, overlap=True)
    tabs = ex.schedule_tables(sched, "cpu", 1, ranks)
    assert tabs["frames"] == (0, 2) and tabs["workers"].shape[0] == 2
    xs = [torch.zeros(2, J.TPW, h, J.D) for h in (J.H, J.KH, J.KH)]
    with pytest.raises(ValueError, match="--overlap"):
        ex.fcp_attention(*xs, tabs, spec=sched.spec)
    with pytest.raises(ValueError, match="fcp_reshuffle"):
        ex.fcp_reshuffle(torch.zeros(2, J.TPW, 8), tabs, spec=sched.spec)
    # pods across ranks: a rank holds its share of the pod-major frames
    pod_tabs = ex.schedule_tables(sched, "cpu", 2, ranks)
    assert pod_tabs["frames"] == (0, 4) and pod_tabs["workers"].shape[0] == 4


# --------------------------------------------------------------------------
# (b) the executor on a rank's frames
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", J.EXEC_CASES,
                         ids=["-".join(map(str, c)) for c in J.EXEC_CASES])
def test_fcp_attention_across_ranks_matches_stacked(case, two):
    ref = J.exec_case(*case, None)
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r["exec"][case][i] for r in two])
        assert _nerr(got, ref[i]) <= 1e-6, name


# --------------------------------------------------------------------------
# (c, d) the train step across ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step(np_params):
    """The reference's step-0 loss and gradients and three jitted steps,
    dense attention on a 1x1 mesh (``test_train_step_matches_jax``)."""
    jcfg, params = np_params
    jb = JLoader(**J.loader_kw(jcfg)).next()
    jparams = jax.tree.map(jnp.asarray, params)
    jmodel, mesh = JModel(jcfg), make_mesh((1, 1), ("data", "model"))
    jbatch = JT.batch_arrays(jb, jcfg)
    jattn = j_dense_attn(jnp.asarray(jb.seg_ids), jbatch["positions"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, jattn)))(jparams)
    jgrads = jax.device_get(jgrads)
    jstep = JT.jit_train_step(
        JT.build_train_step(jmodel, mesh, JParallel(remat=False),
                            JTrain(**J.TCFG), jattn),
        mesh, jparams, jadamw.init(jparams), None, jbatch)
    p, o, log = jparams, jadamw.init(jparams), []
    for _ in range(3):
        p, o, _, loss, gnorm = jstep(p, o, None, jbatch)
        log.append((float(loss), float(gnorm)))
    return float(jloss), jax.tree.leaves(jgrads), log


def test_ranked_train_step_matches_jax(jax_step, two):
    jloss, jgrads, jlog = jax_step
    for r in two:
        loss, grads = r["grads"]
        assert abs(loss / jloss - 1) <= 1e-4
        assert len(grads) == len(jgrads)
        for a, b in zip(grads, jgrads):
            assert _nerr(a, b) <= 1e-4
        np.testing.assert_allclose(r["steps"][0], jlog, rtol=1e-4)


def test_ranked_train_step_matches_stacked(np_params, two):
    loss, grads = J.step_grads(J.smoke_cfg(), np_params[1])
    for r in two:
        r_loss, r_grads = r["grads"]
        assert abs(r_loss / loss - 1) <= 1e-6
        for a, b in zip(r_grads, grads):
            assert _nerr(a, b) <= 1e-5


def test_ranked_parameters_same_bytes_on_every_rank(two):
    a, b = (r["steps"][1] for r in two)
    assert len(a) == len(b) and all(x.tobytes() == y.tobytes()
                                    for x, y in zip(a, b))
    assert two[0]["steps"][0] == two[1]["steps"][0]


def test_ranked_trainer_matches_stacked_trainer(two):
    """The CLI's plain loop over two ranks (seeded weights, the loader's
    stream) against the stacked loop: the same builds, the records, and
    the same parameter bytes on both ranks."""
    log, compiled, params = J.trainer_run(None)
    for r in two:
        r_log, r_compiled, _ = r["trainer"]
        assert r_compiled == compiled
        np.testing.assert_allclose(r_log, log, rtol=1e-5)
    a, b = (r["trainer"][2] for r in two)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_ranked_checkpoint_resumes_on_every_rank(two):
    """Rank 0 writes each step's checkpoint into the directory both ranks
    share; a new ranked Trainer on it resumes at step 2 on both ranks with
    the bytes the first run ended with, the stacked run's parameters
    after two steps, and takes the uninterrupted run's third step."""
    _, _, params = J.trainer_run(None, steps=2)
    for r in two:
        ck = r["checkpoint"]
        assert ck["start"] == 2
        assert all(x.tobytes() == y.tobytes()
                   for x, y in zip(ck["restored"], ck["saved"]))
        assert all(_nerr(x, y) <= 1e-5
                   for x, y in zip(ck["restored"], params))
        assert ck["next"] == r["trainer"][0][2]
    a, b = (r["checkpoint"]["restored"] for r in two)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_ranks_module_runs_the_cli_and_checks_gradients(two):
    """``repro_torch.launch.ranks``, which the card's smoke runs: the CLI
    under each impl on both ranks (the same records, bytes on the wire
    each step, one build per plan key) and the gradient check."""
    for impl, steps in (("fused_xla", 2), ("xla", 1)):
        a, b = (r["ranks_module"][impl] for r in two)
        assert [x["loss"] for x in a["records"]] == [
            x["loss"] for x in b["records"]]
        assert len(a["records"]) == steps and (a["frames"], b["frames"]) \
            == ([0, 2], [2, 4])
        assert all(x["sent_bytes"] > 0 for x in a["records"] + b["records"])
        assert a["wire"]["sent_bytes"] == sum(x["sent_bytes"]
                                              for x in a["records"])
    grads = two[0]["ranks_module"]["grads"]
    for impl in ("fused_xla", "xla"):
        assert grads[impl]["finite"] and grads[impl]["max_leaf_err"] <= 1e-5
        assert abs(grads[impl]["loss_ranked"] / grads[impl]["loss"] - 1) \
            <= 1e-6


# --------------------------------------------------------------------------
# (e) bytes on the wire
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire_fmt", J.WIRES)
def test_wire_bytes_match_pricing(wire_fmt, two):
    """Every layer's forward ships twice (the forward, and its recompute
    under the default remat) and its backward once."""
    cfg = J.smoke_cfg()
    pcfg = ParallelConfig(block_size=J.STEP_BS, comm_dtype=wire_fmt)
    b = SyntheticLoader(**J.loader_kw(cfg)).next()
    sched = T.build_schedule(cfg, pcfg, b.seqlens, J.N, J.STEP_TPW)
    nh, nkv = cfg.padded_heads(1)
    sent = []
    for r, res in enumerate(two):
        fwd, bwd = wire.rank_wire_bytes(sched.spec, wire.Ranks(2, r, "gloo"),
                                        nh, nkv, cfg.head_dim, 4.0)
        stats = res["bytes"][wire_fmt]
        assert fwd > 0 and bwd > 0
        assert stats["sent_bytes"] == cfg.n_layers * (2 * fwd + bwd)
        sent.append(stats)
    assert (sum(s["sent_bytes"] for s in sent)
            == sum(s["recv_bytes"] for s in sent))


# --------------------------------------------------------------------------
# (f) refusals
# --------------------------------------------------------------------------

BASE = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1", "--dist",
        "real_world", "--block-size", "64", "--tokens-per-worker", "256",
        "--steps", "1", "--device", "cpu", "--dist-backend", "gloo"]
REFUSALS = {
    "nccl_two_ranks_one_device": (["--device", "cuda:0", "--dist-backend",
                                   "nccl", "--no-supervised"], 2,
                                  "NCCL cannot run two ranks on one device"),
    "nccl_on_cpu": (["--dist-backend", "nccl", "--no-supervised"], 2,
                    "NCCL needs a CUDA device"),
    "ranks_not_dividing_data": (["--no-supervised"], 3,
                                "3 ranks do not divide the data axis"),
    "pods": (["--mesh", "2x3x1", "--no-supervised"], 4,
             "4 ranks cannot split a pod mesh of 2 pods x 3 workers"),
    "overlap": (["--overlap", "--no-supervised"], 2, "--overlap"),
    "layer_pipeline": (["--layer-pipeline", "--no-supervised"], 2,
                       "--layer-pipeline"),
    "supervisor": ([], 3, "3 ranks do not divide the data axis"),
    "non_dense_family": (["--arch", "granite_moe_3b_a800m",
                          "--no-supervised"], 2, "a non-dense family"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_refuses_under_a_process_group(name, monkeypatch):
    extra, size, msg = REFUSALS[name]
    for k, v in (("WORLD_SIZE", size), ("RANK", 0), ("LOCAL_RANK", 0),
                 ("LOCAL_WORLD_SIZE", size)):
        monkeypatch.setenv(k, str(v))

    def joined(*a, **k):
        raise AssertionError("joined a process group")
    monkeypatch.setattr(wire, "join", joined)
    with pytest.raises(ValueError, match=msg):
        T.trainer_from_args(T.parse_args(BASE + extra))
    assert not torch.distributed.is_initialized()


def test_serve_cli_refuses_under_a_process_group(monkeypatch):
    """The serve CLI serves across ranks since its own slice
    (``tests/test_torch_serve_ranks.py``); on its default one-worker mesh,
    whose prefill is dense, it still refuses, before joining a group."""
    from repro_torch.launch import serve
    for k, v in (("WORLD_SIZE", 2), ("RANK", 0), ("LOCAL_RANK", 0),
                 ("LOCAL_WORLD_SIZE", 2)):
        monkeypatch.setenv(k, str(v))

    def joined(*a, **k):
        raise AssertionError("joined a process group")
    monkeypatch.setattr(wire, "join", joined)
    with pytest.raises(ValueError, match="not supported across ranks yet "
                       r"\(ROADMAP Queue A: the dense prefill across ranks"):
        serve.main(["--arch", "stablelm_1_6b", "--smoke", "--device",
                    "cpu"])
