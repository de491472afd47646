"""The Supervisor and pods across processes on the CPU: the train CLI's
default loop over the ranks of a gloo process group (``launch/train.py``
``Supervisor(dist_backend=)``), against the stacked Supervisor on the
same seed, the reference's survivor replans and the reference's pod
step.

One group of two ranks (``tests/torch_ranks_jobs.py`` ``job_supervisor``,
which imports neither JAX nor the reference) runs every case under one
deadline: ships over uneven shares, a broadcast and a one-member group;
the kill drill at R = D = 2 losing worker 1 and worker 0 (the checkpoint
writer: rank 1 writes and restores), a worker loss at R = 2, D = 4
(three survivors split 1 + 2 by ``Ranks.share``'s floor rule), the
straggler drill and the pod drill on a ``2x2x1`` mesh, one pod a rank
(and its loss and rejoin again on a one-program step cache, whose
survivor evicts the fleet's program while the idle rank keeps it); the
ranked pod step; the CLI's default loop on ``2x1`` and ``2x2x1``.

Tolerances: each drill holds ``launch/drills.py``'s limits on every rank
(``steps_lost <= checkpoint_every``, the replay within ``REPLAY_TOL`` =
1e-6 normalized, a demotion within window + cooldown, at the rejoin 0
plan misses and 0 step programs built); every rank's records against
the stacked Supervisor's on the same seed, loss within 1e-6 relative and
gnorm within 1e-5 (the gradient is summed over the ranks in another
order: ``tests/test_torch_ranks.py``'s bounds); the straggler's events
equal; the rejoined rank's parameters the same digest as the survivor's;
the schedules after each recovery equal, array for array, to
``repro.runtime.elastic.replan``'s on the same inputs; the ranked pod
step within 1e-4 per leaf of the reference's and three steps' loss and
gnorm within rtol 1e-4 (``tests/test_torch_pods.py``); ships byte for
byte against the stacked transport."""

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
from repro.masks import parse_mask as j_parse_mask
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.optimizer import adamw as jadamw
from repro.runtime import compression as jcomp
from repro.runtime import elastic as jelastic
from test_torch_threads import intra_op_share  # noqa: F401

LOSS_TOL, GNORM_TOL, LEAF_TOL = 1e-6, 1e-5, 1e-4


@pytest.fixture(scope="module")
def np_params():
    jcfg = dataclasses.replace(j_smoke(J.ARCH), param_dtype="float32")
    return jcfg, jax.device_get(JModel(jcfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def ranked(np_params, tmp_path_factory):
    d = tmp_path_factory.mktemp("supervisor_ranks")
    torch.save(np_params[1], d / "params.pt")
    return J.run(2, "supervisor", d, timeout=150,
                 params_path=str(d / "params.pt"), root=str(d / "drills"))


@pytest.fixture(scope="module")
def stacked(tmp_path_factory):
    return J.supervisor_drills(False, str(tmp_path_factory.mktemp("stk")))


def _same_history(got: list, want: list) -> None:
    """A rank's records against the stacked run's (the whole run, or the
    prefix an idle rank ran)."""
    assert [(r["step"], r["pods"], r["n_workers"]) for r in got] == [
        (r["step"], r["pods"], r["n_workers"]) for r in want[:len(got)]]
    for a, b in zip(got, want):
        assert abs(a["loss"] / b["loss"] - 1) <= LOSS_TOL
        assert abs(a["gnorm"] / b["gnorm"] - 1) <= GNORM_TOL


# --------------------------------------------------------------------------
# the rank layer: uneven shares, broadcast, subgroups
# --------------------------------------------------------------------------

def test_uneven_ships_broadcast_and_subgroup(ranked):
    x, g = J.ship_inputs()
    outs = [r["uneven"] for r in ranked]
    assert [o["frames"] for o in outs] == [(0, 1), (1, 3)]
    for p, perm in enumerate(J.UNEVEN_PERMS):
        for fmt in J.FORMATS:
            y, dx = J.ship_case(x[:3], g[:3], perm, fmt)
            assert np.concatenate([o["ships"][p, fmt][0] for o in outs]
                                  ).tobytes() == y.tobytes(), (perm, fmt)
            assert np.concatenate([o["ships"][p, fmt][1] for o in outs]
                                  ).tobytes() == dx.tobytes(), (perm, fmt)
    for o in outs:
        vals, sent, priced = o["broadcast"]
        assert np.all(vals[0] == 1.0) and np.array_equal(
            vals[1], np.arange(5, dtype=np.int32) * 2)
        assert sent == priced
    assert [o["broadcast"][1] for o in outs] == [0, 3 * 2 * 4 + 5 * 4]
    assert outs[0]["one"] is None and outs[1]["one"] == (1, 0, (1,), 2.5)


# --------------------------------------------------------------------------
# (a, b) worker loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,members", [("kill_w1", [0]),
                                          ("kill_w0", [1])])
def test_kill_drill_across_ranks(case, members, ranked, stacked):
    """R = D = 2: the lost worker's rank idles; losing worker 0 takes the
    checkpoint writer, so rank 1 writes the survivors' checkpoints and
    restores alone."""
    want = stacked[case]
    for rank, r in enumerate(ranked):
        res = r["drills"][case]
        assert res["members"] == members
        assert res["steps_lost"] <= J.SUP_EVERY
        assert res["replay_max_diff"] <= 1e-6
        assert res["recoveries"][0]["resume_step"] == \
            want["recoveries"][0]["resume_step"]
        assert res["frames"] == ((0, 1) if rank in members else None)
        _same_history(res["records"], want["records"])
        if rank in members:
            assert len(res["records"]) == len(want["records"])
            assert res["steps_compared"] == want["steps_compared"]
        else:
            assert res["records"][-1]["step"] == J.SUP_KILL["fail_step"] - 1
    # the survivor rank wrote the checkpoint of the step after the loss
    saved = ranked[members[0]]["drills"][case]["saved_steps"]
    assert J.SUP_KILL["fail_step"] in saved


def test_worker_loss_splits_survivors_unevenly(ranked, stacked):
    """R = 2, D = 4, worker 1 lost: both ranks still hold a survivor, and
    the three survivor frames split ``[0, 1)`` and ``[1, 3)``."""
    res = [r["drills"]["split"] for r in ranked]
    assert [x["members"] for x in res] == [[0, 1], [0, 1]]
    assert [x["frames"] for x in res] == [(0, 1), (1, 3)]
    assert all(x["recoveries"][0]["n_workers"] == 3 for x in res)
    for x in res:
        assert x["replay_max_diff"] <= 1e-6
        assert len(x["records"]) == len(stacked["split"]["records"])
        _same_history(x["records"], stacked["split"]["records"])


# --------------------------------------------------------------------------
# (c) the straggler path
# --------------------------------------------------------------------------

def test_straggler_events_agree_across_ranks(ranked, stacked):
    def events(res):
        return [(e["kind"], e["step"], tuple(e["workers"]),
                 None if e["speeds"] is None else tuple(e["speeds"]))
                for e in res["events"]]
    want = events(stacked["straggler"])
    assert want and want[0][0] == "demote"
    for r in ranked:
        res = r["drills"]["straggler"]
        assert events(res) == want
        assert res["demoted_at"] < (J.SUP_STRAGGLER["window"]
                                    + J.SUP_STRAGGLER["cooldown"])
        _same_history(res["records"], stacked["straggler"]["records"])
        # the fleet's wall is the slowest rank's
        assert all(x["ms"] >= x["rank_ms"] for x in res["records"])


# --------------------------------------------------------------------------
# (d) pod loss, overlapping recovery and the rejoin
# --------------------------------------------------------------------------

def test_pod_drill_rejoins_with_the_survivors_state(ranked, stacked):
    res = [r["drills"]["pod"] for r in ranked]
    want = stacked["pod"]
    # one pod a rank: pod 1's rank idles, then rejoins
    assert [x["recoveries"][0]["members"] for x in res] == [[0], [0]]
    assert [x["members"] for x in res] == [[0, 1], [0, 1]]
    assert res[0]["param_digest"] == res[1]["param_digest"]
    for rank, x in enumerate(res):
        assert x["steps_lost"] <= J.SUP_EVERY
        assert x["replay_max_diff"] <= 1e-6
        rj = x["rejoin"]
        assert rj["plan_misses_after"] == rj["plan_misses_before"]
        assert rj["compiles_after"] == rj["compiles_before"]
        assert rj["builds_after"] == rj["builds_before"]
        assert rj["broadcast_bytes"] == rj["broadcast_priced"]
        assert (rj["broadcast_bytes"] > 0) == (rank == 0)
        assert x["post_rejoin_steps"] == J.SUP_POD["total"] - \
            J.SUP_POD["rejoin_step"]
        got = x["records"]
        if rank == 1:                   # idle between the loss and rejoin
            want_recs = [r for r in want["records"]
                         if r["pods"] == J.POD_P]
            assert [r["step"] for r in got] == [r["step"] for r in want_recs]
            _same_history(got, want_recs)
        else:
            _same_history(got, want["records"])


def test_rejoin_after_the_survivors_evicted_the_fleet_program(ranked,
                                                             stacked):
    """A one-program step cache: the survivor rank's own program evicts
    the full fleet's, so at the rejoin it builds that program again while
    the idle rank's cache still holds it.  The ranks' caches differ and
    the run still meets at every collective: the same steps and losses
    as the stacked pod drill, one parameter digest."""
    res = [r["small_cache"] for r in ranked]
    rejoin, resume = J.SUP_POD["rejoin_step"], \
        stacked["pod"]["recoveries"][0]["resume_step"]
    assert res[0]["compiled_at"] == [0, resume, rejoin]
    assert res[1]["compiled_at"] == [0]
    assert res[0]["param_digest"] == res[1]["param_digest"]
    want = stacked["pod"]["records"]
    _same_history(res[0]["records"], want)
    assert len(res[0]["records"]) == len(want)
    _same_history(res[1]["records"], [r for r in want
                                      if r["pods"] == J.POD_P])


# --------------------------------------------------------------------------
# (e) survivor schedules against the reference's replan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["kill_w1", "kill_w0", "split", "pod"])
def test_survivor_schedules_match_reference_replan(case, ranked):
    cfg = J.smoke_cfg()
    nh, nkv = cfg.padded_heads(1)
    pcfg = J.sup_pcfg()
    jpcfg = JParallel(block_size=pcfg.block_size, coalesce=pcfg.coalesce,
                      in_dtype_bytes=pcfg.in_dtype_bytes,
                      comm_dtype=pcfg.comm_dtype, overlap=pcfg.overlap)
    base = J.POD_P if case == "pod" else 1
    seen = 0
    for r in ranked:
        for rec in r["drills"][case]["after"]:
            js = jelastic.replan(
                rec["seqlens"], rec["n"], pcfg.block_size, n_q_heads=nh,
                n_kv_heads=nkv, head_dim=cfg.head_dim,
                mask=j_parse_mask(J.SUP_MASK),
                speeds=(None if rec["speeds"] is None
                        else np.asarray(rec["speeds"])),
                pcfg=jpcfg, verify=None, pods=rec["pods"], base_pods=base)
            for f in dataclasses.fields(js.arrays):
                assert np.array_equal(rec["arrays"][f.name],
                                      np.asarray(getattr(js.arrays, f.name))
                                      ), f.name
            seen += 1
    assert seen >= 1


# --------------------------------------------------------------------------
# (f) the ranked pod step against the reference's
# --------------------------------------------------------------------------

def test_ranked_pod_step_matches_jax(np_params, ranked):
    jcfg, params = np_params
    P, N = J.POD_P, J.POD_N
    jb = JLoader(dist="real_world", n_frames=N,
                 tokens_per_worker=J.POD_TPW, vocab_size=jcfg.vocab_size,
                 pods=P, seed=0).next()
    jmodel, mesh = JModel(jcfg), make_mesh((1, 1), ("data", "model"))
    jbatch = JT.batch_arrays(jb, jcfg)
    seg = jnp.asarray(jb.seg_ids)
    # the dense oracle per pod: segment ids restart in every pod
    pod_attn = [j_dense_attn(seg[p * N:(p + 1) * N],
                             jbatch["positions"][p * N:(p + 1) * N])
                for p in range(P)]

    def jattn(q, k, v):
        return jnp.concatenate([
            a(q[p * N:(p + 1) * N], k[p * N:(p + 1) * N],
              v[p * N:(p + 1) * N]) for p, a in enumerate(pod_attn)])

    jparams = jax.tree.map(jnp.asarray, params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, jattn)))(jparams)
    jres = jcomp.init_residuals(jparams)
    jstep = JT.jit_train_step(
        JT.build_train_step(jmodel, mesh, JParallel(remat=False),
                            JTrain(**J.POD_TCFG), jattn),
        mesh, jparams, jadamw.init(jparams), jres, jbatch)
    p_, o_, r_, jlog = jparams, jadamw.init(jparams), jres, []
    for _ in range(3):
        p_, o_, r_, loss, gnorm = jstep(p_, o_, r_, jbatch)
        jlog.append((float(loss), float(gnorm)))
    jflat = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(jgrads))]
    assert [r["pod_step"]["frames"] for r in ranked] == [(0, 2), (2, 4)]
    for r in ranked:
        got = r["pod_step"]
        assert abs(got["loss"] / float(jloss) - 1) <= LEAF_TOL
        assert len(got["grads"]) == len(jflat)
        for a, b in zip(got["grads"], jflat):
            assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-30) \
                <= LEAF_TOL
        np.testing.assert_allclose(got["log"], jlog, rtol=LEAF_TOL)


# --------------------------------------------------------------------------
# the CLI's default loop
# --------------------------------------------------------------------------

def test_cli_default_is_the_ranked_supervisor(ranked):
    """Under torchrun's environment the train CLI runs the Supervisor on
    ``2x1`` and, pods across the ranks, ``2x2x1``: both ranks log the
    stacked Supervisor's steps."""
    want = J.cli_runs()
    for mesh, fleet in (("2x1", (1, 2)), ("2x2x1", (2, 2))):
        assert want[mesh]["type"] == "Supervisor"
        for rank, r in enumerate(ranked):
            got = r["cli"][mesh]
            assert got["type"] == "Supervisor" and got["fleet"] == fleet
            assert got["members"] == (0, 1) and got["records"] == 2
            n = fleet[0] * fleet[1] // 2
            assert got["frames"] == [rank * n, (rank + 1) * n]
            np.testing.assert_allclose(got["log"], want[mesh]["log"],
                                       rtol=1e-5)
