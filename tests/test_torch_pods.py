"""Pod meshes in the port on stacked CPU workers: P pods x n workers
stacked pod-major on the leading frame dim, every pod running the same
n-worker FCP plan on its own frames.

* ``fcp_attention`` (both impl groupings, serial and overlap, stream and
  sched layout) and ``fcp_reshuffle`` over 2 pods x 2 workers against
  each pod's one-pod result: the forward bitwise, the gradients within
  ``DKDV_TOL`` (1e-6 normalized, the overlap executor's bound);
* the 2x2x1 train step with error-feedback compression against the
  reference's ``build_train_step`` on a 1x1 mesh over the same batch
  arrays, its attention the reference's dense oracle applied per pod
  (segment ids restart in every pod, so one oracle over all frames would
  let pod 1's document 0 attend to pod 0's): step-0 loss and gradients
  1e-4 per leaf normalized (``TOL_GRAD``), three steps' loss and gnorm
  1e-4 relative;
* the pod drill (``launch/drills.pod_drill``) at the geometry of the
  reference's ``tests/multidevice/run_fault_drill.py`` and held to its
  limits, and a worker loss on a 2-pod fleet (the worker's slot leaves
  both pods) through the kill drill;
* the CLI: ``--mesh 2x2x1`` through the Supervisor and the plain loop,
  their losses equal, and the 2-pod step's loss the mean of the two
  one-pod steps' losses on the same frames (1e-6 relative);
* the serving loop's prefill dispatch (FCP or the dense escape hatch)
  on 1- and 2-axis meshes and a pod mesh against the reference's
  (``tests/test_torch_serving.py`` serves on them)."""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import smoke_config as j_smoke
from repro.data import SyntheticLoader as JLoader
from repro.launch import train as JT
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.optimizer import adamw as jadamw
from repro.runtime import compression as jcomp
from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                      TrainConfig, smoke_config)
from repro_torch.core import executor as ex
from repro_torch.core.schedule import make_schedule
from repro_torch.data import SyntheticLoader
from repro_torch.launch import drills
from repro_torch.launch import train as T
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw
from repro_torch.runtime import compression
from repro_torch.runtime.serving import ServingLoop
from test_torch_threads import intra_op_share  # noqa: F401

P, N, TPW, BS, H, KH, D = 2, 2, 64, 16, 4, 2, 32
SEQLENS = [40, 30, 26, 20, 12]                # one pod's 128 tokens
DKDV_TOL = 1e-6
TOL_GRAD = 1e-4
# the reference runner's pod drill geometry
P0, POD_WORKERS, POD_TPW, POD_BS = 2, 2, 256, 128
CKPT_EVERY, TOTAL = 2, 12
POD_FAIL_STEP, POD_REJOIN = 5, 9


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _sched(overlap):
    return make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                         head_dim=D, mask="causal", coalesce=4, wire="f32",
                         overlap=overlap, verify=True)


def _attn(sched, pods, qkv, cot, impl, layout):
    xs = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    o = ex.fcp_attention(*xs, ex.schedule_tables(sched, "cpu", pods),
                         spec=sched.spec, cfg=ex.ExecConfig(impl=impl),
                         layout=layout)
    g = torch.autograd.grad((o * torch.from_numpy(cot)).sum(), xs)
    return o.detach(), g


@pytest.mark.parametrize("layout", ["stream", "sched"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("impl", ["fused_xla", "xla"])
def test_pod_attention_equals_each_pods_own(impl, overlap, layout):
    sched = _sched(overlap)
    assert sched.spec.n_rounds > 0 and sched.spec.n_resh_rounds > 0
    rng = np.random.default_rng(0)
    qkv = [rng.normal(size=(P * N, TPW, h, D)).astype(np.float32)
           for h in (H, KH, KH)]
    cot = rng.normal(size=(P * N, TPW, H, D)).astype(np.float32)
    o, g = _attn(sched, P, qkv, cot, impl, layout)
    for p in range(P):
        f = slice(p * N, (p + 1) * N)
        o1, g1 = _attn(sched, 1, [x[f] for x in qkv], cot[f], impl, layout)
        assert torch.equal(o[f], o1)
        for a, b in zip(g, g1):
            assert _nerr(a[f], b) <= DKDV_TOL
    with pytest.raises(ValueError, match="2 pod"):
        ex.fcp_attention(*(torch.from_numpy(x[:N]) for x in qkv),
                         ex.schedule_tables(sched, "cpu", P),
                         spec=sched.spec)


@pytest.mark.parametrize("reverse", [False, True])
def test_pod_reshuffle_equals_each_pods_own(reverse):
    sched = _sched(False)
    tabs = ex.schedule_tables(sched, "cpu", P)
    assert tabs is ex.schedule_tables(sched, "cpu", P)        # memoized
    rng = np.random.default_rng(1)
    x = rng.normal(size=(P * N, TPW, 7)).astype(np.float32)
    cot = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def move(xa, pods, c):
        xt = torch.from_numpy(xa).requires_grad_(True)
        y = ex.fcp_reshuffle(xt, ex.schedule_tables(sched, "cpu", pods),
                             spec=sched.spec, reverse=reverse)
        return y.detach(), torch.autograd.grad((y * c).sum(), xt)[0]

    y, g = move(x, P, cot)
    for p in range(P):
        f = slice(p * N, (p + 1) * N)
        y1, g1 = move(x[f], 1, cot[f])
        assert torch.equal(y[f], y1)
        assert _nerr(g[f], g1) <= DKDV_TOL


# --------------------------------------------------------------------------
# the 2x2x1 train step against the reference's
# --------------------------------------------------------------------------

def test_pod_train_step_matches_jax():
    jcfg = dataclasses.replace(j_smoke("stablelm_1_6b"),
                               param_dtype="float32")
    cfg = dataclasses.replace(smoke_config("stablelm_1_6b"),
                              param_dtype="float32")
    np_params = jax.device_get(JModel(jcfg).init(jax.random.key(0)))
    tpw, bs = 128, 32
    kw = dict(dist="real_world", n_frames=N, tokens_per_worker=tpw,
              vocab_size=cfg.vocab_size, pods=P, seed=0)
    b, jb = SyntheticLoader(**kw).next(), JLoader(**kw).next()
    assert np.array_equal(b.tokens, jb.tokens) and b.tokens.shape[0] == P * N
    tcfg = dict(lr=1e-3, warmup_steps=1, total_steps=3,
                grad_compression=True)

    # reference: the dense oracle per pod, one jitted step on a 1x1 mesh
    jmodel, mesh = JModel(jcfg), make_mesh((1, 1), ("data", "model"))
    jbatch = JT.batch_arrays(jb, jcfg)
    seg = jnp.asarray(jb.seg_ids)
    pod_attn = [j_dense_attn(seg[p * N:(p + 1) * N],
                             jbatch["positions"][p * N:(p + 1) * N])
                for p in range(P)]

    def jattn(q, k, v):
        return jnp.concatenate([
            a(q[p * N:(p + 1) * N], k[p * N:(p + 1) * N],
              v[p * N:(p + 1) * N]) for p, a in enumerate(pod_attn)])

    jparams = jax.tree.map(jnp.asarray, np_params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, jattn)))(jparams)
    jres = jcomp.init_residuals(jparams)
    jstep = JT.jit_train_step(
        JT.build_train_step(jmodel, mesh, JParallel(remat=False),
                            JTrain(**tcfg), jattn),
        mesh, jparams, jadamw.init(jparams), jres, jbatch)
    p_, o_, r_, jlog = jparams, jadamw.init(jparams), jres, []
    for _ in range(3):
        p_, o_, r_, loss, gnorm = jstep(p_, o_, r_, jbatch)
        jlog.append((float(loss), float(gnorm)))

    # port: FCP over 2 pods x 2 stacked workers
    pcfg = ParallelConfig(block_size=bs)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, tpw)
    assert sched.spec.n_rounds > 0
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla", P)
    model, params = Model(cfg), params_from_numpy(np_params, "cpu")
    batch = T.batch_arrays(b, cfg, "cpu")
    loss, grads = T.value_and_grad(model, pcfg, attn)(params, batch)
    assert abs(float(loss) / float(jloss) - 1) <= TOL_GRAD
    jflat = jax.tree.leaves(jax.device_get(jgrads))
    tflat = adamw.tree_leaves(grads)
    assert len(jflat) == len(tflat)
    for a, b_ in zip(tflat, jflat):
        b_ = np.asarray(b_)
        err = np.abs(a.numpy() - b_).max() / max(np.abs(b_).max(), 1e-30)
        assert err <= TOL_GRAD, err
    step = T.build_train_step(model, StackedMesh((P, N, 1)), pcfg,
                              TrainConfig(**tcfg), attn)
    opt, res, log = adamw.init(params), compression.init_residuals(params), []
    for _ in range(3):
        params, opt, res, loss, gnorm = step(params, opt, res, batch)
        log.append((float(loss), float(gnorm)))
    np.testing.assert_allclose(log, jlog, rtol=TOL_GRAD)


# --------------------------------------------------------------------------
# the Supervisor on pods
# --------------------------------------------------------------------------

def _pod_factory(**pkw):
    cfg = dataclasses.replace(smoke_config("stablelm_1_6b"),
                              param_dtype="float32")
    pcfg = ParallelConfig(block_size=POD_BS, remat=False, coalesce=4,
                          in_dtype_bytes=4.0, checkpoint_every=CKPT_EVERY,
                          **pkw)

    def make(ckpt_dir, **kw):
        tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=TOTAL,
                           grad_compression=True)
        return T.Supervisor(cfg, pcfg, tcfg, n_workers=POD_WORKERS,
                            tokens_per_worker=POD_TPW, pods=P0,
                            dist="real_world", checkpoint_dir=ckpt_dir,
                            verbose=False, device="cpu",
                            attn_impl="fused_xla", **kw)
    return make


def test_pod_drill(tmp_path):
    out = drills.pod_drill(_pod_factory(), tmp_path, total=TOTAL,
                           fail_step=POD_FAIL_STEP, fail_round=1,
                           rejoin_step=POD_REJOIN, every=CKPT_EVERY)
    assert out["steps_lost"] <= CKPT_EVERY
    assert out["post_rejoin_steps"] == TOTAL - POD_REJOIN
    assert out["steps_compared"] == TOTAL - out["resume_step"]
    assert [f for f in out["fleet_steps"] if f[0] >= POD_REJOIN] == [
        (s, P0, POD_WORKERS) for s in range(POD_REJOIN, TOTAL)]


def test_multi_pod_worker_loss_leaves_every_pod(tmp_path):
    out = drills.kill_drill(_pod_factory(), tmp_path, total=8,
                            fail_step=POD_FAIL_STEP, fail_worker=1,
                            fail_round=2, every=CKPT_EVERY)
    assert out["n_workers"] == POD_WORKERS - 1
    assert out["steps_compared"] == 8 - out["resume_step"]


# --------------------------------------------------------------------------
# the CLI and the pod layout
# --------------------------------------------------------------------------

ARGV = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "2x2x1",
        "--dist", "real_world", "--block-size", "32",
        "--tokens-per-worker", "128", "--steps", "2", "--device", "cpu"]


def test_cli_pod_mesh_runs_both_loops():
    sup = T.main(ARGV)
    assert isinstance(sup, T.Supervisor)
    assert sup.summary()["pods"] == 2 and sup.summary()["n_workers"] == 2
    plain = T.main(ARGV + ["--no-supervised"])
    assert isinstance(plain, T.Trainer) and plain.pods == 2
    for tr in (sup, plain):
        assert [(r.pods, r.n_workers) for r in tr.history] == [(2, 2)] * 2
        assert all(np.isfinite(r.loss) and r.loss > 0 for r in tr.history)
    np.testing.assert_allclose([r.loss for r in sup.history],
                               [r.loss for r in plain.history], rtol=1e-5)


def test_pod_loss_is_the_mean_of_the_pods_losses():
    """The layout check of the card's pod step: the 2-pod loss against
    two one-pod steps on the same frames (each pod holds the same
    composition, so the same token count)."""
    tr = T.trainer_from_args(T.parse_args(
        ARGV + ["--no-supervised", "--override", "param_dtype=float32"]))
    try:
        b = tr.loader.next()
        batch = T.batch_arrays(b, tr.cfg, "cpu")
        sched = T.build_schedule(tr.cfg, tr.pcfg, b.seqlens, tr.n_cp, tr.tpw)
        with torch.no_grad():
            pod_loss = float(tr.model.loss(tr.state.params, batch,
                                           T.make_fcp_attn_fn(
                                               sched, "cpu", tr.pcfg,
                                               "fused_xla", tr.pods)))
            one = T.make_fcp_attn_fn(sched, "cpu", tr.pcfg, "fused_xla")
            each = [float(tr.model.loss(
                tr.state.params,
                {k: v[p * tr.n_cp:(p + 1) * tr.n_cp]
                 for k, v in batch.items()}, one)) for p in range(tr.pods)]
    finally:
        tr.close()
    assert abs(pod_loss / np.mean(each) - 1) <= 1e-6


# --------------------------------------------------------------------------
# serving: the prefill dispatch
# --------------------------------------------------------------------------

# the reference's dispatch, per (arch, mesh, prefill_impl): its loop
# built on 8 CPU devices in a subprocess (the suite's JAX has one)
DISPATCH = [(a, m, i) for a in ("stablelm_1_6b", "mamba2_130m")
            for m in ((1, 1), (1, 2), (2, 1), (2, 2), (2, 2, 2))
            for i in ("fcp", "dense")]
_DISPATCH_SRC = """
import json, sys, warnings
import jax
from repro.configs.base import ParallelConfig, ServeConfig, smoke_config
from repro.launch.mesh import make_mesh
from repro.models import Model
from repro.runtime.serving import ServingLoop
warnings.simplefilter("ignore")
out, models = [], {}
for arch, mesh, impl in json.loads(sys.argv[1]):
    if arch not in models:
        m = Model(smoke_config(arch))
        models[arch] = (m, m.init(jax.random.key(0)))
    axes = ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")
    loop = ServingLoop(*models[arch], make_mesh(tuple(mesh), axes),
                       ParallelConfig(block_size=16),
                       ServeConfig(cache_len=64, decode_slots=2,
                                   max_new_tokens=4,
                                   prefill_tokens_per_worker=32,
                                   bucket_min=16, prefill_impl=impl))
    out.append(loop.report(1.0)["prefill_impl"])
print(json.dumps(out))
"""


def test_prefill_impl_matches_the_reference():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src")
    res = subprocess.run([sys.executable, "-c", _DISPATCH_SRC,
                          json.dumps(DISPATCH)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = []
    for arch, mesh, impl in DISPATCH:
        cfg = smoke_config(arch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loop = ServingLoop(
                Model(cfg), None, StackedMesh(mesh),
                ParallelConfig(block_size=16),
                ServeConfig(cache_len=64, decode_slots=2, max_new_tokens=4,
                            prefill_tokens_per_worker=32, bucket_min=16,
                            prefill_impl=impl), device="cpu")
        got.append(loop.report(1.0)["prefill_impl"])
    assert got == want
    assert "fcp" in got and "dense" in got
