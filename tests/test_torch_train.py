"""The port's training slice on the CPU (plain kernel versions) against the
reference: the executor's gradients against ``jax.grad`` of the dense
oracle, the wire's backward, the train step against the JAX train step
on the same weights and batch, and the optimizer, schedule, compression
and loss pieces against theirs.

Tolerances: executor gradients 1e-5 normalized (the forward's bound in
``test_torch_executor.py``: summation order across two frameworks);
quantized wires 1e-2 / 3e-2 of the f32 wire's gradients (the forward's
bounds); the train step's step-0 gradients 1e-4 per leaf, normalized by
the leaf's largest entry, and its losses and gradient norms 1e-4
relative (two frameworks' summation orders through two layers and a
cross entropy; parameters are not compared elementwise, since Adam's
first step is a sign of the gradient and near-zero entries flip it);
optimizer, schedule, compression and losses 1e-6."""

import dataclasses
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
from repro.kernels import ref as jref
from repro.launch import train as JT
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.models import layers as jlayers
from repro.optimizer import adamw as jadamw
from repro.optimizer import schedules as jsched
from repro.runtime import compression as jcomp
from repro_torch.configs.base import ParallelConfig, TrainConfig, smoke_config
from repro_torch.core import executor as ex
from repro_torch.core.schedule import make_schedule
from repro_torch.data import SyntheticLoader
from repro_torch.launch import train as T
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw, schedules
from repro_torch.runtime import compression
from repro_torch.runtime import wire as twire
from test_torch_threads import intra_op_share  # noqa: F401


N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
SEQLENS = [90, 50, 40, 30, 26, 20]           # mixed docs over 256 tokens


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


# --------------------------------------------------------------------------
# executor backward
# --------------------------------------------------------------------------

def _fcp_grads(mask, wire, coalesce, impl, seed=0):
    sched = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                          head_dim=D, mask=mask, coalesce=coalesce,
                          wire=wire, verify=True)
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(N * TPW, h, D)).astype(np.float32)
           for h in (H, KH, KH)]
    cot = rng.normal(size=(N * TPW, H, D)).astype(np.float32)
    xs = [torch.from_numpy(x).reshape(N, TPW, -1, D).requires_grad_(True)
          for x in qkv]
    o = ex.fcp_attention(*xs, ex.schedule_tables(sched, "cpu"),
                         spec=sched.spec, cfg=ex.ExecConfig(impl=impl))
    g = torch.autograd.grad((o.reshape(N * TPW, H, D)
                             * torch.from_numpy(cot)).sum(), xs)
    return sched, qkv, cot, [x.reshape(N * TPW, -1, D).numpy() for x in g]


@pytest.mark.parametrize("impl", ["fused_xla", "xla"])
@pytest.mark.parametrize("coalesce", [1, 16])
@pytest.mark.parametrize("mask", ["causal", "swa:24"])
def test_fcp_backward_matches_dense_oracle(mask, coalesce, impl):
    sched, qkv, cot, grads = _fcp_grads(mask, "f32", coalesce, impl)
    assert sched.spec.n_rounds > 0 and sched.spec.n_resh_rounds > 0
    seg = jnp.asarray(sched.batch.seg_ids)
    pos = jnp.asarray(sched.batch.positions)

    def loss(q, k, v):
        o, _ = jref.reference_attention(
            q.transpose(1, 0, 2), k.transpose(1, 0, 2),
            v.transpose(1, 0, 2), seg, pos, seg, pos, mask)
        return jnp.sum(o.transpose(1, 0, 2) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    for a, b in zip(grads, ref):
        assert _nerr(a, b) <= 1e-5


@pytest.mark.parametrize("wire,tol", [("bf16", 1e-2), ("int8", 3e-2)])
def test_quantized_wire_backward_near_f32(wire, tol):
    *_, g32 = _fcp_grads("causal", "f32", 4, "fused_xla", seed=1)
    *_, gq = _fcp_grads("causal", wire, 4, "fused_xla", seed=1)
    errs = [_nerr(a, b) for a, b in zip(gq, g32)]
    assert max(errs) <= tol and max(errs) > 0, errs


@pytest.mark.parametrize("impl", ["fused_xla", "xla"])
def test_inplace_and_out_of_place_writes_same_bytes(impl):
    """Inference writes in place, autograd out of place: same output."""
    sched = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                          head_dim=D, coalesce=4)
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.normal(size=(N, TPW, h, D)).astype(
        np.float32)) for h in (H, KH, KH)]
    tabs = ex.schedule_tables(sched, "cpu")
    cfg = ex.ExecConfig(impl=impl)
    with torch.no_grad():
        o_in = ex.fcp_attention(*xs, tabs, spec=sched.spec, cfg=cfg)
    o_out = ex.fcp_attention(*(x.clone().requires_grad_(True) for x in xs),
                             tabs, spec=sched.spec, cfg=cfg)
    assert o_out.requires_grad
    assert torch.equal(o_in, o_out.detach())


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_ship_backward_reverses_the_permutation(kind):
    fmt = twire.parse_wire(kind)
    perm = ((0, 2), (2, 1), (3, 0))
    x = torch.randn(4, 2, 3, 8, 4, requires_grad=True)
    g = torch.randn(4, 2, 3, 8, 4)
    (gx,) = torch.autograd.grad(twire.ship(x, perm, fmt), x, g)
    rev = tuple((d, s) for s, d in perm)
    assert torch.equal(gx, twire.ship(g, rev, fmt))
    if kind == "f32":                  # exact: an index copy of g
        assert torch.equal(gx[0], g[2]) and torch.equal(gx[2], g[1])
        assert torch.equal(gx[3], g[0]) and not gx[1].any()


# --------------------------------------------------------------------------
# train step against the JAX train step
# --------------------------------------------------------------------------

# a model, or a model and the executor variant of its step: the double-
# buffered round loop (overlap) or the layer-pipelined reshuffle
STEP_CASES = ["stablelm_1_6b", "granite_moe_3b_a800m", "zamba2_2_7b",
              "stablelm_1_6b:overlap", "granite_moe_3b_a800m:overlap",
              "stablelm_1_6b:layer_pipeline"]


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's step-0 loss and gradients and its three steps'
    (loss, gnorm), per model (the variants share them)."""
    return {}


@pytest.fixture(scope="module", params=STEP_CASES)
def smoke(request):
    arch, _, variant = request.param.partition(":")
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    jparams = jax.device_get(JModel(jcfg).init(jax.random.key(0)))
    return jcfg, cfg, jparams, variant


def test_train_step_matches_jax(smoke, jax_steps):
    """FCP over 4 stacked workers (``fused_xla``, remat on) against the
    reference's jitted train step with dense attention on a 1x1 mesh:
    same f32 smoke weights, same loader batch, three steps; a dense, an
    MoE (the batch's 4 frames are the MoE's routing frames in both
    packages) and a hybrid model (zamba2: every shared-block invocation
    through the one FCP closure); the dense and MoE steps also with the
    double-buffered round loop, the dense one with the layer pipeline."""
    jcfg, cfg, np_params, variant = smoke
    tpw, bs = 128, 32
    kw = dict(dist="real_world", n_frames=N, tokens_per_worker=tpw,
              vocab_size=cfg.vocab_size, seed=0)
    b, jb = SyntheticLoader(**kw).next(), JLoader(**kw).next()
    assert np.array_equal(b.tokens, jb.tokens)
    tcfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)

    if cfg.name not in jax_steps:
        # reference: step-0 gradients, then three jitted steps
        jparams = jax.tree.map(jnp.asarray, np_params)   # the step donates
        jmodel, mesh = JModel(jcfg), make_mesh((1, 1), ("data", "model"))
        jbatch = JT.batch_arrays(jb, jcfg)
        jattn = j_dense_attn(jnp.asarray(jb.seg_ids), jbatch["positions"])
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss(p, jbatch, jattn)))(jparams)
        jgrads = jax.device_get(jgrads)
        jstep = JT.jit_train_step(
            JT.build_train_step(jmodel, mesh, JParallel(remat=False),
                                JTrain(**tcfg), jattn),
            mesh, jparams, jadamw.init(jparams), None, jbatch)
        p, o, jlog = jparams, jadamw.init(jparams), []
        for _ in range(3):
            p, o, _, loss, gnorm = jstep(p, o, None, jbatch)
            jlog.append((float(loss), float(gnorm)))
        jax_steps[cfg.name] = (jloss, jgrads, jlog)
    jloss, jgrads, jlog = jax_steps[cfg.name]

    # port
    pcfg = ParallelConfig(block_size=bs, attention_impl="fused_xla",
                          overlap=variant == "overlap",
                          layer_pipeline=variant == "layer_pipeline")
    model = Model(cfg)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, tpw)
    assert sched.spec.n_rounds > 0 and sched.spec.overlap == pcfg.overlap
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla")
    if variant == "layer_pipeline":
        assert isinstance(attn[0], T.PipelinedAttn)
    params = params_from_numpy(np_params, "cpu")
    batch = T.batch_arrays(b, cfg, "cpu")
    loss, grads = T.value_and_grad(model, pcfg, attn)(params, batch)
    assert abs(float(loss) / float(jloss) - 1) <= 1e-4
    jflat = jax.tree.leaves(jgrads)
    tflat = adamw.tree_leaves(grads)
    assert len(jflat) == len(tflat)
    for a, b_ in zip(tflat, jflat):
        b_ = np.asarray(b_)
        err = np.abs(a.numpy() - b_).max() / max(np.abs(b_).max(), 1e-30)
        assert err <= 1e-4, err
    step = T.build_train_step(model, None, pcfg, TrainConfig(**tcfg), attn)
    opt, log = adamw.init(params), []
    for _ in range(3):
        params, opt, _, loss, gnorm = step(params, opt, None, batch)
        log.append((float(loss), float(gnorm)))
    np.testing.assert_allclose(log, jlog, rtol=1e-4)


# --------------------------------------------------------------------------
# optimizer, schedule, compression, losses
# --------------------------------------------------------------------------

def _tree(rng):
    return {"b": rng.normal(size=(3, 4)).astype(np.float32),
            "a": {"w": rng.normal(size=(5,)).astype(np.float32),
                  "v": rng.normal(size=(2, 2)).astype(np.float32)}}


def test_adamw_schedule_compression_match_reference():
    rng = np.random.default_rng(9)
    p, g = _tree(rng), _tree(rng)
    for k in ("b",):
        g[k] *= 3.0                     # a global norm above the clip
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    tp = params_from_numpy(p, "cpu")
    tg = params_from_numpy(g, "cpu")
    for step in (0, 1, 5, 50, 200):
        a = float(jsched.warmup_cosine(step, peak_lr=3e-4, warmup_steps=10,
                                       total_steps=100))
        b = float(schedules.warmup_cosine(torch.tensor(step), peak_lr=3e-4,
                                          warmup_steps=10, total_steps=100))
        assert abs(a - b) <= 1e-6 * max(abs(a), 1e-30)
    jst = jadamw.init(jp)
    jst = jadamw.AdamWState(jst.step + 2, jax.tree.map(lambda x: x + 0.1,
                                                       jst.m), jst.v)
    jp2, jst2, jn = jadamw.update(jp, jg, jst, lr=1e-2)
    st = adamw.init(tp)
    st.step += 2
    st.m = adamw.tree_map(lambda x: x + 0.1, st.m)
    tp2, st2, tn = adamw.update(tp, tg, st, lr=torch.tensor(1e-2))
    assert abs(float(tn) / float(jn) - 1) <= 1e-6
    for a, b in zip(adamw.tree_leaves(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(adamw.tree_leaves(st2.v), jax.tree.leaves(jst2.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-12)
    assert int(st2.step) == int(jst2.step) == 3
    # error-feedback compression: bf16 payloads and residuals
    res = _tree(rng)
    jc, jr = jcomp.compress_grads(jg, jax.tree.map(jnp.asarray, res))
    tc, tr = compression.compress_grads(tg, params_from_numpy(res, "cpu"))
    for a, b in zip(adamw.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for a, b in zip(adamw.tree_leaves(tr), jax.tree.leaves(jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    with pytest.raises(ValueError, match="scale-free"):
        compression.compress_grads(tg, tr, twire.WIRE_INT8)


def test_adamw_large_leaves_in_blocks_same_bytes(monkeypatch):
    """A leaf above ``adamw.BLOCK`` elements is updated in blocks of its
    leading dim with the same arithmetic: the same bytes as one pass."""
    rng = np.random.default_rng(10)
    tree = {"w": rng.normal(size=(6, 5, 4)), "b": rng.normal(size=(3, 7)),
            "s": rng.normal(size=(40,))}
    outs = []
    for block in (adamw.BLOCK, 16):
        monkeypatch.setattr(adamw, "BLOCK", block)
        p = params_from_numpy(tree, "cpu", torch.float32)
        g = params_from_numpy({k: v * 2 for k, v in tree.items()}, "cpu",
                              torch.float32)
        st = adamw.init(p)
        for _ in range(2):
            p, st, _ = adamw.update(p, g, st, lr=torch.tensor(1e-2))
        outs.append(adamw.tree_leaves(p) + adamw.tree_leaves(st.m)
                    + adamw.tree_leaves(st.v))
    assert len(adamw._blocks(torch.zeros(6, 5, 4))) == 6    # BLOCK = 16
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_matches_full():
    rng = np.random.default_rng(4)
    F_, T_, d, V, vocab = 2, 40, 16, 48, 44      # vocab-padded head
    x = rng.normal(size=(F_, T_, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    lab = rng.integers(0, vocab, (F_, T_)).astype(np.int32)
    msk = (rng.random((F_, T_)) > 0.2).astype(np.float32)
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    full = layers.cross_entropy(xt @ wt, torch.from_numpy(lab),
                                torch.from_numpy(msk), vocab)
    g_full = torch.autograd.grad(full, (xt, wt))
    chunked = layers.chunked_cross_entropy(
        xt, lambda h: h @ wt, torch.from_numpy(lab), torch.from_numpy(msk),
        vocab, chunk=16)                         # 80 tokens: a ragged tail
    g_chunk = torch.autograd.grad(chunked, (xt, wt))
    assert abs(chunked.item() - full.item()) <= 1e-6
    for a, b in zip(g_chunk, g_full):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    ref = jlayers.cross_entropy(jnp.asarray(x) @ jnp.asarray(w),
                                jnp.asarray(lab), jnp.asarray(msk), vocab)
    assert abs(full.item() - float(ref)) <= 1e-6


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_rehearsal_on_cpu(tmp_path):
    """The reference's routing: a 4x1 FCP run goes through the
    Supervisor by default, ``--no-supervised`` through the plain loop;
    ``--supervised``, ``--layer-pipeline``, ``--overlap`` and
    ``--checkpoint-dir`` run; a pod mesh goes to the Supervisor with its
    pods."""
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1",
            "--dist", "real_world", "--block-size", "32",
            "--tokens-per-worker", "128", "--steps", "2", "--device", "cpu"]
    plain = T.main(argv + ["--no-supervised"])
    assert isinstance(plain, T.Trainer)
    losses = [r.loss for r in plain.history]
    for flags in ([], ["--supervised"], ["--layer-pipeline"], ["--overlap"],
                  ["--checkpoint-dir", str(tmp_path / "ck"),
                   "--checkpoint-every", "1"]):
        trainer = T.main(argv + flags)
        assert isinstance(trainer, T.Supervisor)
        assert len(trainer.history) == 2
        assert all(np.isfinite(r.loss) and r.loss > 0
                   for r in trainer.history)
        assert trainer.plan_cache.stats.misses >= 1
        np.testing.assert_allclose([r.loss for r in trainer.history],
                                   losses, rtol=1e-5)
    assert (tmp_path / "ck" / "step_1" / "COMMIT").exists()
    pod = T.trainer_from_args(T.parse_args(argv[:4] + ["2x4x1", "--device",
                                                       "cpu"]))
    assert isinstance(pod, T.Supervisor) and (pod.p0, pod.n0) == (2, 4)
    assert pod.loader.pods == 2
    pod.close()


def test_default_training_attention_is_the_kernels(monkeypatch):
    # the copied ParallelConfig keeps the reference's "xla" default; the
    # port's closure and Trainer do not read it and default to "fused"
    assert ParallelConfig().attention_impl == "xla"
    seen = []
    real = ex.fcp_attention

    def spy(*a, cfg, **kw):
        seen.append(cfg.impl)
        return real(*a, cfg=cfg, **kw)
    monkeypatch.setattr(ex, "fcp_attention", spy)
    cfg = smoke_config("stablelm_1_6b")
    trainer = T.Trainer(cfg, ParallelConfig(block_size=32),
                        TrainConfig(total_steps=1),
                        T.StackedMesh((N, 1), ("data", "model")),
                        tokens_per_worker=128, dist="real_world",
                        device="cpu")
    try:
        assert trainer.attn_impl == "fused"
        trainer.step()
    finally:
        trainer.close()
    assert seen and set(seen) == {"fused"}


def test_parity_only_flags_warn_when_set():
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1",
            "--block-size", "32", "--tokens-per-worker", "128",
            "--device", "cpu"]
    for flag in (["--attn-block-q", "128"], ["--attn-interpret"],
                 ["--shape", "s"]):
        with pytest.warns(UserWarning, match=flag[0]):
            T.trainer_from_args(T.parse_args(argv + flag)).close()
    # the checkpoint cadence and the Supervisor's knobs take effect now
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sup = T.trainer_from_args(T.parse_args(
            argv + ["--checkpoint-every", "3", "--step-timeout", "5"]))
        sup.close()
    assert sup.pcfg.checkpoint_every == 3
    assert sup.monitor.step_timeout == 5.0
