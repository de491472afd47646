"""The double-buffered round loop (``spec.overlap``) and the
layer-pipelined reshuffle (``layout="sched"``, ``fcp_reshuffle``) of the
port's executor on stacked CPU workers, against the reference's dense
oracle and against the serial executor, then through the serving loop
and the train CLI's layer pipeline.

Tolerances are ``tests/multidevice/run_overlap_executor.py``'s: overlap
on against off bitwise in the forward and dq, dk/dv within 1e-6
normalized (the backward scatter-add order differs: overlap's send
gathers read the frozen snapshot, serial's the commit chain); the
reshuffle round trip and the sched layout between two explicit
reshuffles bitwise.  Against the dense oracle 1e-5 normalized, as in
``tests/test_torch_executor.py`` (summation order across two
frameworks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.runtime.serving import ServingLoop as JLoop
from repro_torch.configs.base import ParallelConfig, ServeConfig, smoke_config
from repro_torch.core import executor as ex
from repro_torch.core.schedule import make_schedule
from repro_torch.data import SyntheticLoader
from repro_torch.launch import train as T
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw
from repro_torch.runtime.serving import ServingLoop
from test_torch_threads import intra_op_share  # noqa: F401


N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
SEQLENS = [90, 50, 40, 30, 26, 20]           # mixed docs over 256 tokens
ORACLE_TOL = 1e-5
DKDV_TOL = 1e-6


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _sched(mask, coalesce, overlap):
    return make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                         head_dim=D, mask=mask, coalesce=coalesce,
                         wire="f32", overlap=overlap, verify=True)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(N * TPW, h, D)).astype(np.float32)
           for h in (H, KH, KH)]
    cot = rng.normal(size=(N * TPW, H, D)).astype(np.float32)
    return qkv, cot


def _fcp(sched, qkv, cot, impl):
    """o and (dq, dk, dv) of ``sum(o * cot)`` on stacked workers."""
    xs = [torch.from_numpy(x).reshape(N, TPW, -1, D).requires_grad_(True)
          for x in qkv]
    o = ex.fcp_attention(*xs, ex.schedule_tables(sched, "cpu"),
                         spec=sched.spec, cfg=ex.ExecConfig(impl=impl))
    g = torch.autograd.grad((o * torch.from_numpy(cot).reshape(o.shape))
                            .sum(), xs)
    return o.detach().reshape(N * TPW, H, D), g


@pytest.mark.parametrize("coalesce", [1, 16])
@pytest.mark.parametrize("mask", ["causal", "swa:24"])
def test_overlap_matches_dense_oracle(mask, coalesce):
    sched = _sched(mask, coalesce, True)
    assert sched.spec.overlap and sched.spec.n_rounds > 0
    qkv, _ = _inputs()
    with torch.no_grad():
        o = ex.fcp_attention(
            *(torch.from_numpy(x).reshape(N, TPW, -1, D) for x in qkv),
            ex.schedule_tables(sched, "cpu"), spec=sched.spec)
    seg = jnp.asarray(sched.batch.seg_ids)
    pos = jnp.asarray(sched.batch.positions)
    q, k, v = (jnp.asarray(x).transpose(1, 0, 2) for x in qkv)
    ref, _ = jref.reference_attention(q, k, v, seg, pos, seg, pos, mask)
    err = _nerr(o.reshape(N * TPW, H, D).numpy(),
                np.asarray(ref.transpose(1, 0, 2)))
    assert err <= ORACLE_TOL, err


@pytest.mark.parametrize("impl", ["fused_xla", "xla"])
@pytest.mark.parametrize("coalesce", [1, 16])
@pytest.mark.parametrize("mask", ["causal", "swa:24"])
def test_overlap_on_off_equal(mask, coalesce, impl):
    """A scheduling transform only: the same forward and dq bytes."""
    qkv, cot = _inputs(1)
    off, on = _sched(mask, coalesce, False), _sched(mask, coalesce, True)
    if coalesce == 1:
        # parity allocation: consecutive rounds use disjoint slot halves
        assert on.spec.ext_slots > off.spec.ext_slots
    o0, g0 = _fcp(off, qkv, cot, impl)
    o1, g1 = _fcp(on, qkv, cot, impl)
    assert torch.equal(o0, o1)
    assert torch.equal(g0[0], g1[0])
    for a, b in zip(g1[1:], g0[1:]):
        assert _nerr(a.numpy(), b.numpy()) <= DKDV_TOL


def test_reshuffle_round_trip_is_identity():
    """stream -> sched -> stream of a hidden state with an integer
    position channel riding as f32 is bitwise the identity, and so is
    its gradient."""
    sched = _sched("causal", 4, False)
    tabs = ex.schedule_tables(sched, "cpu")
    rng = np.random.default_rng(2)
    hid = torch.from_numpy(rng.normal(size=(N, TPW, 24)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(sched.batch.positions.reshape(N, TPW))
    x = torch.cat([hid.float(), pos.float()[..., None]], dim=-1)
    x.requires_grad_(True)
    xs = ex.fcp_reshuffle(x, tabs, spec=sched.spec)
    assert not torch.equal(xs, x)                 # the layout moved
    back = ex.fcp_reshuffle(xs, tabs, spec=sched.spec, reverse=True)
    assert torch.equal(back, x)
    assert torch.equal(back[..., :-1].to(torch.bfloat16), hid)
    assert torch.equal(torch.round(back[..., -1]).to(pos.dtype), pos)
    g = torch.randn_like(x)
    (gx,) = torch.autograd.grad(back, x, g)
    assert torch.equal(gx, g)


@pytest.mark.parametrize("impl", ["fused_xla", "xla"])
def test_sched_layout_between_reshuffles_equals_stream(impl):
    sched = _sched("causal", 16, False)
    tabs = ex.schedule_tables(sched, "cpu")
    qkv, _ = _inputs(3)
    q, k, v = (torch.from_numpy(x).reshape(N, TPW, -1, D) for x in qkv)
    cfg = ex.ExecConfig(impl=impl)
    with torch.no_grad():
        o_stream = ex.fcp_attention(q, k, v, tabs, spec=sched.spec, cfg=cfg)

        def move(x, reverse=False):
            return ex.fcp_reshuffle(x.reshape(N, TPW, -1), tabs,
                                    spec=sched.spec,
                                    reverse=reverse).reshape(x.shape)
        o_sched = ex.fcp_attention(move(q), move(k), move(v), tabs,
                                   spec=sched.spec, cfg=cfg,
                                   layout="sched")
        assert torch.equal(move(o_sched, reverse=True), o_stream)


def test_serving_prefill_with_overlap_matches_jax():
    arch = "stablelm_1_6b"
    cfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    jparams = JModel(cfg).init(jax.random.key(0))
    serve = dict(cache_len=160, decode_slots=2, queue_depth=8,
                 max_new_tokens=8, prefill_tokens_per_worker=128,
                 bucket_min=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (L,)).astype(np.int32)
               for L in (5, 23, 64, 128)]
    jloop = JLoop(JModel(cfg), jparams, make_mesh((1, 1), ("data", "model")),
                  JParallel(block_size=16), JServe(**serve))
    jloop.run(prompts, max_new=6)
    tcfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    loop = ServingLoop(Model(tcfg),
                       params_from_numpy(jax.device_get(jparams), "cpu"),
                       StackedMesh((2, 2), ("data", "model")),
                       ParallelConfig(block_size=16, overlap=True),
                       ServeConfig(**serve), device="cpu")
    loop.run(prompts, max_new=6)
    plans = [loop.plan_cache.lookup(k) for k in loop.plan_cache.keys()]
    assert all(s.spec.overlap for s in plans)
    assert any(s.spec.n_rounds for s in plans)        # KV really ships
    want = {r.rid: list(map(int, r.tokens)) for r in jloop.stats.finished}
    got = {r.rid: list(map(int, r.tokens)) for r in loop.stats.finished}
    assert got == want


def _granite_step(layer_pipeline):
    """Step-0 loss and gradients of the port's granite smoke step (f32,
    4 stacked workers) with a capacity factor that drops no token."""
    cfg = dataclasses.replace(smoke_config("granite_moe_3b_a800m"),
                              param_dtype="float32", capacity_factor=8.0)
    tpw, bs = 128, 32
    b = SyntheticLoader(dist="real_world", n_frames=N, tokens_per_worker=tpw,
                        vocab_size=cfg.vocab_size, seed=0).next()
    pcfg = ParallelConfig(block_size=bs, layer_pipeline=layer_pipeline)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, tpw)
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    loss, grads = T.value_and_grad(Model(cfg), pcfg, attn)(
        params, T.batch_arrays(b, cfg, "cpu"))
    return attn, float(loss), adamw.tree_leaves(grads)


def test_granite_layer_pipeline_matches_stream_layout():
    """Under the layer pipeline the MoE routes schedule-layout frames;
    with no capacity drop the routing frame does not matter."""
    attn, loss, grads = _granite_step(True)
    assert isinstance(attn[0], T.PipelinedAttn)
    assert attn[0].enter is not None and attn[-1].exit is not None
    _, loss0, grads0 = _granite_step(False)
    assert abs(loss / loss0 - 1) <= 1e-5
    for a, b in zip(grads, grads0):
        assert _nerr(a.numpy(), b.numpy()) <= 1e-5


def test_layer_pipeline_refuses_shared_attention():
    cfg = smoke_config("zamba2_2_7b")
    pcfg = ParallelConfig(layer_pipeline=True)
    with pytest.raises(ValueError, match="hybrid"):
        T.attention_closures(cfg, pcfg, T.layer_mask_specs(cfg, pcfg),
                             [True], {}, "cpu", "fused_xla")
    argv = ["--arch", "zamba2_2_7b", "--smoke", "--mesh", "4x1",
            "--block-size", "32", "--tokens-per-worker", "128",
            "--steps", "1", "--device", "cpu", "--layer-pipeline"]
    with pytest.raises(ValueError, match="layer_pipeline"):
        T.main(argv)


def test_train_cli_with_overlap_and_layer_pipeline_matches_plain():
    """The CLI's flags take effect and change no number: two supervised
    steps with both on give the plain run's losses (1e-5 relative: the
    weight gradients sum the tokens in the schedule's order)."""
    argv = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x1",
            "--dist", "real_world", "--block-size", "32",
            "--tokens-per-worker", "128", "--steps", "2", "--device", "cpu",
            "--attn-impl", "fused_xla"]
    plain = T.main(argv)
    both = T.main(argv + ["--overlap", "--layer-pipeline"])
    assert isinstance(both, T.Supervisor)
    assert both.pcfg.overlap and both.pcfg.layer_pipeline
    assert all(s.spec.overlap for s in both.last_scheds.values())
    np.testing.assert_allclose([r.loss for r in both.history],
                               [r.loss for r in plain.history], rtol=1e-5)
