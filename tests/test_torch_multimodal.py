"""The audio and vision-language families (musicgen, internvl2: transformer
backbones behind the reference's front-end stub) on the CPU against the
reference, on the same f32 smoke weights: the front-end embedding, the
stub batch of ``batch_arrays``, the forward logits, three train steps on
4 stacked workers (FCP on the plain kernel versions; internvl2's smoke
config has 7 query heads over 1 kv head of 16, a GQA group of 7 and
``qkv_bias``) and internvl2's FCP serving tokens.

Tolerances: the embedding 1e-6 (one product of f32 operands in two
frameworks); the stub batch byte for byte (the same numpy draws); the
logits 1e-5 normalized (two layers of attention and GEMMs in two
frameworks' summation orders, the bound of ``test_torch_executor.py``);
the train steps those of ``test_train_step_matches_jax``; serving tokens
equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import smoke_config as j_smoke
from repro.data import SyntheticLoader as JLoader
from repro.launch import train as JT
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.models import transformer as jtf
from repro.optimizer import adamw as jadamw
from repro.runtime.serving import ServingLoop as JLoop
from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                      TrainConfig, smoke_config)
from repro_torch.data import SyntheticLoader
from repro_torch.launch import train as T
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import Model, dense_attn_fn, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw
from repro_torch.runtime.serving import ServingLoop
from test_torch_threads import intra_op_share  # noqa: F401

ARCHS = ["internvl2_1b", "musicgen_large"]
N = 4                  # stacked workers
# frames longer than the stub's 256 patch positions, so text positions
# carry a loss
TPW, BS = 320, 32


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    jparams = jax.device_get(JModel(jcfg).init(jax.random.key(0)))
    return arch, jcfg, cfg, jparams, params_from_numpy(jparams, "cpu")


@pytest.fixture(params=ARCHS)
def weights(request):
    return _weights(request.param)


def _frontend_batch(cfg, rng, f=2, t=48, p=16):
    toks = rng.integers(0, cfg.vocab_size, (f, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (f, 1))
    fe = (rng.normal(size=(f, p, cfg.frontend_dim)) * 0.02).astype(
        np.float32)
    mask = np.zeros((f, t), bool)
    mask[0, :p] = True                  # frame 1 keeps its tokens
    mask[1, : p // 2] = True
    return {"tokens": toks, "positions": pos, "frontend_embeds": fe,
            "frontend_mask": mask}


def test_embed_tokens_with_front_end(weights):
    arch, jcfg, cfg, jparams, tparams = weights
    assert tparams["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    nb = _frontend_batch(cfg, np.random.default_rng(1))
    want = np.asarray(jtf.embed_tokens(
        jax.tree.map(jnp.asarray, jparams), jcfg,
        {k: jnp.asarray(v) for k, v in nb.items()}))
    got = transformer.embed_tokens(
        tparams, cfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # the patches replaced the token embeddings only where the mask is set
    plain = tparams["embed"][torch.from_numpy(nb["tokens"]).long()]
    keep = ~torch.from_numpy(nb["frontend_mask"])
    assert torch.equal(got[keep], plain[keep])
    assert not torch.equal(got[~keep], plain[~keep])


def test_batch_arrays_front_end_stub_matches_reference(weights):
    arch, jcfg, cfg, *_ = weights
    kw = dict(dist="real_world", n_frames=N, tokens_per_worker=TPW,
              vocab_size=cfg.vocab_size, seed=0)
    b, jb = SyntheticLoader(**kw).next(), JLoader(**kw).next()
    got, want = T.batch_arrays(b, cfg, "cpu"), JT.batch_arrays(jb, jcfg)
    assert set(got) == set(want)
    for k in ("frontend_embeds", "frontend_mask", "loss_mask", "tokens"):
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert got[k].numpy().tobytes() == w.tobytes(), k
    assert got["frontend_embeds"].shape == (N, 256, cfg.frontend_dim)
    assert not got["loss_mask"][:, :256].any()
    # the same patches on every step (the reference's seeding), others
    # from a caller's generator
    again = T.batch_arrays(b, cfg, "cpu")
    assert torch.equal(again["frontend_embeds"], got["frontend_embeds"])
    other = T.batch_arrays(b, cfg, "cpu", np.random.default_rng(1))
    assert not torch.equal(other["frontend_embeds"], got["frontend_embeds"])


def test_forward_logits_with_front_end_match_reference(weights):
    arch, jcfg, cfg, jparams, tparams = weights
    nb = _frontend_batch(cfg, np.random.default_rng(2))
    f, t = nb["tokens"].shape
    seg = np.repeat(np.arange(f, dtype=np.int32), t).reshape(f, t)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want = np.asarray(JModel(jcfg).forward(
        jax.tree.map(jnp.asarray, jparams), jb,
        j_dense_attn(jnp.asarray(seg), jb["positions"])))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    got = Model(cfg).forward(tparams, tb, dense_attn_fn(
        torch.from_numpy(seg), tb["positions"]))
    assert _nerr(got.detach().numpy(), want) <= 1e-5


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """The reference's step-0 loss and gradients and its three steps'
    (loss, gnorm), per model."""
    return {}


@pytest.mark.parametrize("case", ["internvl2_1b", "musicgen_large",
                                  "internvl2_1b:layer_pipeline"])
def test_train_steps_match_jax(case, jax_steps):
    """FCP over 4 stacked workers (``fused_xla``) against the reference's
    jitted train step with dense attention on a 1x1 mesh: same weights,
    same loader batch and stub patches, three steps (as
    ``test_train_step_matches_jax``); internvl2 also under the
    layer-pipelined reshuffle, which moves the hidden state after the
    front end."""
    arch, _, variant = case.partition(":")
    layer_pipeline = variant == "layer_pipeline"
    arch, jcfg, cfg, np_params, _ = _weights(arch)
    kw = dict(dist="real_world", n_frames=N, tokens_per_worker=TPW,
              vocab_size=cfg.vocab_size, seed=0)
    b, jb = SyntheticLoader(**kw).next(), JLoader(**kw).next()
    tcfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    if arch not in jax_steps:
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
        jax_steps[arch] = (jloss, jgrads, jlog)
    jloss, jgrads, jlog = jax_steps[arch]

    pcfg = ParallelConfig(block_size=BS, attention_impl="fused_xla",
                          layer_pipeline=layer_pipeline)
    model = Model(cfg)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, TPW)
    assert sched.spec.n_rounds > 0
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla")
    if layer_pipeline:
        assert isinstance(attn[0], T.PipelinedAttn)
    params = params_from_numpy(np_params, "cpu")
    batch = T.batch_arrays(b, cfg, "cpu")
    loss, grads = T.value_and_grad(model, pcfg, attn)(params, batch)
    assert abs(float(loss) / float(jloss) - 1) <= 1e-4
    jflat, tflat = jax.tree.leaves(jgrads), adamw.tree_leaves(grads)
    assert len(jflat) == len(tflat)
    assert float(grads["frontend_proj"].abs().max()) > 0
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
# serving
# --------------------------------------------------------------------------

SERVE = dict(cache_len=160, decode_slots=2, queue_depth=8,
             max_new_tokens=8, prefill_tokens_per_worker=128,
             bucket_min=16)
LENS = [5, 23, 64, 128]


def test_internvl2_fcp_serving_tokens_match_jax():
    """Text-only serving of the vision-language backbone, as the
    reference serves it: FCP prefill on 2 stacked workers (group 7,
    ``qkv_bias``) and CP decode over 2 cache shards, token for token the
    JAX loop's on a 1x1 mesh."""
    arch = "internvl2_1b"
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    assert cfg.qkv_bias and cfg.n_heads // cfg.n_kv_heads == 7
    jparams = JModel(jcfg).init(jax.random.key(0))
    np_params = jax.device_get(jparams)
    # non-zero q/k/v biases, so the bias path is exercised
    rng = np.random.default_rng(7)
    for name in ("bq", "bk", "bv"):
        np_params["layers"][name] = (0.1 * rng.normal(
            size=np_params["layers"][name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    prompts = [rng.integers(1, cfg.vocab_size, (L,)).astype(np.int32)
               for L in LENS]
    jloop = JLoop(JModel(jcfg), jparams, make_mesh((1, 1), ("data", "model")),
                  JParallel(block_size=16), JServe(**SERVE))
    jloop.run(prompts, max_new=6)
    loop = ServingLoop(Model(cfg), params_from_numpy(np_params, "cpu"),
                       StackedMesh((2, 2)), ParallelConfig(block_size=16),
                       ServeConfig(**SERVE), device="cpu")
    rep = loop.run(prompts, max_new=6)
    assert rep["prefill_impl"] == "fcp"

    def tokens(lp):
        return {r.rid: list(map(int, r.tokens)) for r in lp.stats.finished}
    assert tokens(loop) == tokens(jloop)
