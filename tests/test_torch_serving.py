"""The port's serving loop (FCP prefill + CP decode on a stacked mesh,
plain kernel versions on the CPU) against the reference: token for token
equal to the JAX ``ServingLoop`` on a 1x1 mesh, and prefill last-token
logits within 1e-5 normalized of the JAX dense-attention prefill, on the
same f32 smoke weights of a dense (StableLM), an MoE (Granite), an SSM
(Mamba2) and a hybrid (Zamba2) model.

MoE capacity is per frame, and a prefill batch's frames are its CP
workers (``[n_cp, tokens_per_worker]`` in both packages), so the MoE
model serves on one CP worker, as the reference's 1x1 mesh does (2
cache shards); a dense model's tokens do not depend on the split and
serve on 2 workers.  The recurrent models chunk their prompts down to a
bucket edge (or skip prefill below the smallest edge), so they serve
with the reference's prefill budget of 128 tokens: the same edges, the
same chunks and tails; the hybrid's shared attention prefills through
FCP on 2 workers of 64 tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import smoke_config as j_smoke
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.models import transformer as jtf
from repro.runtime.serving import ServingLoop as JLoop
from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                      smoke_config)
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.serving import ServingLoop

SERVE = dict(cache_len=160, decode_slots=2, queue_depth=8,
             max_new_tokens=8, prefill_tokens_per_worker=128,
             bucket_min=16)
LENS = [5, 23, 64, 128]          # below the smallest edge .. largest
# recurrent: below the smallest edge (fresh), at an edge, between edges
# (a tail), beyond the budget (chunk 128 and a tail)
LENS_RECURRENT = [5, 16, 23, 64, 150]
MESH = {"stablelm_1_6b": (2, 2), "granite_moe_3b_a800m": (1, 2),
        "mamba2_130m": (1, 2), "zamba2_2_7b": (2, 2)}
ATTENTION = ["stablelm_1_6b", "granite_moe_3b_a800m"]
TPW = {"zamba2_2_7b": 64}         # prefill tokens per worker (default 128)


def _weights(arch):
    cfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    jparams = JModel(cfg).init(jax.random.key(0))
    return (arch, cfg, jparams,
            params_from_numpy(jax.device_get(jparams), "cpu"))


@pytest.fixture(scope="module", params=list(MESH))
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module", params=ATTENTION)
def attn_weights(request):
    return _weights(request.param)


def _port_loop(tparams, arch="stablelm_1_6b"):
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    serve = dict(SERVE, prefill_tokens_per_worker=TPW.get(arch, 128))
    return ServingLoop(Model(cfg), tparams,
                       StackedMesh(MESH[arch], ("data", "model")),
                       ParallelConfig(block_size=16), ServeConfig(**serve),
                       device="cpu")


def test_tokens_match_jax_serving_loop(weights):
    arch, cfg, jparams, tparams = weights
    recurrent = arch not in ATTENTION
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (L,)).astype(np.int32)
               for L in (LENS_RECURRENT if recurrent else LENS)]
    jloop = JLoop(JModel(cfg), jparams, make_mesh((1, 1), ("data", "model")),
                  JParallel(block_size=16), JServe(**SERVE))
    jloop.run(prompts, max_new=6)
    loop = _port_loop(tparams, arch)
    rep = loop.run(prompts, max_new=6)
    want = {r.rid: list(map(int, r.tokens)) for r in jloop.stats.finished}
    got = {r.rid: list(map(int, r.tokens)) for r in loop.stats.finished}
    assert got == want
    # every prompt rode one FCP prefill call and its bucket plan was
    # cached; decode ran over 2 cache shards
    assert rep["prefill_impl"] == "fcp" and loop.n_cp == loop.mesh.shape[
        "data"]
    modes = [r.mode for r in sorted(loop.stats.finished,
                                    key=lambda r: r.rid)]
    if not recurrent:
        assert modes == ["pad"] * len(LENS)
        assert rep["plan_cache"]["misses"] == rep["prefill_batches"]
        return
    assert modes == ["fresh"] + ["chunk"] * 4
    assert [r.tail_tokens for r in sorted(loop.stats.finished,
                                          key=lambda r: r.rid)] == [
        5, 0, 7, 0, 22]
    # the hybrid plans one FCP schedule per bucket (16, 64, 128); the SSM
    # none
    assert rep["plan_cache"]["misses"] == (3 if cfg.uses_attention else 0)


def test_prefill_logits_match_jax_dense_prefill(attn_weights):
    arch, cfg, jparams, tparams = attn_weights
    loop = _port_loop(tparams, arch)
    rng = np.random.default_rng(4)
    reqs = [loop.submit(rng.integers(1, cfg.vocab_size, (L,)), max_new=2)
            for L in (61, 33)]
    E = reqs[0].bucket
    assert all(r.bucket == E for r in reqs)
    batch, last = loop.assemble(E, reqs)
    got, cache = loop.prefill_fn(E)(tparams, batch, last)
    toks = jnp.asarray(batch["tokens"].numpy())
    pos = jnp.asarray(batch["positions"].numpy())
    Pn = loop.budget // E
    seg = jnp.repeat(jnp.arange(Pn, dtype=jnp.int32), E).reshape(toks.shape)
    logits, ks, _ = jtf.forward_prefill(
        jparams, cfg, {"tokens": toks, "positions": pos},
        j_dense_attn(seg, pos, mask=True))
    ref = np.asarray(logits).reshape(Pn, E, -1)[np.arange(Pn),
                                                last.numpy()]
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() / scale <= 1e-5
    ref_k = np.asarray(ks).reshape(cfg.n_layers, Pn, E, -1,
                                   cfg.head_dim)
    np.testing.assert_allclose(cache["k"].numpy(), ref_k, atol=1e-5,
                               rtol=1e-5)


def test_admission_and_unported_families():
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(smoke_config("internvl2_1b"))
    loop = _port_loop(None)
    with pytest.raises(ValueError, match=r"cache_len >= \d+"):
        loop.submit(np.ones((SERVE["cache_len"] - 2,), np.int32),
                    max_new=8)
    with pytest.raises(ValueError, match="max_new"):
        loop.submit(np.ones((4,), np.int32), max_new=9)
    with pytest.raises(NotImplementedError, match="'dense' is not ported"):
        ServingLoop(loop.model, None, loop.mesh, loop.pcfg,
                    ServeConfig(**SERVE, prefill_impl="dense"),
                    device="cpu")
