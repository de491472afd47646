"""The port's serving loop (FCP or dense prefill + CP decode on a stacked
mesh, plain kernel versions on the CPU) against the reference: token for
token equal to the JAX ``ServingLoop`` on a 1x1 mesh, and prefill
last-token logits within 1e-5 normalized of the JAX dense-attention
prefill, on the same f32 smoke weights of a dense (StableLM), an MoE
(Granite), an SSM (Mamba2) and a hybrid (Zamba2) model.

As in the reference, FCP prefills only with more than one prefill frame
(``pod x data``) and attention; otherwise the dense escape hatch does.
MoE capacity is per frame, and a prefill batch's frames are its CP
workers (``[n_cp, tokens_per_worker]`` in both packages): the MoE model
serves on 2 workers of 128 tokens, and since every prefill batch here
holds one request, its first frame is the reference's one frame, token
for token (the second holds padding rows only).  A dense model's tokens
do not depend on the split and serve on 2 workers.  The recurrent models
chunk their prompts down to a bucket edge (or skip prefill below the
smallest edge), so they serve with the reference's prefill budget of 128
tokens: the same edges, the same chunks and tails; the hybrid's shared
attention prefills through FCP on 2 workers of 64 tokens.

The dense prefill on a 1x1 mesh gives the JAX loop's and the FCP loop's
tokens; a pod mesh (2x2x2) serves densely with the reference's
``RuntimeWarning`` and the 4x2 FCP loop's tokens, and raises under
``strict_prefill`` (``tests/test_torch_pods.py`` holds the prefill each
mesh dispatches to against the reference's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from test_torch_threads import intra_op_share  # noqa: F401


SERVE = dict(cache_len=160, decode_slots=2, queue_depth=8,
             max_new_tokens=8, prefill_tokens_per_worker=128,
             bucket_min=16)
LENS = [5, 23, 64, 128]          # below the smallest edge .. largest
# recurrent: below the smallest edge (fresh), at an edge, between edges
# (a tail), beyond the budget (chunk 128 and a tail)
LENS_RECURRENT = [5, 16, 23, 64, 150]
MESH = {"stablelm_1_6b": (2, 2), "granite_moe_3b_a800m": (2, 1),
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


def _port_loop(tparams, arch="stablelm_1_6b", mesh=None, **serve_kw):
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    serve = dict(SERVE, prefill_tokens_per_worker=TPW.get(arch, 128))
    serve.update(serve_kw)
    return ServingLoop(Model(cfg), tparams, StackedMesh(mesh or MESH[arch]),
                       ParallelConfig(block_size=16), ServeConfig(**serve),
                       device="cpu")


def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lens]


def _tokens(loop) -> dict:
    return {r.rid: list(map(int, r.tokens)) for r in loop.stats.finished}


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX 1x1 loop's tokens per model (LENS / LENS_RECURRENT
    prompts, 6 new tokens each)."""
    return {}


def _jax_tokens(jax_tokens, arch, cfg, jparams, prompts) -> dict:
    if arch not in jax_tokens:
        jloop = JLoop(JModel(cfg), jparams,
                      make_mesh((1, 1), ("data", "model")),
                      JParallel(block_size=16), JServe(**SERVE))
        jloop.run(prompts, max_new=6)
        jax_tokens[arch] = _tokens(jloop)
    return jax_tokens[arch]


def test_tokens_match_jax_serving_loop(weights, jax_tokens):
    arch, cfg, jparams, tparams = weights
    recurrent = arch not in ATTENTION
    prompts = _prompts(cfg, LENS_RECURRENT if recurrent else LENS)
    want = _jax_tokens(jax_tokens, arch, cfg, jparams, prompts)
    loop = _port_loop(tparams, arch)
    rep = loop.run(prompts, max_new=6)
    assert _tokens(loop) == want
    # every prompt of an attention model rode one FCP prefill call (2
    # prefill frames) and its bucket plan was cached
    assert rep["prefill_impl"] == ("fcp" if cfg.uses_attention
                                   else "dense")
    assert loop.n_cp == loop.mesh.shape["data"]
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
    """Every family of the reference builds (the vlm one since the
    front end was ported); admission refuses what the loop cannot hold."""
    cfg = smoke_config("internvl2_1b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert params["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    loop = _port_loop(None)
    with pytest.raises(ValueError, match=r"cache_len >= \d+"):
        loop.submit(np.ones((SERVE["cache_len"] - 2,), np.int32),
                    max_new=8)
    with pytest.raises(ValueError, match="max_new"):
        loop.submit(np.ones((4,), np.int32), max_new=9)
    with pytest.raises(ValueError, match="unknown prefill_impl"):
        _port_loop(None, prefill_impl="ring")


def test_dense_prefill_matches_fcp_and_jax(attn_weights, jax_tokens):
    """``prefill_impl="dense"`` on a 1x1 mesh: the JAX loop's tokens and
    the port's FCP loop's."""
    arch, cfg, jparams, tparams = attn_weights
    prompts = _prompts(cfg, LENS)
    want = _jax_tokens(jax_tokens, arch, cfg, jparams, prompts)
    loop = _port_loop(tparams, arch, mesh=(1, 1), prefill_impl="dense")
    rep = loop.run(prompts, max_new=6)
    assert rep["prefill_impl"] == "dense" and loop.n_cp == 1
    assert rep["plan_cache"]["misses"] == 0       # dense plans nothing
    assert _tokens(loop) == want
    fcp = _port_loop(tparams, arch)
    assert fcp.run(prompts, max_new=6)["prefill_impl"] == "fcp"
    assert _tokens(fcp) == want


def test_pod_mesh_serves_dense_with_a_warning(attn_weights):
    """The reference's pod-mesh fallback (tests/multidevice/run_serve.py):
    FCP prefill on a 2x2x2 mesh warns, serves densely with the tokens of
    a 4x2 FCP loop of the same prefill budget, and ``strict_prefill``
    keeps the hard error."""
    arch, cfg, _, tparams = attn_weights
    prompts = _prompts(cfg, LENS)
    fcp = _port_loop(tparams, arch, mesh=(4, 2), decode_slots=4,
                     prefill_tokens_per_worker=64)
    assert fcp.run(prompts, max_new=6)["prefill_impl"] == "fcp"
    with pytest.warns(RuntimeWarning, match="pod meshes"):
        pod = _port_loop(tparams, arch, mesh=(2, 2, 2), decode_slots=4,
                         prefill_tokens_per_worker=64)
    assert pod.n_cp == 4 and pod.budget == fcp.budget
    rep = pod.run(prompts, max_new=6)
    assert rep["prefill_impl"] == "dense" and rep["requests"] == len(LENS)
    assert _tokens(pod) == _tokens(fcp)
    with pytest.raises(ValueError, match="strict_prefill"):
        _port_loop(tparams, arch, mesh=(2, 2, 2),
                   prefill_tokens_per_worker=64, strict_prefill=True)
