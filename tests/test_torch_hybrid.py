"""The port's hybrid family (``repro_torch.models.hybrid``: a Mamba2
backbone and one shared attention block every ``attn_every`` layers)
against the reference on the CPU, zamba2-2.7b smoke on the same f32
weights (``params_from_numpy``): the packed-stream forward, where the
reference attends with its dense oracle and the port through FCP on four
stacked workers (the executor's ``fused_xla`` impl: kernel 1's plain
version), and the prefill's logits and decode caches (SSM states, conv
tails, the shared block's K/V per invocation), then a decode step from
them.  The train step against the reference's is a case of
``test_train_step_matches_jax`` (``tests/test_torch_train.py``).

Tolerances: 1e-5 relative to the largest reference value (f32; two
frameworks' summation orders, the SSD recurrence summed in another
order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.models import dense_cache_update as j_update
from repro.models import dense_decode_attn as j_decode_attn
from repro.models import hybrid as jhybrid
from repro_torch.configs.base import ParallelConfig, smoke_config
from repro_torch.data import SyntheticLoader
from repro_torch.launch import train as T
from repro_torch.models import (Model, dense_attn_fn, dense_cache_update,
                                dense_decode_attn)
from repro_torch.models.convert import params_from_numpy
from test_torch_threads import intra_op_share  # noqa: F401


ARCH = "zamba2_2_7b"
TOL = 1e-5
N, TPW, BS = 4, 128, 32


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(j_smoke(ARCH), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCH), param_dtype="float32")
    jparams = jax.device_get(JModel(jcfg).init(jax.random.key(0)))
    return jcfg, cfg, jparams, params_from_numpy(jparams, "cpu")


def test_forward_fcp_matches_dense_reference(smoke):
    """Two shared-block invocations over a real_world stream of four
    frames; every invocation takes the one FCP closure."""
    jcfg, cfg, jparams, tparams = smoke
    assert cfg.n_layers // cfg.attn_every == 2
    b = SyntheticLoader(dist="real_world", n_frames=N, tokens_per_worker=TPW,
                        vocab_size=cfg.vocab_size, seed=0).next()
    jb = {"tokens": jnp.asarray(b.tokens),
          "positions": jnp.asarray(b.positions)}
    jl = JModel(jcfg).forward(jax.tree.map(jnp.asarray, jparams), jb,
                              j_dense_attn(jnp.asarray(b.seg_ids),
                                           jb["positions"]))
    pcfg = ParallelConfig(block_size=BS)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, TPW)
    assert sched.spec.n_rounds > 0
    calls = []
    attn = T.make_fcp_attn_fn(sched, "cpu", pcfg, "fused_xla")

    def counted(q, k, v):
        calls.append(q.shape)
        return attn(q, k, v)
    tl = Model(cfg).forward(tparams, T.batch_arrays(b, cfg, "cpu"), counted)
    assert len(calls) == 2 and calls[0] == (N, TPW, cfg.n_heads,
                                            cfg.head_dim)
    assert tl.shape == jl.shape and _nerr(tl.detach(), jl) <= TOL


def test_prefill_caches_and_decode_match_reference(smoke):
    """Prefill of 4 sequences of 64 tokens (one of them two documents),
    then one decode step from the caches, against the reference's
    ``forward_prefill`` and ``decode_step`` with dense attention."""
    jcfg, cfg, jparams, tparams = smoke
    Bn, S = 4, 64
    rng = np.random.default_rng(9)
    toks = rng.integers(1, cfg.vocab_size, (Bn, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (Bn, 1))
    pos[2, 40:] = np.arange(S - 40)
    seg = np.repeat(np.arange(Bn, dtype=np.int32), S).reshape(Bn, S)
    seg[2, 40:] = Bn
    shape = (2, Bn * S // 2)                     # two frames
    jp = jax.tree.map(jnp.asarray, jparams)
    jb = {"tokens": jnp.asarray(toks.reshape(shape)),
          "positions": jnp.asarray(pos.reshape(shape))}
    jlog, jcache = jhybrid.forward_prefill(
        jp, jcfg, jb, j_dense_attn(jnp.asarray(seg.reshape(shape)),
                                   jb["positions"]), Bn, S)
    model = Model(cfg)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    tseg = torch.from_numpy(seg.reshape(shape))
    tlog, tcache = model.forward_prefill(
        tparams, tb, dense_attn_fn(tseg, tb["positions"]), batch_size=Bn,
        seq_len=S)
    assert _nerr(tlog, jlog) <= TOL
    assert set(tcache) == {"state", "conv", "k", "v"}
    for k in tcache:
        assert tcache[k].shape == jcache[k].shape, k
        assert _nerr(tcache[k], jcache[k]) <= TOL, k
    # one decode step from the prefill caches, in a cache of 80 positions
    jc = JModel(jcfg).init_cache(Bn, 80)
    tc = model.init_cache(Bn, 80, device="cpu")
    jc = {"state": jcache["state"], "conv": jcache["conv"],
          "k": jc["k"].at[:, :, :S].set(jcache["k"]),
          "v": jc["v"].at[:, :, :S].set(jcache["v"])}
    for k in tc:
        tc[k][:, :, :tcache[k].shape[2]] = tcache[k]
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    p = np.full((Bn,), S, np.int32)
    jlg, jc = JModel(jcfg).decode_step(jp, jnp.asarray(tok), jnp.asarray(p),
                                       jc, j_decode_attn, j_update)
    tlg, tc = model.decode_step(tparams, torch.from_numpy(tok),
                                torch.from_numpy(p), tc, dense_decode_attn,
                                dense_cache_update)
    assert _nerr(tlg, jlg) <= TOL
    for k in tc:
        assert _nerr(tc[k], jc[k]) <= TOL, k
