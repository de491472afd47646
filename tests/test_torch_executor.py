"""The port's FCP executor on stacked workers (plain kernel versions on
the CPU) against the reference's dense oracle, CP decode against the
reference's dense decode attention, and the wire codec against the
reference's codec.

Tolerances: 1e-5 normalized against the oracle (the reference's own
multidevice gate is 1e-6; the gap covers summation order across two
frameworks); the bf16 / int8 wires within 1e-2 / 3e-2 of the f32 wire,
as in ``tests/multidevice/run_wire_executor.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import dense_decode_attn as j_dense_decode
from repro.runtime import wire as jwire
from repro_torch.core import executor as ex
from repro_torch.core.schedule import make_schedule
from repro_torch.kernels import flash_attention as tfa
from repro_torch.runtime import wire as twire
from test_torch_threads import intra_op_share  # noqa: F401


N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
SEQLENS = [90, 50, 40, 30, 26, 20]           # mixed docs over 256 tokens


def _run(mask, wire, coalesce, dtype=torch.float32, seed=0, out=None):
    sched = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                          head_dim=D, mask=mask, coalesce=coalesce,
                          wire=wire, verify=True)
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(N * TPW, h, D)).astype(np.float32)
               for h in (H, KH, KH))
    tabs = ex.schedule_tables(sched, "cpu")
    o = ex.fcp_attention(
        *(torch.from_numpy(x).reshape(N, TPW, -1, D).to(dtype)
          for x in (q, k, v)), tabs, spec=sched.spec,
        cfg=ex.ExecConfig(out_dtype=out))
    return sched, (q, k, v), o.reshape(N * TPW, H, D)


def _oracle(sched, qkv, mask):
    seg = jnp.asarray(sched.batch.seg_ids)
    pos = jnp.asarray(sched.batch.positions)
    q, k, v = (jnp.asarray(x).transpose(1, 0, 2) for x in qkv)
    o, _ = jref.reference_attention(q, k, v, seg, pos, seg, pos, mask)
    return np.asarray(o.transpose(1, 0, 2))


@pytest.mark.parametrize("coalesce", [1, 16])
@pytest.mark.parametrize("mask", ["causal", "swa:24"])
def test_fcp_matches_dense_oracle(mask, coalesce):
    sched, qkv, o = _run(mask, "f32", coalesce)
    # the plan really ships KV between workers and reshuffles
    assert sched.spec.n_rounds > 0 and sched.spec.n_resh_rounds > 0
    ref = _oracle(sched, qkv, mask)
    err = np.abs(o.numpy() - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= 1e-5, err
    assert tfa.fused_flash_fwd.launches == 0          # CPU: plain version


@pytest.mark.parametrize("wire,tol", [("bf16", 1e-2), ("int8", 3e-2)])
def test_quantized_wires_near_f32(wire, tol):
    _, _, o32 = _run("causal", "f32", 4, seed=1)
    _, _, oq = _run("causal", wire, 4, seed=1)
    err = (oq - o32).abs().max() / max(1.0, float(o32.abs().max()))
    assert float(err) <= tol, float(err)
    assert float(err) > 0                              # the wire is lossy


def test_out_dtype_and_plain_impl():
    sched, qkv, o = _run("causal", "f32", 16)
    _, _, o16 = _run("causal", "f32", 16, out="bfloat16")
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o16.float(), o, atol=1e-2, rtol=1e-2)
    tabs = ex.schedule_tables(sched, "cpu")
    assert ex.schedule_tables(sched, "cpu") is tabs     # memoized
    o_plain = ex.fcp_attention(
        *(torch.from_numpy(x).reshape(N, TPW, -1, D) for x in qkv), tabs,
        spec=sched.spec, cfg=ex.ExecConfig(impl="fused_xla"))
    torch.testing.assert_close(o_plain.reshape(N * TPW, H, D), o,
                               atol=0, rtol=0)


def test_unported_paths_raise():
    """The double-buffered round loop and the sched layout, once
    refused, run (their parity is ``tests/test_torch_overlap.py``); a
    layout the executor does not know raises."""
    sched = make_schedule(SEQLENS, N, TPW, BS, overlap=True)
    assert sched.spec.overlap and sched.spec.n_rounds > 0
    tabs = ex.schedule_tables(sched, "cpu")
    x = torch.ones(N, TPW, 2, 8)
    for layout in ("stream", "sched"):
        o = ex.fcp_attention(x, x, x, tabs, spec=sched.spec, layout=layout)
        assert o.shape == x.shape and torch.isfinite(o).all()
    with pytest.raises(ValueError, match="layout"):
        ex.fcp_attention(x, x, x, tabs, spec=sched.spec, layout="user")


@pytest.mark.parametrize("n_shards", [1, 2])
def test_cp_decode_matches_dense_decode(n_shards):
    rng = np.random.default_rng(5)
    B, S, Hq, Hk, Dh = 3, 48, 4, 2, 32
    q = rng.normal(size=(B, Hq, Dh)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hk, Dh)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hk, Dh)).astype(np.float32)
    lengths = np.array([1, 30, 48], np.int32)   # within / across shards
    ref = np.asarray(j_dense_decode(*map(jnp.asarray, (q, kc, vc,
                                                       lengths))))
    got = ex.cp_decode_attention(*map(torch.from_numpy, (q, kc, vc,
                                                         lengths)),
                                 n_shards=n_shards)
    err = np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= 1e-5, err


def test_cp_cache_update_in_place():
    cache = torch.zeros(2, 8, 1, 4)
    new = torch.ones(2, 1, 4)
    out = ex.cp_cache_update(cache, new, torch.tensor([3, 8]))
    assert out is cache
    assert cache[0, 3].eq(1).all() and cache.sum() == 4   # pos 8: dropped


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_wire_codec_matches_reference(kind):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 2, 4, 8)).astype(np.float32) * 5
    x[1] = 0                                   # zero-amax (trash) rows
    jp, js = jwire.encode(jnp.asarray(x), jwire.parse_wire(kind), (-2, -1))
    tp, ts = twire.encode(torch.from_numpy(x), twire.parse_wire(kind),
                          (-2, -1))
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp, np.float32))
    if kind == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = twire.decode(tp, ts, twire.parse_wire(kind), torch.float32)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jwire.decode(jp, js, jwire.parse_wire(kind),
                                           jnp.float32)))
    assert np.isfinite(y.numpy()).all() and not y[1].any()


def test_ship_is_an_index_copy():
    x = torch.randn(4, 2, 3, 8, 4)
    out = twire.ship(x, ((0, 2), (2, 1), (3, 0)), twire.WIRE_F32)
    assert torch.equal(out[2], x[0]) and torch.equal(out[1], x[2])
    assert torch.equal(out[0], x[3]) and not out[3].any()   # unmatched
    q = twire.ship(x, ((0, 2),), twire.WIRE_INT8)
    assert (q[2] - x[0]).abs().max() <= x[0].abs().amax() / 127
