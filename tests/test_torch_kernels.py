"""Kernel parity on the CPU: the plain PyTorch versions of the six ported
kernels, which the wrappers take for CPU tensors, against the reference
Pallas kernels run in interpret mode (as ``tests/test_kernels.py`` runs
them), the autograd Functions against ``jax.grad`` of the reference's
``custom_vjp`` ops, plus the torch oracles against the jnp oracles.

Tolerances: the fused run 2e-5 (the reference's own fused-vs-oracle
bound), the per-step kernel and the oracles 1e-5; slots a run does not
visit pass through bitwise.  The backward kernels and Functions 1e-5
normalized by the largest reference value (f32 throughout; the gap to
the reference's own 5e-6 covers summation order across two
frameworks), on every slot and row but the trash slot / kv trash row,
which the port's kernels skip and the reference computes.  The
precision tests emulate the bf16 hi/lo arithmetic of the CUDA
backward kernels 3-6 and hold it to the card's TOL_GRAD."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import masks as jmasks
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import masks as tmasks
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_threads import intra_op_share  # noqa: F401


# tile-boundary window / chunk (W % 64 != 0) on purpose
MASKS = ["causal", "swa:96", "chunked:96", "full"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _stream_meta(rng, n, docs, pad_frac=0.1):
    npad = int(n * pad_frac)
    body = n - npad
    cuts = np.sort(rng.choice(np.arange(1, body), docs - 1, replace=False))
    seg = np.full(n, -1, np.int32)
    pos = np.zeros(n, np.int32)
    lo = 0
    for i, hi in enumerate(list(cuts) + [body]):
        seg[lo:hi] = i
        pos[lo:hi] = np.arange(hi - lo)
        lo = hi
    return seg, pos


# --------------------------------------------------------------------------
# fused run forward
# --------------------------------------------------------------------------

def _fused_inputs(rng, SL=5, H=4, KH=2, bs=128, d=32, EX=6):
    """Executor-shaped buffers over one document stream and a q-sorted
    run: slot 0 <- kv {0}; slot 1 <- kv {1} (kv 0 arrived through the
    incoming accumulator); slot 2 <- kv {0, 1, 2}; a trash step on
    (SL-1, EX-1); slot 3 is never visited."""
    qs = rng.normal(size=(SL, H, bs, d)).astype(np.float32)
    kxt = rng.normal(size=(EX, KH, bs, d)).astype(np.float32)
    vxt = rng.normal(size=(EX, KH, bs, d)).astype(np.float32)
    q_seg = np.zeros((SL, bs), np.int32)
    q_seg[SL - 1] = -1
    q_seg[2, 5] = -1                                 # a fully masked row
    q_pos = (np.arange(bs)[None] + np.arange(SL)[:, None] * bs)
    kv_seg = np.zeros((EX, bs), np.int32)
    kv_seg[EX - 1] = -1
    kv_pos = (np.arange(bs)[None] + np.arange(EX)[:, None] * bs)
    step_q = np.array([0, 1, 2, 2, 2, SL - 1], np.int32)
    step_kv = np.array([0, 1, 0, 1, 2, EX - 1], np.int32)
    acc_o = np.zeros((SL, H, bs, d), np.float32)
    acc_lse = np.full((SL, H, bs), -1e30, np.float32)
    o_prev, l_prev = jref.reference_attention(
        qs[1], kxt[0], vxt[0], q_seg[1], q_pos[1].astype(np.int32),
        kv_seg[0], kv_pos[0].astype(np.int32), True)
    acc_o[1], acc_lse[1] = np.asarray(o_prev), np.asarray(l_prev)
    acc_o[3] = rng.normal(size=(H, bs, d))           # untouched, nonzero
    acc_lse[3] = rng.normal(size=(H, bs))
    tabs = dict(step_q=step_q, step_kv=step_kv, q_seg=q_seg,
                q_pos=q_pos.astype(np.int32), k_seg=kv_seg[step_kv],
                k_pos=kv_pos[step_kv].astype(np.int32))
    return qs, kxt, vxt, acc_o, acc_lse, tabs


@pytest.mark.parametrize("mask", MASKS)
def test_fused_plain_matches_interpret_kernel(mask):
    _check_fused_fwd(mask, 32)


@pytest.mark.parametrize("mask", ["causal", "chunked:96"])
def test_fused_plain_matches_interpret_kernel_d80(mask):
    """Kernel 1 at zamba2's head dim (80: no power of two)."""
    _check_fused_fwd(mask, 80)


def _check_fused_fwd(mask, d):
    rng = np.random.default_rng(11)
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng, d=d)
    jo, jl = jops.fused_run_attention(
        jnp.asarray(qs), jnp.asarray(kxt), jnp.asarray(vxt),
        jnp.asarray(acc_o), jnp.asarray(acc_lse),
        {k: jnp.asarray(v) for k, v in tabs.items()},
        mask=jmasks.parse_mask(mask), impl="pallas", block_q=64,
        block_k=64, interpret=True)
    to, tl = _t(acc_o), _t(acc_lse)
    out = tops.fused_run_attention(
        _t(qs), _t(kxt), _t(vxt), to, tl,
        {k: _t(v) for k, v in tabs.items()}, mask=tmasks.parse_mask(mask))
    assert out[0] is to and out[1] is tl             # updated in place
    jo, jl = np.asarray(jo), np.asarray(jl)
    for slot in (0, 1, 2):
        np.testing.assert_allclose(to[slot].numpy(), jo[slot], atol=2e-5,
                                   rtol=2e-5)
        live = jl[slot] > -1e29
        np.testing.assert_allclose(tl[slot].numpy()[live], jl[slot][live],
                                   atol=2e-5, rtol=2e-5)
        assert np.all(tl[slot].numpy()[~live] < -1e29)
    # the untouched slot passes through bitwise, in both packages
    np.testing.assert_array_equal(to[3].numpy(), acc_o[3])
    np.testing.assert_array_equal(tl[3].numpy(), acc_lse[3])
    np.testing.assert_array_equal(jo[3], acc_o[3])
    assert tfa.fused_flash_fwd.launches == 0          # CPU: plain version


def test_fused_plain_stacks_workers():
    """A leading worker dim runs every worker's run in one call, each
    equal to its own single-worker call."""
    rng = np.random.default_rng(12)
    one = [_fused_inputs(rng) for _ in range(2)]
    outs = []
    for qs, kxt, vxt, acc_o, acc_lse, tabs in one:
        o, l = _t(acc_o), _t(acc_lse)
        tops.fused_run_attention(_t(qs), _t(kxt), _t(vxt), o, l,
                                 {k: _t(v) for k, v in tabs.items()})
        outs.append((o, l))
    st = [torch.stack([_t(x[i]) for x in one]) for i in range(5)]
    tabs = {k: torch.stack([_t(x[5][k]) for x in one]) for k in one[0][5]}
    tops.fused_run_attention(*st, tabs)
    for w, (o, l) in enumerate(outs):
        torch.testing.assert_close(st[3][w], o, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(st[4][w], l, atol=1e-6, rtol=1e-6)


def test_run_segments():
    lo, hi = tfa.run_segments(np.array([[0, 0, 2, 2, 2, 4],
                                        [1, 4, 4, 4, 4, 4]]), skip_slot=4)
    assert lo.tolist() == [[0, 2], [0, 0]]
    assert hi.tolist() == [[2, 5], [1, 0]]
    with pytest.raises(ValueError, match="sorted"):
        tfa.run_segments(np.array([[0, 1, 0]]))


# --------------------------------------------------------------------------
# per-step varlen forward (decode kernel at Sq = 1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("sq", [128, 1])
@pytest.mark.parametrize("mask", MASKS)
def test_flash_plain_matches_interpret_kernel(mask, sq, d):
    rng = np.random.default_rng(21)
    h, kh, sk = 4, 2, 256
    q = rng.normal(size=(h, sq, d)).astype(np.float32)
    k = rng.normal(size=(kh, sk, d)).astype(np.float32)
    v = rng.normal(size=(kh, sk, d)).astype(np.float32)
    seg_k, pos_k = _stream_meta(rng, sk, 3)
    # q rows are the tail of the kv stream (causal masking bites); row
    # 0 is a padding row: fully masked
    seg_q, pos_q = seg_k[sk - sq - 30:sk - 30].copy(), \
        pos_k[sk - sq - 30:sk - 30].copy()
    seg_q[0] = -1
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k)
    jo, jl = jfa.flash_attention_fwd(
        *map(jnp.asarray, args), mask=jmasks.parse_mask(mask),
        block_q=min(128, sq), block_k=128, interpret=True)
    to, tl = tops.block_attention(*map(_t, args),
                                  mask=tmasks.parse_mask(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    live = np.asarray(jl) > -1e29
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=1e-5, rtol=1e-5)
    assert np.all(to.numpy()[:, 0] == 0) and np.all(tl.numpy()[:, 0]
                                                    == -1e30)
    assert tfa.flash_attention_fwd.launches == 0


def test_flash_plain_batched_strided_cache():
    """The decode layout: q [B, H, 1, D] against a [B, S, KH, D] cache
    passed as a strided view, per-row lengths; equal to per-row calls."""
    rng = np.random.default_rng(22)
    B, S, KH, H, D = 3, 40, 2, 4, 32
    cache_k = _t(rng.normal(size=(B, S, KH, D)).astype(np.float32))
    cache_v = _t(rng.normal(size=(B, S, KH, D)).astype(np.float32))
    q = _t(rng.normal(size=(B, H, 1, D)).astype(np.float32))
    lengths = torch.tensor([1, 17, 40])
    pos = torch.arange(S, dtype=torch.int32)
    seg = torch.where(pos[None] < lengths[:, None], 0, -1).int()
    zero = torch.zeros(1, dtype=torch.int32)
    o, lse = tfa.flash_attention_fwd(q, cache_k.transpose(1, 2),
                                     cache_v.transpose(1, 2), zero, zero,
                                     seg, pos.expand(B, S).contiguous(),
                                     mask=False)
    for b in range(B):
        ob, lb = tref.reference_attention(
            q[b], cache_k[b].transpose(0, 1), cache_v[b].transpose(0, 1),
            zero, zero, seg[b], pos, mask=False)
        torch.testing.assert_close(o[b], ob, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(lse[b], lb, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask", MASKS)
def test_oracles_match_reference(mask):
    rng = np.random.default_rng(31)
    h, kh, sq, sk, d = 4, 2, 96, 200, 32
    q = rng.normal(size=(h, sq, d)).astype(np.float32)
    k = rng.normal(size=(kh, sk, d)).astype(np.float32)
    v = rng.normal(size=(kh, sk, d)).astype(np.float32)
    seg_k, pos_k = _stream_meta(rng, sk, 2)
    seg_q, pos_q = seg_k[-sq:].copy(), pos_k[-sq:].copy()
    args = (q, k, v, seg_q, pos_q, seg_k, pos_k)
    jm, tm = jmasks.parse_mask(mask), tmasks.parse_mask(mask)
    np.testing.assert_array_equal(
        tref.mask_matrix(*map(_t, args[3:]), tm).numpy(),
        np.asarray(jref.mask_matrix(*map(jnp.asarray, args[3:]), jm)))
    for jfn, tfn, kw in ((jref.reference_attention,
                          tref.reference_attention, {}),
                         (jref.chunked_attention, tref.chunked_attention,
                          {"chunk": 64})):
        jo, jl = jfn(*map(jnp.asarray, args), jm, **kw)
        to, tl = tfn(*map(_t, args), tm, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
    # merges of disjoint partials
    oa, la = jref.reference_attention(*map(jnp.asarray, args), jm)
    parts = [rng.normal(size=(3, h, sq, d)).astype(np.float32),
             (rng.normal(size=(3, h, sq)) * 3).astype(np.float32)]
    jo, jl = jref.merge_many(*map(jnp.asarray, parts))
    to, tl = tref.merge_many(*map(_t, parts))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    jo, jl = jref.merge_partials(oa, la, jnp.asarray(parts[0][0]),
                                 jnp.asarray(parts[1][0]))
    to, tl = tref.merge_partials(_t(oa), _t(la), _t(parts[0][0]),
                                 _t(parts[1][0]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


# --------------------------------------------------------------------------
# backward kernels and autograd Functions
# --------------------------------------------------------------------------

def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _bwd_order(tabs):
    """The reference's kv-sorted backward tables (``np.lexsort``)."""
    order = np.lexsort((tabs["step_q"], tabs["step_kv"]))
    return dict(bwd_q=tabs["step_q"][order], bwd_kv=tabs["step_kv"][order],
                k_seg_b=tabs["k_seg"][order], k_pos_b=tabs["k_pos"][order])


@pytest.mark.parametrize("d", [32, 80, 128])
@pytest.mark.parametrize("mask", ["causal", "swa:40"])
def test_fused_bwd_plain_matches_interpret_kernels(mask, d):
    """Kernels 3 and 4 (plain versions) against ``fused_flash_bwd_dq`` /
    ``fused_flash_bwd_dkv`` in interpret mode: shared kv rows (dkv
    revisits), an incoming accumulator, a fully masked row, a trash
    step, GQA; the window edge falls mid-tile."""
    rng = np.random.default_rng(41)
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng, bs=64, d=d)
    jm, tm = jmasks.parse_mask(mask), tmasks.parse_mask(mask)
    _, l2 = jops.fused_run_attention(
        *map(jnp.asarray, (qs, kxt, vxt, acc_o, acc_lse)),
        {k: jnp.asarray(v) for k, v in tabs.items()}, mask=jm,
        impl="pallas", block_q=64, block_k=64, interpret=True)
    l2 = np.asarray(l2)
    go = rng.normal(size=qs.shape).astype(np.float32)
    delta = rng.normal(size=l2.shape).astype(np.float32)
    bwd = _bwd_order(tabs)
    common = (qs, kxt, vxt, tabs["q_seg"], tabs["q_pos"])
    fwd_t = (tabs["step_q"], tabs["step_kv"])
    meta_f = (tabs["k_seg"], tabs["k_pos"])
    bwd_t = (bwd["bwd_q"], bwd["bwd_kv"])
    meta_b = (bwd["k_seg_b"], bwd["k_pos_b"])
    grads = (l2, go, delta)
    kw = dict(mask=jm, block_q=64, block_k=64, interpret=True)
    jdq = jfa.fused_flash_bwd_dq(*map(jnp.asarray,
                                      fwd_t + common + meta_f + grads), **kw)
    jdk, jdv = jfa.fused_flash_bwd_dkv(
        *map(jnp.asarray, bwd_t + common + meta_b + grads), **kw)
    tdq = tfa.fused_flash_bwd_dq(*map(_t, fwd_t + common + meta_f + grads),
                                 mask=tm)
    tdk, tdv = tfa.fused_flash_bwd_dkv(
        *map(_t, bwd_t + common + meta_b + grads), mask=tm)
    vis = [0, 1, 2]                   # slot 3 unvisited, slot 4 trash
    assert _nerr(tdq[vis], np.asarray(jdq)[vis]) <= 1e-5
    assert not tdq[3].any()           # unvisited: zero (visited mask)
    rows = [0, 1, 2]                  # rows 3, 4 unread, row 5 trash
    for t_, j_ in ((tdk, jdk), (tdv, jdv)):
        assert _nerr(t_[rows], np.asarray(j_)[rows]) <= 1e-5
        assert not t_[3:5].any()
    assert tfa.fused_flash_bwd_dq.launches == 0     # CPU: plain version
    assert tfa.fused_flash_bwd_dkv.launches == 0


@pytest.mark.parametrize("d", [32, 80, 128])
@pytest.mark.parametrize("mask", ["chunked:48", "full"])
def test_flash_bwd_plain_matches_interpret_kernel(mask, d):
    """Kernels 5 and 6 (plain version) against ``flash_attention_bwd`` in
    interpret mode, with a non-zero ``dlse`` (the merge case) and GQA
    (H = 2 KH: dk/dv sum over the group)."""
    rng = np.random.default_rng(51)
    h, kh, sq, sk = 4, 2, 64, 128
    q = rng.normal(size=(h, sq, d)).astype(np.float32)
    k = rng.normal(size=(kh, sk, d)).astype(np.float32)
    v = rng.normal(size=(kh, sk, d)).astype(np.float32)
    seg_k, pos_k = _stream_meta(rng, sk, 3)
    seg_q, pos_q = seg_k[sk - sq:].copy(), pos_k[sk - sq:].copy()
    seg_q[3] = -1                                    # fully masked row
    jm, tm = jmasks.parse_mask(mask), tmasks.parse_mask(mask)
    meta = (seg_q, pos_q, seg_k, pos_k)
    o, lse = jfa.flash_attention_fwd(
        *map(jnp.asarray, (q, k, v) + meta), mask=jm, block_q=64,
        block_k=64, interpret=True)
    do = rng.normal(size=q.shape).astype(np.float32)
    dlse = rng.normal(size=(h, sq)).astype(np.float32)
    args = (q, k, v) + meta + (np.asarray(o), np.asarray(lse), do, dlse)
    jg = jfa.flash_attention_bwd(*map(jnp.asarray, args), mask=jm,
                                 block_q=64, block_k=64, interpret=True)
    tg = tfa.flash_attention_bwd(*map(_t, args), mask=tm)
    for a, b in zip(tg, jg):
        assert a.dtype == torch.float32
        assert _nerr(a, b) <= 1e-5
    assert tfa.flash_attention_bwd_dq.launches == 0
    assert tfa.flash_attention_bwd_dkv.launches == 0


# the rule chip_smoke.compare_grad holds kernels 3-6 to on the card
TOL_GRAD = 1e-4


def _split(x):
    """f32 ``x`` -> ``(bf16(x), bf16(x - hi))``, both held in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm_split(a, b, split_a: bool, split_b: bool):
    """``a @ b`` as ``csrc/flash_attention_bwd.cu`` takes it on the tensor
    cores: a split operand becomes hi + lo, a product of bf16 values is
    exact in the f32 sum, and lo . lo is dropped (1, 2 or 3 products)."""
    ah, al = _split(a) if split_a else (a, None)
    bh, bl = _split(b) if split_b else (b, None)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def _grad_err(a, b, bf16_out: bool) -> float:
    """``chip_smoke.compare_grad``'s error: max |a - b| over max |b|,
    less one bf16 ulp of each value (2**-7 of it) for bf16 outputs."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if bf16_out:
        diff = torch.clamp(diff - 2.0 ** -7 * b.abs(), min=0.0)
    return float(diff.max()) / float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_bf16_scheme_meets_tol_grad(dtype):
    """The precision contract of kernels 5 and 6: every product on bf16
    tensor cores, each f32 operand (do, p, ds; q/k/v when f32) split into
    bf16 hi and lo, partial products summed in f32 — emulated here in
    plain PyTorch and held to TOL_GRAD against
    ``flash_attention_bwd_plain`` (f32 products), as the card's check
    holds the kernels; for bf16 inputs also the f32 sums before the
    outputs round to bf16, with no allowance (the f32-weight gradients
    have none)."""
    rng = np.random.default_rng(71)
    h, kh, s, d = 4, 2, 128, 64
    q, k, v = (torch.tensor(rng.normal(size=(1, n, s, d)), dtype=dtype)
               for n in (h, kh, kh))
    seg = np.zeros((1, s), np.int32)
    seg[0, 77:] = 1                                  # a segment boundary
    pos = np.concatenate([np.arange(77), np.arange(s - 77)])[None]
    meta = [torch.from_numpy(x.astype(np.int32)) for x in (seg, pos) * 2]
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, *meta, mask="causal")
    do = torch.tensor(rng.normal(size=o.shape), dtype=torch.float32)
    dlse = torch.tensor(rng.normal(size=lse.shape), dtype=torch.float32)
    args = (q, k, v, *meta, o, lse, do, dlse)

    exact = dtype == torch.bfloat16                  # q/k/v need no split
    kx, vx = (torch.repeat_interleave(x.float(), h // kh, dim=1)
              for x in (k, v))
    qf = q.float()
    valid = tref.mask_matrix(*meta, tmasks.parse_mask("causal"))[:, None]
    scale = d ** -0.5
    sc = _mm_split(qf, kx.transpose(-1, -2), not exact, not exact)
    p = torch.where(valid, torch.exp(sc * scale - lse[..., None]), 0.0)
    dp = _mm_split(do, vx.transpose(-1, -2), True, not exact)
    ds = p * (((dp - tfa._delta(o, do)[..., None]) + dlse[..., None])
              * scale)
    dq = _mm_split(ds, kx, True, not exact)
    dk = _mm_split(ds.transpose(-1, -2), qf, True, not exact)
    dv = _mm_split(p.transpose(-1, -2), do, True, True)
    dk, dv = (x.reshape(1, kh, h // kh, s, d).sum(2) for x in (dk, dv))

    want = tfa.flash_attention_bwd_plain(*args, mask="causal")
    for got, ref_ in zip((dq, dk, dv), want):
        assert ref_.dtype == dtype
        assert _grad_err(got.to(dtype), ref_, exact) <= TOL_GRAD
    # the split is what passes: one bf16 rounding of ds misses the bound
    one_pass = ds.to(torch.bfloat16).float() @ kx.to(torch.bfloat16).float()
    assert _grad_err(one_pass.to(dtype), want[0], exact) > 3 * TOL_GRAD
    if exact:
        p_, ds_, qf_, kx_, g_ = tfa._flash_bwd_terms(*args, "causal", None)
        f32 = (ds_ @ kx_,
               (ds_.transpose(-1, -2) @ qf_).reshape(1, kh, -1, s, d).sum(2),
               (p_.transpose(-1, -2) @ g_).reshape(1, kh, -1, s, d).sum(2))
        for got, ref_ in zip((dq, dk, dv), f32):
            assert _grad_err(got, ref_, False) <= TOL_GRAD


def _fused_bwd_tiles(step_q, step_kv, qs, kxt, vxt, q_seg, q_pos, k_seg,
                     k_pos, lse, go, delta, exact, one_pass=False):
    """Kernels 3 and 4 (``fused_flash_bwd_dq.cu``, ``fused_flash_bwd_dkv.cu``)
    in plain PyTorch: per step, dq over 64-key tiles and dk / dv over the
    GQA members' 64-row q tiles, each summed in f32 into its slot / row in
    the kernels' order; g_o, p and ds split into bf16 hi + lo (S = Q.K^T 1
    product, dP, dS.K and dS^T.Q 2, P^T.dO 3; q/k/v split too for f32
    inputs), ``delta`` carrying -g_lse and no dlse, f32 outputs.  Steps
    on the trash slot are skipped, as the segment tables skip them.
    ``one_pass`` rounds ds and k to bf16 once for dS.K instead."""
    SL, H, bs, d = qs.shape
    KH = kxt.shape[1]
    group, scale = H // KH, d ** -0.5
    dq = torch.zeros((SL, H, bs, d))
    dk = torch.zeros((kxt.shape[0], KH, bs, d))
    dv = torch.zeros_like(dk)
    for s_, (sq, skv) in enumerate(zip(step_q.tolist(), step_kv.tolist())):
        if sq == SL - 1:
            continue
        q, g = qs[sq].float(), go[sq]
        k, v = (torch.repeat_interleave(x[skv].float(), group, 0)
                for x in (kxt, vxt))
        valid = tref.mask_matrix(q_seg[sq], q_pos[sq], k_seg[s_], k_pos[s_],
                                 True)
        L, De = lse[sq][..., None], delta[sq][..., None]

        def terms(q_, g_, k_, v_, valid_, L_, De_):
            sc = _mm_split(q_, k_.transpose(-1, -2), not exact, not exact)
            p = torch.where(valid_, torch.exp(sc * scale - L_), 0.0)
            dp = _mm_split(g_, v_.transpose(-1, -2), True, not exact)
            return p, p * ((dp - De_) * scale)
        for j0 in range(0, bs, 64):                  # kernel 3: key tiles
            kt, vt = k[:, j0:j0 + 64], v[:, j0:j0 + 64]
            _, ds = terms(q, g, kt, vt, valid[:, j0:j0 + 64], L, De)
            if one_pass:
                dq[sq] += ds.to(torch.bfloat16).float() @ kt.to(
                    torch.bfloat16).float()
            else:
                dq[sq] += _mm_split(ds, kt, True, not exact)
        for m in range(group):                       # kernel 4: q tiles
            hs = [kh * group + m for kh in range(KH)]    # member m's heads
            for i0 in range(0, bs, 64):
                qt, gt = q[hs, i0:i0 + 64], g[hs, i0:i0 + 64]
                p, ds = terms(qt, gt, k[hs], v[hs], valid[i0:i0 + 64],
                              L[hs, i0:i0 + 64], De[hs, i0:i0 + 64])
                dv[skv] += _mm_split(p.transpose(-1, -2), gt, True, True)
                dk[skv] += _mm_split(ds.transpose(-1, -2), qt, True,
                                     not exact)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_bf16_fused_scheme_meets_tol_grad(dtype):
    """The precision contract of kernels 3 and 4 (the fused run's
    backward on the shared tiles of kernels 5 and 6), emulated in plain
    PyTorch over a run where q slot 2 spans three steps and kv rows 0 and
    1 each feed two q slots, and held to TOL_GRAD against
    ``fused_flash_bwd_{dq,dkv}_plain`` (f32 products).  A one-pass bf16
    ds misses the bound: the split is what passes."""
    rng = np.random.default_rng(73)
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng, d=64)
    t = {n: _t(x) for n, x in tabs.items()}
    assert (tabs["step_q"] == 2).sum() >= 3
    qs, kxt, vxt = (torch.tensor(x, dtype=dtype) for x in (qs, kxt, vxt))
    o2, l2 = tfa.fused_flash_fwd_plain(
        t["step_q"], t["step_kv"], qs, kxt, vxt, t["q_seg"], t["q_pos"],
        t["k_seg"], t["k_pos"], _t(acc_o), _t(acc_lse), mask=True)
    go = _t(rng.normal(size=o2.shape).astype(np.float32))
    g_lse = _t(rng.normal(size=l2.shape).astype(np.float32))
    delta = (go * o2).sum(-1) - g_lse
    common = (qs, kxt, vxt, t["q_seg"], t["q_pos"])
    grads = (l2, go, delta)
    bwd = {n: _t(x) for n, x in _bwd_order(tabs).items()}
    want_dq = tfa.fused_flash_bwd_dq_plain(
        t["step_q"], t["step_kv"], *common, t["k_seg"], t["k_pos"], *grads)
    want_dk, want_dv = tfa.fused_flash_bwd_dkv_plain(
        bwd["bwd_q"], bwd["bwd_kv"], *common, bwd["k_seg_b"],
        bwd["k_pos_b"], *grads)
    args = (t["step_q"], t["step_kv"], *common, t["k_seg"], t["k_pos"],
            *grads)
    exact = dtype == torch.bfloat16
    dq, dk, dv = _fused_bwd_tiles(*args, exact)
    vis, rows = [0, 1, 2], [0, 1, 2]    # slot 3 unvisited, 4 trash; kv 5
    for got, ref_ in ((dq[vis], want_dq[vis]), (dk[rows], want_dk[rows]),
                      (dv[rows], want_dv[rows])):
        assert got.dtype == ref_.dtype == torch.float32
        assert _grad_err(got, ref_, False) <= TOL_GRAD
    one_dq = _fused_bwd_tiles(*args, exact, one_pass=True)[0]
    assert _grad_err(one_dq[vis], want_dq[vis], False) > 3 * TOL_GRAD


# chip_smoke.compare's rule for kernels 1 and 2 on the card
TOL_O = 1e-4
TOL_LSE = 1e-4
_LOG2E = 1.4426950408889634


def _fwd_err(o, lse, o_ref, lse_ref):
    """``chip_smoke.compare``'s errors: max |o - o_ref| over max(max
    |o_ref|, 1), and max |lse - lse_ref| on live rows."""
    live = lse_ref > -1e29
    err_o = float((o - o_ref).abs().max()) / max(
        float(o_ref.abs().max()), 1.0)
    err_l = float((lse - lse_ref)[live].abs().max())
    return err_o, err_l


def _split_trunc(x):
    """``split2_trunc`` of ``csrc/attn_mma.cuh``: hi = ``x`` truncated to
    bf16 (its upper 16 bits), lo = bf16(x - hi), both held in f32."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def _fwd_tiles(q, k, v, valid, scale, exact, seed=None, one_pass=False):
    """The forward tile of ``csrc/attn_mma.cuh`` in plain PyTorch: 64-key
    tiles, the online softmax in f32 in log2 units, S = Q.K^T split for f32
    inputs (3 products), P split into a truncated bf16 hi + a rounded lo
    for P.V (2 products; 3 with f32 V).  ``seed = (o_in, lse_in)`` seeds
    ``(acc, m, l) = (o_in, lse_in, 1)`` (kernel 1); ``one_pass`` rounds P
    to bf16 once instead."""
    sl2 = scale * _LOG2E
    shape = q.shape[:-1]
    if seed is None:
        acc = torch.zeros(q.shape)
        m = torch.full(shape, -1e30)
        l = torch.zeros(shape)
    else:
        acc, m, l = seed[0].clone(), seed[1] * _LOG2E, torch.ones(shape)
    for j0 in range(0, k.shape[-2], 64):
        kt, vt = k[..., j0:j0 + 64, :], v[..., j0:j0 + 64, :]
        s = _mm_split(q, kt.transpose(-1, -2), not exact, not exact)
        x = torch.where(valid[..., j0:j0 + 64], s, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x * sl2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if one_pass:
            pv = p.to(torch.bfloat16).float() @ vt
        else:
            ph, pl = _split_trunc(p)
            vh, vl = _split(vt) if not exact else (vt, None)
            pv = ph @ vh + pl @ vh + (ph @ vl if vl is not None else 0.0)
        acc = acc * alpha[..., None] + pv
        m = m_new
    live = l > 0
    safe = torch.where(live, l, 1.0)
    o = torch.where(live[..., None], acc / safe[..., None], 0.0)
    lse = torch.where(live, m / _LOG2E + torch.log(safe), -1e30)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_bf16_fwd_scheme_meets_tol(dtype):
    """The precision contract of kernels 1 and 2 (the shared forward tile):
    every product on bf16 tensor cores with f32 sums, Q.K^T split only for
    f32 inputs, P always split — emulated in plain PyTorch and held to
    TOL_O / TOL_LSE against ``flash_attention_fwd_plain`` (a ragged Sk, a
    fully masked row, GQA) and ``fused_flash_fwd_plain`` (a seeded
    accumulator, several steps of one slot).  A one-pass bf16 P misses the
    bound: the split is what passes."""
    rng = np.random.default_rng(72)
    exact = dtype == torch.bfloat16
    h, kh, sq, sk, d = 4, 2, 72, 200, 64
    q, k, v = (torch.tensor(rng.normal(size=(1, n, s_, d)), dtype=dtype)
               for n, s_ in ((h, sq), (kh, sk), (kh, sk)))
    seg_k, pos_k = _stream_meta(rng, sk, 3)
    seg_q, pos_q = seg_k[-sq:].copy(), pos_k[-sq:].copy()
    seg_q[5] = -1                                    # a fully masked row
    meta = [torch.from_numpy(x[None]) for x in (seg_q, pos_q, seg_k, pos_k)]
    want = tfa.flash_attention_fwd_plain(q, k, v, *meta, mask="causal")
    valid = tref.mask_matrix(*meta, tmasks.parse_mask("causal"))[:, None]
    kx, vx = (torch.repeat_interleave(x.float(), h // kh, dim=1)
              for x in (k, v))
    got = _fwd_tiles(q.float(), kx, vx, valid, d ** -0.5, exact)
    err_o, err_l = _fwd_err(*got, *want)
    assert err_o <= TOL_O and err_l <= TOL_LSE
    assert torch.equal(got[0][0, :, 5], want[0][0, :, 5])      # o = 0
    one = _fwd_tiles(q.float(), kx, vx, valid, d ** -0.5, exact,
                     one_pass=True)
    assert _fwd_err(*one, *want)[0] > 3 * TOL_O

    # kernel 1: slot 2 of _fused_inputs, seeded, over three steps
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng)
    acc_o[2] = rng.normal(size=acc_o[2].shape)
    acc_lse[2] = rng.normal(size=acc_lse[2].shape) + 5
    qs, kxt, vxt = (torch.tensor(x, dtype=dtype) for x in (qs, kxt, vxt))
    t = {n: _t(x) for n, x in tabs.items()}
    po, pl = tfa.fused_flash_fwd_plain(
        t["step_q"], t["step_kv"], qs, kxt, vxt, t["q_seg"], t["q_pos"],
        t["k_seg"], t["k_pos"], _t(acc_o), _t(acc_lse), mask=True)
    steps = [i for i, x in enumerate(tabs["step_q"]) if x == 2]
    kv = [int(tabs["step_kv"][i]) for i in steps]
    group = qs.shape[1] // kxt.shape[1]
    kf, vf = (torch.cat([torch.repeat_interleave(x[j].float(), group, 0)
                         for j in kv], dim=-2) for x in (kxt, vxt))
    vm = torch.cat([tref.mask_matrix(t["q_seg"][2], t["q_pos"][2],
                                     t["k_seg"][i], t["k_pos"][i], True)
                    for i in steps], dim=-1)[None]
    d = qs.shape[-1]
    got = _fwd_tiles(qs[2].float(), kf, vf, vm, d ** -0.5, exact,
                     seed=(_t(acc_o[2]), _t(acc_lse[2])))
    err_o, err_l = _fwd_err(*got, po[2], pl[2])
    assert err_o <= TOL_O and err_l <= TOL_LSE


def test_decode_split_merge_matches_plain():
    """The decode variant's arithmetic: per split of DECODE_SPLIT keys an
    unnormalized partial (acc, m, l) in f32 (l = 0 for a split with no
    valid key, whose acc is never read), merged in split order, equals
    ``flash_attention_fwd_plain`` to 1e-6.  Rows of length 0, 1, a split
    size -1, +0 and +1, and one spanning several splits, over a strided
    ``[B, S, KH, D]`` cache view; a group of 4 query heads."""
    rng = np.random.default_rng(73)
    lengths = np.array([0, 1, 255, 256, 257, 700])
    B, S, KH, H, D = len(lengths), 800, 2, 8, 32
    ck, cv = (torch.tensor(rng.normal(size=(B, S, KH, D)),
                           dtype=torch.float32) for _ in range(2))
    q = torch.tensor(rng.normal(size=(B, H, 1, D)), dtype=torch.float32)
    pos = torch.arange(S, dtype=torch.int32)
    seg = torch.where(pos[None] < torch.tensor(lengths)[:, None], 0,
                      -1).int()
    zero = torch.zeros(1, dtype=torch.int32)
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    want = tfa.flash_attention_fwd_plain(q, k, v, zero, zero, seg,
                                         pos.expand(B, S), mask=False)
    ns = tfa.decode_splits(S)
    assert ns == 4
    kx, vx = (torch.repeat_interleave(x, H // KH, dim=1) for x in (k, v))
    sl2 = D ** -0.5 * _LOG2E
    parts = []
    for i in range(ns):
        lo, hi = i * tfa.DECODE_SPLIT, min(S, (i + 1) * tfa.DECODE_SPLIT)
        x = (q @ kx[:, :, lo:hi].transpose(-1, -2)) * sl2
        x = torch.where((seg[:, None, None, lo:hi] == 0), x, -torch.inf)
        m = x.amax(-1)
        p = torch.where(m[..., None] > -torch.inf,
                        torch.exp2(x - m[..., None]), 0.0)
        parts.append((p @ vx[:, :, lo:hi], m, p.sum(-1)))
    M = torch.full(q.shape[:-1], -torch.inf)
    for _, m, l in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for a, m, l in parts:                            # split order
        w = torch.where(l > 0, torch.exp2(m - M), 0.0)
        L = L + l * w
        acc = acc + torch.where(l[..., None] > 0, a, 0.0) * w[..., None]
    live = L > 0
    o = torch.where(live[..., None], acc / torch.where(live, L, 1.0)[
        ..., None], 0.0)
    lse = torch.where(live, M / _LOG2E + torch.log(torch.where(live, L, 1.0)),
                      -1e30)
    assert not live[0].any() and live[1:].all()      # length 0: empty row
    assert float((o - want[0]).abs().max()) <= 1e-6
    assert float((lse - want[1])[live].abs().max()) <= 1e-6
    assert torch.equal(o[0], want[0][0]) and bool((lse[0] == -1e30).all())


def test_fwd_variant_and_splits():
    """The wrapper's host-side rule: up to DECODE_MAX_SQ query rows the
    split-KV decode variant, above it the tiled one; the decode variant's
    splits cover the keys in DECODE_SPLIT steps (0 for no keys)."""
    assert tfa.fwd_variant(1) == "decode"
    assert tfa.fwd_variant(tfa.DECODE_MAX_SQ) == "decode"
    assert tfa.fwd_variant(tfa.DECODE_MAX_SQ + 1) == "tiled"
    assert tfa.fwd_variant(512) == "tiled"
    n = tfa.DECODE_SPLIT
    assert [tfa.decode_splits(x) for x in (0, 1, n - 1, n, n + 1, 2048)] \
        == [0, 1, 1, 1, 2, 2048 // n]


def test_fused_run_function_matches_jax_grad():
    """``_FusedRun`` backward (through ``ops.fused_run_attention``)
    against ``jax.grad`` of the reference's fused Pallas op: grads of qs,
    kxt, vxt, and of the incoming accumulator on its live rows."""
    rng = np.random.default_rng(61)
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng, bs=64)
    key_o = rng.normal(size=qs.shape).astype(np.float32)
    key_l = rng.normal(size=acc_lse.shape).astype(np.float32)
    tabs = {**tabs, **_bwd_order(tabs)}
    jtabs = {k: jnp.asarray(v) for k, v in tabs.items()}

    def jloss(*xs):
        o2, l2 = jops.fused_run_attention(*xs, jtabs, mask=True,
                                          impl="pallas", block_q=64,
                                          block_k=64, interpret=True)
        return (jnp.sum(o2 * key_o)
                + jnp.sum(jnp.where(l2 > -1e29, l2 * key_l, 0.0)))

    args = (qs, kxt, vxt, acc_o, acc_lse)
    jg = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    xs = [_t(x).requires_grad_(True) for x in args]
    o2, l2 = tops.fused_run_attention(*xs, {k: _t(v)
                                            for k, v in tabs.items()})
    loss = (o2 * _t(key_o)).sum() + torch.where(
        l2 > -1e29, l2 * _t(key_l), 0.0).sum()
    tg = torch.autograd.grad(loss, xs)
    for i, last in ((0, 4), (1, 5), (2, 5)):   # drop trash slot / kv row
        assert _nerr(tg[i][:last], np.asarray(jg[i])[:last]) <= 1e-5
    live = acc_lse > -1e29
    assert _nerr(tg[3].numpy()[live], np.asarray(jg[3])[live]) <= 1e-5
    assert _nerr(tg[4].numpy()[live], np.asarray(jg[4])[live]) <= 1e-5


@pytest.mark.parametrize("d", [24, 48])
def test_wrappers_refuse_unbuilt_head_dims(d):
    """The CUDA kernels are built for ``HEAD_DIMS`` (16, 32, 64, 80,
    128): the launch checks of kernels 2-6 refuse another head dim (24
    or 48, which no config uses) before any launch, with the message
    the card shows."""
    assert d not in tfa.HEAD_DIMS and 16 in tfa.HEAD_DIMS
    rng = np.random.default_rng(61)
    msg = f"head_dim {d} not in"
    q, k = (_t(rng.normal(size=(1, 2, 64, d)).astype(np.float32))
            for _ in range(2))
    meta = torch.zeros(64, dtype=torch.int32)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match=msg):
        tfa._flash_fwd_prep(q, k, k, meta, meta, meta, meta, True, None)
    with pytest.raises(ValueError, match=msg):
        tfa._flash_bwd_prep(q, k, k, meta, meta, meta, meta, q, lse, q, lse,
                            True, None)
    qs, kxt, vxt, acc_o, acc_lse, tabs = _fused_inputs(rng, bs=64, d=d)
    tabs = {k_: _t(v)[None] for k_, v in tabs.items()}
    ins = [_t(x)[None] for x in (qs, kxt, vxt, acc_lse, acc_o, acc_lse)]
    for name in ("fused_flash_bwd_dq", "fused_flash_bwd_dkv"):
        with pytest.raises(ValueError, match=msg):
            tfa._check_fused(name, tabs["step_q"], tabs["step_kv"],
                             *ins[:3], tabs["q_seg"], tabs["q_pos"],
                             tabs["k_seg"], tabs["k_pos"], *ins[3:])
    assert 80 in tfa.HEAD_DIMS and 128 in tfa.HEAD_DIMS


def test_kernel_impl_rejects_unknown():
    with pytest.raises(ValueError, match="impl"):
        tops.block_attention(*[torch.zeros(1)] * 7, impl="xla")
    jax.clear_caches()
