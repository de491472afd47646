"""The port's SSM family (``repro_torch.models.ssm`` and the pure-Mamba2
model of the registry) against the reference on the CPU: the chunked SSD
scan (resets mid-chunk, a padded tail, a batch of sequences), one Mamba2
block with its prefill state, the recurrent decode step against the
block, and the mamba2-130m smoke model's forward and decode on the same
weights (``params_from_numpy``).

Tolerances: f32 throughout; the SSD scan and the forward 1e-5 relative
to the largest reference value (the inter-chunk recurrence is a loop
here and an associative scan there: the same sums in another order), the
decode step against the block 1e-5 (a recurrence against the chunked
form of the same function)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch.configs.base import smoke_config
from repro_torch.models import Model
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from test_torch_threads import intra_op_share  # noqa: F401


TOL = 1e-5


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan_inputs(rng, s, nh=3, hd=4, ds=5, resets=(40, 77)):
    x = rng.normal(size=(s, nh, hd)).astype(np.float32)
    a = -rng.uniform(0.05, 1.0, size=(s, nh)).astype(np.float32)
    a[list(resets)] = ssm.RESET_LOG_DECAY          # documents start here
    B = rng.normal(size=(s, ds)).astype(np.float32)
    C = rng.normal(size=(s, ds)).astype(np.float32)
    return x, a, B, C


@pytest.mark.parametrize("s,chunk", [(128, 32), (150, 64), (150, 256)])
def test_ssd_scan_matches_reference(s, chunk):
    """Resets mid-chunk; 150 tokens leave a padded tail.  A padded
    sequence's final state passes through the padding's resets, in both
    packages (it is ~0)."""
    x, a, B, C = _scan_inputs(np.random.default_rng(s + chunk), s)
    jy, jst = jssm.ssd_scan(*map(jnp.asarray, (x, a, B, C)), chunk)
    ty, tst = ssm.ssd_scan(*(_t(v)[None] for v in (x, a, B, C)), chunk)
    assert ty.shape == (1, s, 3, 4) and tst.shape == (1, 3, 4, 5)
    assert _nerr(ty[0], jy) <= TOL
    assert _nerr(tst[0], jst) <= TOL
    if s % chunk:
        assert float(tst.abs().max()) < 1e-12


def test_ssd_scan_batches_sequences():
    """A batch of sequences in one call equals one call per sequence."""
    rng = np.random.default_rng(3)
    seqs = [_scan_inputs(rng, 96, resets=(10 * i + 5,)) for i in range(3)]
    batched = [torch.stack([_t(sq[i]) for sq in seqs]) for i in range(4)]
    y, st = ssm.ssd_scan(*batched, 32)
    for i, sq in enumerate(seqs):
        yi, sti = ssm.ssd_scan(*(_t(v)[None] for v in sq), 32)
        torch.testing.assert_close(y[i], yi[0], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(st[i], sti[0], atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(j_smoke("mamba2_130m"), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config("mamba2_130m"),
                              param_dtype="float32")
    jparams = jax.device_get(JModel(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(5)
    # non-trivial conv bias and step bias (the init's are zero)
    for name in ("conv_b", "dt_bias"):
        leaf = jparams["mamba"][name]
        jparams["mamba"][name] = (rng.normal(size=leaf.shape) * 0.1).astype(
            np.float32)
    return jcfg, cfg, jparams, params_from_numpy(jparams, "cpu")


def _layer(params, i):
    return {k: v[i] for k, v in params["mamba"].items()}


def test_mamba_block_with_state_matches_reference(smoke):
    """Two documents (a reset mid-chunk) and a padded tail: the block's
    output, final state and conv tail."""
    jcfg, cfg, jparams, tparams = smoke
    rng = np.random.default_rng(6)
    x = rng.normal(size=(100, cfg.d_model)).astype(np.float32)
    pos = np.concatenate([np.arange(30), np.arange(70)]).astype(np.int32)
    jo, (jst, jcv) = jssm.mamba_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                         _layer(jparams, 0).items()}, jcfg, jnp.asarray(pos),
        return_state=True)
    to, (tst, tcv) = ssm.mamba_block(_t(x)[None], _layer(tparams, 0), cfg,
                                     _t(pos)[None], return_state=True)
    assert _nerr(to[0], jo) <= TOL
    assert _nerr(tst[0], jst) <= TOL
    assert _nerr(tcv[0], jcv) <= TOL
    assert tcv.shape == (1, cfg.ssm_conv - 1, tcv.shape[-1])


def test_decode_steps_match_block(smoke):
    """The recurrent step, token by token from a zero cache, gives the
    block's outputs and (at a whole number of chunks) its final state and
    conv tail; the reference's step agrees on the way."""
    jcfg, cfg, jparams, tparams = smoke
    lp = _layer(tparams, 1)
    jlp = {k: jnp.asarray(v) for k, v in _layer(jparams, 1).items()}
    s = cfg.ssm_chunk
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    out, (st_b, cv_b) = ssm.mamba_block(_t(x), lp, cfg, _t(pos),
                                        return_state=True)
    cache = ssm.init_ssm_cache(cfg, 1, 2, device="cpu")
    st, cv = cache["state"][0], cache["conv"][0]
    jst, jcv = jnp.asarray(st.numpy()), jnp.asarray(cv.numpy())
    for t in range(s):
        y, st, cv = ssm.mamba_decode_step(_t(x[:, t]), lp, st, cv, cfg)
        assert _nerr(y, out[:, t]) <= TOL
        if t < 8:
            jy, jst, jcv = jssm.mamba_decode_step(jnp.asarray(x[:, t]), jlp,
                                                  jst, jcv, jcfg)
            assert _nerr(y, jy) <= TOL and _nerr(st, jst) <= TOL
    assert _nerr(st, st_b) <= TOL
    torch.testing.assert_close(cv, cv_b, atol=0, rtol=0)


def test_mamba2_model_matches_reference(smoke):
    """mamba2-130m smoke (tied embeddings): the packed-stream forward over
    four frames with resets, then three decode steps from the reference's
    initial cache."""
    jcfg, cfg, jparams, tparams = smoke
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, (4, 48)).astype(np.int32)
    pos = np.tile(np.concatenate([np.arange(20), np.arange(28)]),
                  (4, 1)).astype(np.int32)
    jmodel, model = JModel(jcfg), Model(cfg)
    jp = jax.tree.map(jnp.asarray, jparams)
    jl = jmodel.forward(jp, {"tokens": jnp.asarray(toks),
                             "positions": jnp.asarray(pos)})
    tl = model.forward(tparams, {"tokens": _t(toks), "positions": _t(pos)})
    assert tl.shape == jl.shape and _nerr(tl, jl) <= TOL
    jc = jmodel.init_cache(3, 0)
    tc = model.init_cache(3, 0, device="cpu")
    assert set(tc) == {"state", "conv"}
    for step in range(3):
        tok = toks[:3, step]
        p = np.full((3,), step, np.int32)
        jlg, jc = jmodel.decode_step(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tlg, tc = model.decode_step(tparams, _t(tok), _t(p), tc)
        assert _nerr(tlg, jlg) <= TOL
    for k in ("state", "conv"):
        assert _nerr(tc[k], jc[k]) <= TOL


def test_convert_keeps_the_ssm_decay_f32():
    """A bf16 cast keeps ``A_log``, ``D`` and ``dt_bias`` f32, as the
    reference holds them."""
    jparams = jax.device_get(JModel(j_smoke("mamba2_130m")).init(
        jax.random.key(1)))
    t = params_from_numpy(jparams, "cpu", dtype=torch.bfloat16)
    for name in ("A_log", "D", "dt_bias"):
        assert t["mamba"][name].dtype == torch.float32
    assert t["mamba"]["in_proj"].dtype == torch.bfloat16
    # the audio family builds too (no SSM leaf, its front end in f32 under
    # a bf16 cast as every other weight is cast)
    cfg = smoke_config("musicgen_large")
    tp = params_from_numpy(jax.device_get(JModel(
        j_smoke("musicgen_large")).init(jax.random.key(1))), "cpu",
        dtype=torch.bfloat16)
    assert tp["frontend_proj"].dtype == torch.bfloat16
    assert Model(cfg).init(torch.Generator().manual_seed(0), "cpu")[
        "frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
