"""The port's ``remat_policy="dots"`` against the reference's
``apply_remat(..., "dots")`` (``dots_with_no_batch_dims_saveable``), one
layer of each family's smoke config (dense, MoE, SSM, and the hybrid's
Mamba layer and shared block):

* (a) the product outputs the port's checkpoint keeps have the shapes
  (element counts) and dtypes of the product outputs JAX saves
  (``saved_residuals``, its arguments and constants left out);
* (b) a ``TorchDispatchMode`` count of ``aten.mm`` in the backward: under
  ``"dots"`` the backward runs as many as without remat (no no-batch
  product reruns), under ``"nothing"`` that many plus every saved one;
* (c) the f32 loss gradients of a two-layer model under ``"dots"``,
  ``"nothing"`` and no remat agree within 1e-6 (normalized by each
  leaf's largest entry).

Shapes compare by element count: JAX saves ``q`` as ``[F, T, H, Dh]``,
the port the ``torch.mm`` output ``[F * T, H * Dh]`` it is a view of."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import dense_attn_fn as j_dense_attn
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.configs.base import smoke_config
from repro_torch.models import Model, dense_attn_fn, hybrid, layers, ssm
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.optimizer import adamw
from test_torch_threads import intra_op_share  # noqa: F401

F_, T_ = 2, 64
# (arch, which layer): the hybrid's two checkpointed bodies separately
CASES = [("stablelm_1_6b", "layer"), ("llama3_70b", "layer"),
         ("granite_moe_3b_a800m", "layer"), ("mamba2_130m", "mamba"),
         ("zamba2_2_7b", "mamba"), ("zamba2_2_7b", "shared")]
MM = torch.ops.aten.mm.default


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    return jcfg, cfg, jax.device_get(JModel(jcfg).init(jax.random.key(0)))


def _stream():
    rng = np.random.default_rng(0)
    seg = np.repeat(np.arange(4), F_ * T_ // 4).reshape(F_, T_)
    pos = np.concatenate([np.arange(F_ * T_ // 4)] * 4).reshape(F_, T_)
    return rng, seg.astype(np.int32), pos.astype(np.int32)


def _bodies(arch, which):
    """The JAX body and its arguments, and the port's body of the same
    layer (``fn(x) -> y`` over the first layer's weights)."""
    jcfg, cfg, np_params = _weights(arch)
    rng, seg, pos = _stream()
    x = rng.normal(size=(F_, T_, cfg.d_model)).astype(np.float32)
    tp = params_from_numpy(np_params, "cpu")
    tseg, tpos = torch.from_numpy(seg), torch.from_numpy(pos)
    jseg, jpos = jnp.asarray(seg), jnp.asarray(pos)
    if which == "layer":
        jlp = jax.tree.map(lambda a: a[0], np_params["layers"])
        jfn = functools.partial(jtransformer._layer_body, cfg=jcfg, pos=jpos,
                                attn_fn=j_dense_attn(jseg, jpos))
        lp = {k: v.clone() for k, v in
              transformer.layer_params(tp, 0).items()}
        attn = dense_attn_fn(tseg, tpos)

        def fn(x):
            return transformer._layer_body(x, lp, cfg, tpos, attn)
        return jfn, (x, jlp), fn, x, lp
    if which == "mamba":
        jlp = jax.tree.map(lambda a: a[0], np_params["mamba"])
        flat = jpos.reshape(-1)

        def jfn(x, lp):
            return jssm.mamba_block(x, lp, jcfg, flat)
        lp = {k: v[0].clone() for k, v in tp["mamba"].items()}

        def fn(x):
            return ssm.mamba_block(x.reshape(1, F_ * T_, -1), lp, cfg,
                                   tpos.reshape(1, -1))
        return jfn, (x.reshape(F_ * T_, -1), jlp), fn, x, lp
    jfn = functools.partial(jhybrid._shared_attn_block, cfg=jcfg, pos=jpos,
                            attn_fn=j_dense_attn(jseg, jpos))
    sp = tp["shared_attn"]
    attn = dense_attn_fn(tseg, tpos)

    def fn(x):
        return hybrid._shared_attn_block(x, sp, cfg, tpos, attn)[0]
    return jfn, (x, np_params["shared_attn"]), fn, x, sp


def _jax_saved(jfn, args):
    """(numel, dtype) of what JAX's "dots" policy saves, products only."""
    res = saved_residuals(jtransformer.apply_remat(jfn, "dots"), *args)
    return sorted((int(np.prod(a.shape)), str(a.dtype)) for a, why in res
                  if "from the argument" not in why
                  and "from a constant" not in why)


def _port_saved(fn, x):
    """(numel, dtype) of the product outputs the port's "dots" checkpoint
    keeps for the backward."""
    stores = []

    class Recorded(layers._DotsStore):
        def __init__(self):
            super().__init__()
            stores.append(self)
    inner = layers._DotsStore
    layers._DotsStore = Recorded
    try:
        y = layers.maybe_checkpoint(fn, "dots",
                                    torch.from_numpy(x).requires_grad_(True))
    finally:
        layers._DotsStore = inner
    assert len(stores) == 1
    del y
    return sorted((t.numel(), str(t.dtype).replace("torch.", ""))
                  for t in stores[0].outs)


@pytest.mark.parametrize("arch,which", CASES)
def test_dots_saves_what_jax_saves(arch, which):
    jfn, jargs, fn, x, _ = _bodies(arch, which)
    want = _jax_saved(jfn, jargs)
    assert want, "JAX saved no product"
    assert _port_saved(fn, x) == want


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is MM
        return func(*args, **(kwargs or {}))


def _backward_mm(fn, x, lp, remat):
    """(forward aten.mm count, backward aten.mm count) of one layer with
    its input and weights requiring gradients."""
    xt = torch.from_numpy(x).requires_grad_(True)
    ws = [w.requires_grad_(True) for w in lp.values()]
    fwd, bwd = _CountMM(), _CountMM()
    with fwd:
        y = layers.maybe_checkpoint(fn, remat, xt)
    with bwd:
        torch.autograd.grad(y.square().sum(), [xt] + ws, allow_unused=True)
    for w in ws:
        w.requires_grad_(False)
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch,which", CASES)
def test_backward_reruns_no_saved_product(arch, which):
    _, _, fn, x, lp = _bodies(arch, which)
    n_fwd, base = _backward_mm(fn, x, lp, False)
    n_saved = len(_port_saved(fn, x))
    # every product the forward runs is kept, but a layer's last (0 or 1)
    assert n_saved > 0 and n_fwd - n_saved in (0, 1)
    assert _backward_mm(fn, x, lp, "dots")[1] == base
    assert _backward_mm(fn, x, lp, True)[1] == base
    assert _backward_mm(fn, x, lp, "nothing")[1] == base + n_saved


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "granite_moe_3b_a800m",
                                  "mamba2_130m", "zamba2_2_7b"])
def test_gradients_equal_under_every_policy(arch):
    _, cfg, np_params = _weights(arch)
    rng, seg, pos = _stream()
    tseg, tpos = torch.from_numpy(seg), torch.from_numpy(pos)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 1, cfg.vocab_size, (F_, T_)).astype(np.int32)),
             "positions": tpos,
             "labels": torch.from_numpy(rng.integers(
                 1, cfg.vocab_size, (F_, T_)).astype(np.int32)),
             "loss_mask": torch.ones((F_, T_))}
    model = Model(cfg)
    params = params_from_numpy(np_params, "cpu")
    leaves = adamw.tree_leaves(params)
    grads = {}
    for remat in (False, "dots", "nothing"):
        for w in leaves:
            w.requires_grad_(True)
        loss = model.loss(params, batch, dense_attn_fn(tseg, tpos),
                          remat=remat)
        grads[remat] = torch.autograd.grad(loss, leaves)
        for w in leaves:
            w.requires_grad_(False)
    for remat in ("dots", "nothing"):
        for a, b in zip(grads[remat], grads[False]):
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            assert err <= 1e-6, (remat, err)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_cli_remat_policy_reaches_the_step(policy):
    """``--remat-policy`` (default ``dots``, the reference's) sets the
    policy the train step checkpoints each layer with."""
    from repro_torch.launch import train as T
    argv = ["--arch", "llama3_70b", "--smoke", "--mesh", "4x1", "--dist",
            "real_world", "--block-size", "32", "--tokens-per-worker", "128",
            "--steps", "1", "--device", "cpu", "--no-supervised"]
    if policy != "dots":
        argv += ["--remat-policy", policy]
    seen = []
    inner = layers.maybe_checkpoint

    def spy(fn, remat, *args):
        seen.append(remat)
        return inner(fn, remat, *args)
    layers.maybe_checkpoint = spy
    tr = T.trainer_from_args(T.parse_args(argv))
    try:
        rec = tr.step()
    finally:
        tr.close()
        layers.maybe_checkpoint = inner
    assert tr.pcfg.remat_policy == policy and np.isfinite(rec.loss)
    assert seen and set(seen) == {policy}
