"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same numpy inputs and weights, f32, on the
smoke configs of both MoE architectures: the same experts chosen and the
same rows kept, outputs and gradients within 1e-5, padded experts
(``tp=2``) and capacity drops included.

Tolerance 1e-5, normalized by the largest reference value: the same
f32 arithmetic in two frameworks, summed in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as j_smoke
from repro.models import moe as jmoe
from repro_torch.configs.base import smoke_config
from repro_torch.models import moe
from test_torch_threads import intra_op_share  # noqa: F401


ARCHS = ["granite_moe_3b_a800m", "moonshot_v1_16b_a3b"]
T = 48                              # tokens of a frame


def _nerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _setup(arch, tp=1, seed=0, **over):
    """Both configs, one layer's weights in the reference's layout and
    scales (numpy, from a seed; the reference's router masks the padded
    experts, whatever they hold) and one frame of tokens."""
    jcfg = j_smoke(arch).replace(param_dtype="float32", **over)
    cfg = smoke_config(arch).replace(param_dtype="float32", **over)
    ep, d, ff = jmoe.padded_experts(jcfg, tp), cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    lp = {"router": normal((d, ep), d ** -0.5),
          "we_i": normal((ep, d, ff), d ** -0.5),
          "we_g": normal((ep, d, ff), d ** -0.5),
          "we_down": normal((ep, ff, d), ff ** -0.5)}
    return jcfg, cfg, lp, normal((T, d), 1.0)


def _jax_frame(x, lp, jcfg):
    return np.asarray(jax.jit(jmoe._moe_frame, static_argnums=2)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp), jcfg))


def _jax_routing(x, lp, cfg):
    """The reference's routing and capacity, step for step as
    ``repro.models.moe._moe_frame`` takes them: expert ids ``[T, k]`` and
    the keep mask of the sorted rows."""
    ep = lp["router"].shape[-1]
    logits = jnp.asarray(x) @ jnp.asarray(lp["router"])
    if ep > cfg.n_experts:
        logits = jnp.where((jnp.arange(ep) >= cfg.n_experts)[None], -1e30,
                           logits)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                            cfg.experts_per_token)
    e_sorted = jnp.sort(eidx.reshape(-1), stable=True)
    starts = jnp.searchsorted(e_sorted, jnp.arange(ep), side="left")
    keep = jnp.arange(e_sorted.shape[0]) - starts[e_sorted] < \
        moe.capacity(x.shape[0], cfg)
    return np.asarray(eidx), np.asarray(keep)


def _port_routing(x, lp, cfg):
    _, eidx = moe.route(x, lp["router"], cfg)
    _, keep, _ = moe.dispatch(eidx[None], lp["router"].shape[-1],
                              moe.capacity(x.shape[0], cfg))
    return eidx.numpy(), keep[0].numpy()


def _port(lp):
    return {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_frame_matches_reference(arch, tp):
    jcfg, cfg, lp, x = _setup(arch, tp)
    ep = lp["router"].shape[-1]
    assert ep == moe.padded_experts(cfg, tp) == jmoe.padded_experts(jcfg, tp)
    want = _jax_frame(x, lp, jcfg)
    tlp, tx = _port(lp), torch.from_numpy(x)
    got = moe._moe_frame(tx, tlp, cfg)
    assert _nerr(got, want) <= 1e-5
    e_j, keep_j = _jax_routing(x, lp, cfg)
    e_t, keep_t = _port_routing(tx, tlp, cfg)
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert (e_t < cfg.n_experts).all()            # padded experts never win
    # frames of one batch route independently: a frame of the batch gives
    # its own call's bytes
    two = moe.moe_ffn(torch.stack([tx, tx.flip(0)]), tlp, cfg)
    assert torch.equal(two[0], got)
    assert torch.equal(two[1], moe._moe_frame(tx.flip(0), tlp, cfg))


def test_moe_capacity_drops_tokens():
    """As ``tests/test_models.py::test_moe_capacity_drops_tokens``: every
    token routes the same way, capacity 0.25 drops most of them; the
    port drops the same rows and gives the same output."""
    jcfg, cfg, lp, _ = _setup("moonshot_v1_16b_a3b", capacity_factor=0.25)
    x = np.full((64, cfg.d_model), 0.1, np.float32)
    want = _jax_frame(x, lp, jcfg)
    got = moe._moe_frame(torch.from_numpy(x), _port(lp), cfg).numpy()
    norms = np.linalg.norm(got, axis=-1)
    assert (norms < 1e-9).any() and (norms > 1e-9).any()
    assert _nerr(got, want) <= 1e-5
    _, keep_j = _jax_routing(x, lp, cfg)
    _, keep_t = _port_routing(torch.from_numpy(x), _port(lp), cfg)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert not keep_t.all()


def test_router_load_matches_reference():
    jcfg, cfg, lp, x = _setup("granite_moe_3b_a800m", tp=2, seed=1)
    xf = np.stack([x, x[::-1] * 2])
    want = np.asarray(jax.jit(jmoe.router_load, static_argnums=2)(
        jnp.asarray(xf), jax.tree.map(jnp.asarray, lp), jcfg))
    got = moe.router_load(torch.from_numpy(xf), _port(lp), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_jax_grad(arch):
    """d/d(x, router, we_i, we_g, we_down) of sum(y * c) for a fixed c,
    padded experts and capacity drops included (capacity factor 0.5), and
    the same bytes from a second forward and backward."""
    jcfg, cfg, lp, x = _setup(arch, tp=2, seed=2, capacity_factor=0.5)
    cot = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    names = ("router", "we_i", "we_g", "we_down")

    def jloss(x_, *ws):
        return jnp.sum(jmoe._moe_frame(x_, dict(zip(names, ws)), jcfg)
                       * jnp.asarray(cot))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        jnp.asarray(x), *(jnp.asarray(lp[n]) for n in names))

    def grads():
        xs = [torch.from_numpy(np.array(a)).requires_grad_(True)
              for a in (x, *(lp[n] for n in names))]
        y = moe._moe_frame(xs[0], dict(zip(names, xs[1:])), cfg)
        return torch.autograd.grad((y * torch.from_numpy(cot)).sum(), xs)

    got = grads()
    _, keep = _port_routing(torch.from_numpy(x), _port(lp), cfg)
    assert not keep.all()                          # drops are exercised
    for name, a, b in zip(("x",) + names, got, want):
        assert _nerr(a, b) <= 1e-5, name
    for a, b in zip(got, grads()):
        assert torch.equal(a, b)


def test_convert_keeps_the_router_f32():
    """``params_from_numpy(..., dtype=bf16)`` casts the experts but keeps
    the router f32, as the reference holds it: a bf16 router would choose
    other experts."""
    from repro_torch.models.convert import params_from_numpy
    _, cfg, lp, _ = _setup("granite_moe_3b_a800m")
    tree = params_from_numpy({"layers": lp, "embed": lp["we_i"][0]}, "cpu",
                             torch.bfloat16)
    assert tree["layers"]["router"].dtype == torch.float32
    assert torch.equal(tree["layers"]["router"], _port(lp)["router"])
    assert tree["layers"]["we_i"].dtype == torch.bfloat16
    assert tree["embed"].dtype == torch.bfloat16
