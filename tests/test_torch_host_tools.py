"""The port's planning tools against the reference's: the baseline CP
policies (ring, ByteScale, WLB, Magi) through the port's fused executor,
the plan-verify CLI and its fuzz harnesses, and the port's lints.

The policies' schedules run on 4 stacked workers (plain kernel versions)
and are held against the dense oracle and against the reference's
executor on the same schedule, run on 4 CPU devices in a subprocess (the
suite's JAX has one), as ``tests/multidevice/run_fcp_executor.py`` runs
its ring case; forward to 1e-5 normalized (the bound of
``test_torch_executor.py``), the port's gradients against ``jax.grad`` of
the oracle to 1e-5 (``test_torch_train.py``'s)."""

import ast
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import verify as jverify
from repro.kernels import ref as jref
from repro_torch import verify as tverify
from repro_torch.analysis import lints
from repro_torch.core import blocks as bl
from repro_torch.core import cost_model as cm
from repro_torch.core import executor as ex
from repro_torch.core import policies
from repro_torch.core.schedule import make_schedule
from test_torch_threads import intra_op_share  # noqa: F401

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
SEQLENS = [120, 50, 40, 30, 16]           # a long-tailed batch of 256
POLICIES = ("ring", "bytescale", "magi", "wlb")


def policy_assignment(name, batch, n_workers):
    """A baseline's block owners, as ``benchmarks/common.py`` builds
    them."""
    deps = bl.kv_dependencies(batch, mask=True)
    if name == "ring":
        return policies.assign_ring(batch, n_workers)
    if name == "bytescale":
        return policies.assign_bytescale(batch, n_workers, TPW)
    if name == "magi":
        return policies.assign_magi(batch, deps, n_workers, H, D)
    return policies.assign_wlb(batch, deps, n_workers, TPW, cm.GPU_X, H, KH,
                               D)


def _schedules():
    base = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                         head_dim=D)
    return {p: make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                             head_dim=D, verify=True,
                             assignment=policy_assignment(p, base.batch, N))
            for p in POLICIES}


def _qkv():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(N * TPW, h, D)).astype(np.float32)
            for h in (H, KH, KH)]


# the reference's executor on 4 CPU devices, one forward per policy
_JAX_EXECUTOR = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import blocks as bl, cost_model as cm, executor, policies
from repro.core.schedule import make_schedule
N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
seqlens, path = json.loads(sys.argv[1]), sys.argv[2]
qkv = np.load(path + "/qkv.npz")
base = make_schedule(seqlens, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                     head_dim=D)
deps = bl.kv_dependencies(base.batch, mask=True)
owners = {"ring": policies.assign_ring(base.batch, N),
          "bytescale": policies.assign_bytescale(base.batch, N, TPW),
          "magi": policies.assign_magi(base.batch, deps, N, H, D),
          "wlb": policies.assign_wlb(base.batch, deps, N, TPW, cm.GPU_X, H,
                                     KH, D)}
mesh = jax.make_mesh((N,), ("data",))
out = {}
for name, a in owners.items():
    s = make_schedule(seqlens, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                      head_dim=D, assignment=a)
    tables = executor.schedule_tables(s)
    q, k, v = (jnp.asarray(qkv[x]).reshape(N, TPW, -1, D) for x in "qkv")
    o = jax.jit(lambda q, k, v: executor.fcp_attention(
        q, k, v, tables, spec=s.spec, mesh=mesh, cp_axis="data",
        head_axis=None))(q, k, v)
    out[name] = np.asarray(o).reshape(N * TPW, H, D)
    out[name + "_owner"] = np.asarray(a)
np.savez(path + "/out.npz", **out)
"""


@pytest.fixture(scope="module")
def jax_executor(tmp_path_factory):
    path = tmp_path_factory.mktemp("policies")
    q, k, v = _qkv()
    np.savez(path / "qkv.npz", q=q, k=k, v=v)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_EXECUTOR,
                          json.dumps(SEQLENS), str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path / "out.npz"))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_schedule_through_fused_executor(policy, jax_executor):
    sched = _schedules()[policy]
    np.testing.assert_array_equal(sched.assignment,
                                  jax_executor[policy + "_owner"])
    assert sched.spec.n_rounds > 0 and sched._verified
    qkv = _qkv()
    xs = [torch.from_numpy(x).reshape(N, TPW, -1, D).requires_grad_(True)
          for x in qkv]
    o = ex.fcp_attention(*xs, ex.schedule_tables(sched, "cpu"),
                         spec=sched.spec, cfg=ex.ExecConfig(impl="fused"))
    o = o.reshape(N * TPW, H, D)
    seg = jnp.asarray(sched.batch.seg_ids)
    pos = jnp.asarray(sched.batch.positions)

    def oracle(q, k, v):
        o, _ = jref.reference_attention(
            q.transpose(1, 0, 2), k.transpose(1, 0, 2),
            v.transpose(1, 0, 2), seg, pos, seg, pos, True)
        return o.transpose(1, 0, 2)

    want = np.asarray(oracle(*map(jnp.asarray, qkv)))
    scale = max(1.0, np.abs(want).max())
    got = o.detach().numpy()
    assert np.abs(got - want).max() / scale <= 1e-5
    assert np.abs(got - jax_executor[policy]).max() / scale <= 1e-5
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    grads = torch.autograd.grad((o * torch.from_numpy(cot)).sum(), xs)
    ref = jax.grad(lambda q, k, v: jnp.sum(oracle(q, k, v) * cot),
                   argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    for g, r in zip(grads, ref):
        r = np.asarray(r)
        err = np.abs(g.reshape(N * TPW, -1, D).numpy() - r).max()
        assert err / max(1.0, np.abs(r).max()) <= 1e-5


# --------------------------------------------------------------------------
# the plan-verify CLI
# --------------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--fuzz", "--plans", "20", "--seed", "0"],
    ["--fuzz-elastic", "--plans", "5", "--seed", "0"],
    ["--seqlens", "700,50,30,400,200,258", "--workers", "4",
     "--block-size", "16", "--coalesce", "4", "--mask", "swa:64",
     "--wire", "int8"]], ids=["fuzz", "fuzz_elastic", "one_plan"])
def test_verify_cli_prints_the_reference_output(argv):
    rc, out = _run(tverify.main, argv)
    jrc, jout = _run(jverify.main, argv)
    assert rc == jrc == 0
    assert out == jout and out.startswith("ok")


# --------------------------------------------------------------------------
# lints
# --------------------------------------------------------------------------

def test_lints_pass_on_the_port():
    assert lints.run_all() == []


def test_spec_key_lint_reports_an_unkeyed_field():
    errs = lints.run_all(extra_spec_fields=["new_knob"])
    assert len(errs) == 1 and "StaticSpec.new_knob" in errs[0]


def test_static_arg_lint_reports_mutable_and_unhashable_types():
    import dataclasses

    @dataclasses.dataclass
    class Mutable:
        x: int = 0

    @dataclasses.dataclass(frozen=True)
    class Unhashable:
        x: tuple = ()

    errs = lints.check_static_args([(Mutable, Mutable),
                                    (Unhashable, lambda: Unhashable(([],)))])
    assert any("Mutable must be frozen" in e for e in errs)
    assert any("Unhashable is not hashable" in e for e in errs)
    assert lints.check_static_args() == []


def test_ship_bypass_lint_reports_private_ships_and_collectives(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "runtime").mkdir(parents=True)
    (pkg / "runtime" / "wire.py").write_text(
        "import torch.distributed as dist\n"
        "def _ship(x):\n    dist.send(x, 1)\n")
    (pkg / "bad.py").write_text(
        "import torch\nimport torch.distributed as d\n"
        "from torch.distributed import all_gather_into_tensor as ag\n"
        "from .runtime.wire import _ship\n"
        "def f(x, y):\n"
        "    _ship(x)\n"
        "    d.all_to_all_single(y, x)\n"
        "    torch.distributed.isend(x, 1)\n"
        "    ag(y, x)\n")
    (pkg / "fine.py").write_text(
        "from .runtime import wire\n"
        "def f(x, sock):\n    sock.send(x)\n    return wire.ship(x, ())\n")
    errs = lints.check_ship_sites(tmp_path)
    assert all(e.startswith("repro_torch/bad.py:") for e in errs), errs
    found = " ".join(errs)
    for what in ("imports wire._ship", "torch.distributed.all_to_all_single",
                 "torch.distributed.isend",
                 "torch.distributed.all_gather_into_tensor"):
        assert what in found, what
    # the executor's pod_perm offsets pairs: no move of its own
    tree = ast.parse((SRC / "repro_torch" / "core" / "executor.py")
                     .read_text())
    assert lints.ship_bypasses(tree) == []
