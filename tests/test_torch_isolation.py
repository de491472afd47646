"""The port stands alone: importing it loads neither JAX nor the reference
package, its entry points refuse to fall back to the CPU silently, and
CPU tensors reach the plain kernel versions without a launch."""

import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import serve as servelib
from repro_torch.launch import train as trainlib
from repro_torch.launch.mesh import StackedMesh
from repro_torch.runtime.serving import ServingLoop

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.runtime.serving" in mods and len(mods) > 25
    assert {"repro_torch.launch.train", "repro_torch.optimizer.adamw",
            "repro_torch.runtime.compression",
            "repro_torch.data.loader"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingLoop(None, None, StackedMesh((1, 1)), ParallelConfig(),
                    ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        servelib.main(["--arch", "stablelm_1_6b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trainlib.main(["--arch", "stablelm_1_6b", "--smoke"])


def test_cpu_tensors_take_the_plain_versions():
    tfa.fused_flash_fwd.launches = 0
    tfa.flash_attention_fwd.launches = 0
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
    meta = torch.zeros(16, dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32)
    o, lse = ops.block_attention(q, q, q, meta, pos, meta, pos)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    tabs = {"step_q": torch.tensor([0], dtype=torch.int32),
            "step_kv": torch.tensor([0], dtype=torch.int32),
            "q_seg": meta[None], "q_pos": pos[None],
            "k_seg": meta[None], "k_pos": pos[None]}
    acc_o = torch.zeros(1, 2, 16, 32)
    acc_l = torch.full((1, 2, 16), -1e30)
    ops.fused_run_attention(q[None], q[None], q[None], acc_o, acc_l, tabs)
    torch.testing.assert_close(acc_o[0], o)
    torch.testing.assert_close(acc_l[0], lse)
    assert tfa.fused_flash_fwd.launches == 0
    assert tfa.flash_attention_fwd.launches == 0


def test_cpu_tensors_take_the_plain_backward_versions():
    """Gradients of both ops on CPU tensors run the plain backward
    versions: no backward kernel is launched."""
    counters = [(tfa.fused_flash_bwd_dq, "launches"),
                (tfa.fused_flash_bwd_dkv, "launches"),
                (tfa.flash_attention_bwd_dq, "launches"),
                (tfa.flash_attention_bwd_dkv, "launches")]
    for fn, name in counters:
        setattr(fn, name, 0)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 16, 32)).astype(np.float32))
    q.requires_grad_(True)
    meta = torch.zeros(16, dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32)
    o, lse = ops.block_attention(q, q, q, meta, pos, meta, pos)
    step = torch.tensor([0], dtype=torch.int32)
    tabs = {"step_q": step, "step_kv": step, "bwd_q": step, "bwd_kv": step,
            "q_seg": meta[None], "q_pos": pos[None],
            "k_seg": meta[None], "k_pos": pos[None],
            "k_seg_b": meta[None], "k_pos_b": pos[None]}
    o2, l2 = ops.fused_run_attention(q[None], q[None], q[None],
                                     torch.zeros(1, 2, 16, 32),
                                     torch.full((1, 2, 16), -1e30), tabs)
    (g,) = torch.autograd.grad((o + o2[0]).sum() + (lse + l2[0]).sum(), q)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert all(getattr(fn, name) == 0 for fn, name in counters)


def test_sources_import_no_jax():
    """No line of the port imports jax or the reference package."""
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not re.match(r"\s*(import|from)\s+(jax|repro)\b",
                                line), f"{path}: {line}"
