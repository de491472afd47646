"""Plan parity: the port's numpy host layer (``repro_torch.core``) plans
byte-identical schedules to the reference (``repro.core``)."""

import dataclasses
import filecmp
import pathlib

import numpy as np
import pytest

from repro.core import plan_cache as jpc
from repro.core.schedule import make_schedule as jmake
from repro_torch.core import plan_cache as tpc
from repro_torch.core.schedule import make_schedule as tmake

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# 4 workers x 64 tokens, 16-token blocks: uniform prefill compositions
# (what the serving loop plans) and one mixed training-style batch
BUDGET, N, TPW, BS = 256, 4, 64, 16
COMPS = {f"uniform{e}": jpc.prefill_composition(e, BUDGET)
         for e in (32, 64, 128)}
COMPS["mixed"] = (100, 60, 40, 30, 26)


@pytest.mark.parametrize("coalesce", [1, 16])
@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("mask", ["causal", "swa:24"])
@pytest.mark.parametrize("comp", list(COMPS), ids=str)
def test_plan_tables_byte_equal(comp, mask, wire, coalesce):
    kw = dict(n_q_heads=4, n_kv_heads=2, head_dim=32, mask=mask,
              coalesce=coalesce, wire=wire, in_dtype_bytes=4.0,
              verify=True)
    seqlens = list(COMPS[comp])
    js = jmake(seqlens, N, TPW, BS, **kw)
    ts = tmake(seqlens, N, TPW, BS, **kw)
    assert repr(ts.spec) == repr(js.spec)
    for f in dataclasses.fields(js.arrays):
        a, b = getattr(js.arrays, f.name), getattr(ts.arrays, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name
    np.testing.assert_array_equal(ts.assignment, js.assignment)
    assert ts._verified and js._verified

    pk = dict(mask=mask, coalesce=coalesce, wire=wire, extra=(4, 2, 32))
    assert tpc.plan_key(seqlens, N, TPW, BS, **pk) == \
        jpc.plan_key(seqlens, N, TPW, BS, **pk)


@pytest.mark.parametrize("edge", [16, 64, 256])
def test_prefill_keys_and_buckets_equal(edge):
    assert tpc.prefill_bucket_edges(16, BUDGET) == \
        jpc.prefill_bucket_edges(16, BUDGET)
    assert tpc.prefill_composition(edge, BUDGET) == \
        jpc.prefill_composition(edge, BUDGET)
    kw = dict(mask=True, coalesce=16, wire="bf16", in_dtype_bytes=2.0,
              extra=(32, 32, 64))
    assert tpc.prefill_plan_key(edge, BUDGET, N, BS, **kw) == \
        jpc.prefill_plan_key(edge, BUDGET, N, BS, **kw)


HOST_COPIES = ["masks.py", "core/blocks.py", "core/cost_model.py",
               "core/distributor.py", "core/planner.py", "core/schedule.py",
               "core/plan_cache.py", "analysis/verifier.py",
               "data/loader.py", "data/distributions.py",
               "checkpoint/manager.py", "checkpoint/__init__.py",
               "runtime/elastic.py", "runtime/health.py",
               "core/policies.py"]


@pytest.mark.parametrize("path", HOST_COPIES)
def test_host_modules_are_verbatim_copies(path):
    """The numpy host layer is copied, not rewritten: relative imports
    resolve inside ``repro_torch``, so the files stay byte-equal."""
    assert filecmp.cmp(SRC / "repro" / path, SRC / "repro_torch" / path,
                       shallow=False)


def test_config_copies_differ_only_in_package_name():
    for ref in sorted((SRC / "repro" / "configs").glob("*.py")):
        port = (SRC / "repro_torch" / "configs" / ref.name).read_text()
        assert port.replace("repro_torch.configs.{name.replace('-', '_')}",
                            "repro.configs.{name.replace('-', '_')}") \
            .replace("(\n        f\"repro.configs", "(f\"repro.configs") \
            == ref.read_text(), ref.name


def test_verify_cli_copy_differs_only_in_package_name():
    """``repro_torch/verify.py`` is the reference's CLI with the package
    renamed (its ``python -m`` name and the modules its text names)."""
    port = (SRC / "repro_torch" / "verify.py").read_text()
    assert "repro_torch." in port
    assert port.replace("repro_torch.", "repro.") == \
        (SRC / "repro" / "verify.py").read_text()
