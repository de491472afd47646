"""The serving loop's compiled programs (``repro_torch.runtime.graphs``)
against the reference's jitted ones, on the CPU.

The JAX ``ServingLoop`` jits its decode step, one prefill and one insert
per bucket edge and the recurrent families' fresh insert, and counts
their compiles (``compile_counts``); its ``warmup`` returns them as the
baseline that the measured stream must not grow.  The port runs the same
programs through ``graphs.Program`` (a CUDA graph per program and static
shape on the card; on the CPU the same static-buffer path without a
capture) and counts their builds.  On the f32 smoke weights and the
settings of ``tests/test_torch_serving.py`` (each loop with the
reference's prefill budget of 128 tokens, so both have the same bucket
edges), for a dense model (StableLM: FCP prefill on 2 workers of 64
tokens) and an SSM (Mamba2: the chunk, tail and fresh paths):

* (a) after ``warmup`` the port's ``compile_counts()`` has the
  reference's keys, and each key the reference built once the port
  built once;
* (b) neither package's counts grow over the measured stream;
* (c) ``warmup`` returns the baseline dict;
* (d) one program called with two inputs returns the eager function's
  result for each (no stale buffer), bytes equal;
* (e) the stream's tokens equal the JAX loop's, token for token.

The serve CLI prints ``recompiles after warmup: 0`` on a smoke config.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import smoke_config as j_smoke
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.runtime.serving import ServingLoop as JLoop
from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                      smoke_config)
from repro_torch.launch import serve as servelib
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.runtime.serving import Request, ServingLoop
from test_torch_threads import intra_op_share  # noqa: F401

SERVE = dict(cache_len=160, decode_slots=2, queue_depth=8,
             max_new_tokens=8, prefill_tokens_per_worker=128,
             bucket_min=16)
# mesh and prefill tokens per worker: a prefill budget of 128 tokens
ARCHS = {"stablelm_1_6b": ((2, 2), 64), "mamba2_130m": ((1, 2), 128)}
# below the smallest edge (fresh for the SSM), between edges, at an
# edge, beyond the budget for the SSM (a chunk of 128 and a tail)
LENS = {"stablelm_1_6b": [5, 23, 64, 128],
        "mamba2_130m": [5, 16, 23, 64, 150]}


def _tokens(loop) -> dict:
    return {r.rid: list(map(int, r.tokens)) for r in loop.stats.finished}


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """Both loops warmed up and run over one stream (6 new tokens a
    request), with the counts before and after."""
    arch = request.param
    mesh, tpw = ARCHS[arch]
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    jparams = JModel(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, (L,)).astype(np.int32)
               for L in LENS[arch]]
    jloop = JLoop(JModel(jcfg), jparams,
                  make_mesh((1, 1), ("data", "model")),
                  JParallel(block_size=16), JServe(**SERVE))
    jbase = jloop.warmup()
    jloop.run(prompts, max_new=6)
    cfg = dataclasses.replace(smoke_config(arch), param_dtype="float32")
    loop = ServingLoop(Model(cfg),
                       params_from_numpy(jax.device_get(jparams), "cpu"),
                       StackedMesh(mesh), ParallelConfig(block_size=16),
                       ServeConfig(**dict(SERVE,
                                          prefill_tokens_per_worker=tpw)),
                       device="cpu")
    base = loop.warmup()
    now = loop.compile_counts()
    loop.run(prompts, max_new=6)
    return {"arch": arch, "jloop": jloop, "jbase": jbase,
            "jafter": jloop.compile_counts(), "loop": loop, "base": base,
            "base_now": now, "after": loop.compile_counts()}


def test_compile_count_keys_match_the_reference(served):
    """(a) The reference's keys; a key it built once was built once.
    Every reference value here is 0 or 1: 0 is ``fresh_insert`` of the
    attention model, which no prompt of the stream takes (the port's is
    0 too, below)."""
    base, jbase = served["base"], served["jbase"]
    assert served["loop"].edges == [16, 32, 64, 128]
    assert sorted(base) == sorted(jbase)
    assert {k for k, v in jbase.items() if v == 1} == \
        {k for k, v in base.items() if v == 1}
    assert set(jbase.values()) <= {0, 1}
    assert base == jbase


def test_no_recompiles_after_warmup(served):
    """(b) The measured stream builds nothing in either package."""
    assert served["after"] == served["base"]
    assert served["jafter"] == served["jbase"]


def test_warmup_returns_the_baseline(served):
    """(c) ``warmup`` returns ``compile_counts()`` as it stood when the
    warmup ended; each program that ran was built."""
    base = served["base"]
    assert isinstance(base, dict) and base == served["base_now"]
    fresh = served["arch"] == "mamba2_130m"
    assert base["loop_step"] == 1 and base["fresh_insert"] == int(fresh)
    assert all(base[f"{p}_{e}"] == 1 for e in served["loop"].edges
               for p in ("prefill", "insert"))


def test_tokens_match_the_jax_loop_through_the_programs(served):
    """(e) Token for token, the measured stream."""
    assert len(served["loop"].stats.finished) == len(LENS[served["arch"]])
    assert _tokens(served["loop"]) == _tokens(served["jloop"])


def test_program_returns_each_inputs_result():
    """(d) Two calls with different inputs each give the eager result
    (bytes equal), in the same static outputs; a held tensor other than
    the one the program was built on is refused."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)

    def fn(x, d):
        return {"y": x @ w.T + d["b"], "n": x.sum(-1)}
    prog = graphs.Program("p", fn, "cpu")
    rng = np.random.default_rng(0)
    xs = [(torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
           {"b": torch.full((2,), float(i))}) for i in range(2)]
    outs = []
    for x, d in xs:
        out = prog(x, d, held=w)
        outs.append({k: v.clone() for k, v in out.items()})
        assert out is prog(x, d, held=w)       # the key's static outputs
    for (x, d), got in zip(xs, outs):
        want = fn(x, d)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(outs[0]["y"], outs[1]["y"])
    assert prog.builds == 1
    prog(torch.zeros((5, 3)), xs[0][1], held=w)   # a new shape: a new key
    assert prog.builds == 2
    with pytest.raises(ValueError, match="held tensors"):
        prog(*xs[0], held=w.clone())


def test_prefill_program_matches_eager_prefill(served):
    """(d) on the loop: the ``prefill_{E}`` program, called with two
    different batches of one bucket, gives the eager ``prefill_fn(E)``'s
    logits and caches for each, bytes equal."""
    loop = served["loop"]
    E = 32
    rng = np.random.default_rng(5)
    prog = loop._programs[f"prefill_{E}"]
    # the dense model pads up to the edge, the SSM chunks down to it
    for L in ((40, 57) if served["arch"] == "mamba2_130m" else (17, 30)):
        prompt = rng.integers(1, loop.model.cfg.vocab_size, (L,))
        req = Request(-1, prompt.astype(np.int32), 2, *loop.bucket_of(L))
        assert req.bucket == E
        batch, last = loop.assemble(E, [req])
        got = prog(batch, last, held=loop.params)
        want = loop.prefill_fn(E)(loop.params, batch, last)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert loop.compile_counts() == served["base"]


def test_serve_cli_prints_zero_recompiles(capsys):
    servelib.main(["--arch", "stablelm_1_6b", "--smoke", "--mesh", "2x2",
                   "--device", "cpu", "--tokens", "4", "--requests", "6",
                   "--cache-len", "160", "--prompt-len", "100",
                   "--prefill-tokens-per-worker", "64", "--bucket-min",
                   "16"])
    lines = capsys.readouterr().out.splitlines()
    assert "recompiles after warmup: 0" in lines
