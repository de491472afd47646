"""Serving across processes on the CPU: ranks of a gloo process group,
each holding a share of a ``4x2`` mesh's data axis (``runtime/wire``
``Ranks``), against the stacked transport, the stacked serving loop and
the reference.

The ranks are spawned processes (``tests/torch_ranks_jobs.py``, which
imports neither JAX nor the reference): one group of two ranks for the
decode attention, the cache write, the row moves and the serving loop,
and one of four for the first three, each under its own deadline.

Tolerances: the decode attention across ranks (the three cases of
``tests/multidevice/run_decode.py``: the batch split over the ranks, the
sequence over both axes, the sequence over the model axis alone) within
1e-5 of the reference's dense oracle (``repro.kernels.ref.
reference_attention`` per sample, as that runner holds it) and within
1e-6 of the port's stacked merge, and the same bytes on every rank where
the sequence is split; the cache write across ranks (one position past
the cache) and ``wire.move`` (f32 and bf16, rows along either dim) byte
for byte against the stacked write and a local gather, the bytes a move
sends exactly ``wire.move_bytes``; the ranked ``ServingLoop`` (StableLM
smoke, f32) under ``decode`` and ``long``, token for token the JAX
``ServingLoop`` on a 1x1 mesh of the same kind and the port's stacked
loop, 0 programs built after warmup, and each rank's bytes in the
prefill ships, the inserts and the merges exactly their host pricing.
The port's one-process ``--kind long`` loop on 2x2 and 2x1 meshes gives
the JAX 1x1 long loop's tokens too.  The ranked loop with
``ParallelConfig.overlap`` (its prefill ships started before a run and
landed after it) gives the one-process ``overlap`` loop's and the JAX
1x1 loop's tokens, with every byte at its price."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks_jobs as J
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh
from repro.models import Model as JModel
from repro.runtime.serving import ServingLoop as JLoop
from repro_torch.launch import serve as servelib
from repro_torch.runtime import wire
from test_torch_threads import intra_op_share  # noqa: F401

KINDS = ("decode", "long")


@pytest.fixture(scope="module")
def np_params():
    jcfg = dataclasses.replace(j_smoke(J.ARCH), param_dtype="float32")
    return jcfg, jax.device_get(JModel(jcfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def two(np_params, tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_two_ranks")
    torch.save(np_params[1], d / "params.pt")
    return J.run(2, "serve", d, timeout=90,
                 params_path=str(d / "params.pt"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return J.run(4, "serve", tmp_path_factory.mktemp("serve_four_ranks"),
                 timeout=60)


@pytest.fixture(scope="module")
def groups(two, four):
    return {2: two, 4: four}


@pytest.fixture(scope="module")
def jax_tokens(np_params):
    """The JAX 1x1 loop's tokens per kind, at the ranked loop's prefill
    budget (one worker of 256 tokens) and cache."""
    jcfg, params = np_params
    out = {}
    for kind in KINDS:
        scfg = dict(J.serve_config(kind), prefill_tokens_per_worker=256)
        jloop = JLoop(JModel(jcfg), params,
                      make_mesh((1, 1), ("data", "model")),
                      JParallel(block_size=16), JServe(**scfg))
        jloop.run(J.serve_prompts(jcfg.vocab_size), max_new=J.SERVE_NEW)
        out[kind] = {r.rid: list(map(int, r.tokens))
                     for r in jloop.stats.finished}
    return out


@pytest.fixture(scope="module")
def stacked_overlap(np_params):
    """The port's one-process ``overlap`` loop of each kind on the ranked
    mesh."""
    return {kind: J.serve_run(kind, np_params[1], overlap=True)
            for kind in KINDS}


@pytest.fixture(scope="module")
def stacked(np_params):
    """The port's one-process loop of each kind on the ranked mesh."""
    return {kind: J.serve_run(kind, np_params[1]) for kind in KINDS}


def _in_order(tokens: dict) -> list:
    """A stream's tokens in request order (the port's request ids count
    its warmup's requests too)."""
    return [tokens[k] for k in sorted(tokens)]


def _by_rank(res: list, *keys):
    out = []
    for r in res:
        for k in keys:
            r = r[k]
        out.append(r)
    return out


# --------------------------------------------------------------------------
# (a) the decode attention and its merge across ranks
# --------------------------------------------------------------------------

def _oracle(case) -> np.ndarray:
    """``run_decode.py``'s dense oracle, per sample."""
    q, kc, vc, ln = (jnp.asarray(x) for x in J.decode_inputs(case))
    s = kc.shape[1]
    pos = jnp.arange(s, dtype=jnp.int32)
    out = []
    for b in range(q.shape[0]):
        seg_k = jnp.where(pos < ln[b], 0, -1).astype(jnp.int32)
        o, _ = jref.reference_attention(
            q[b][:, None], kc[b].transpose(1, 0, 2), vc[b].transpose(1, 0, 2),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32), seg_k,
            pos, mask=False)
        out.append(np.asarray(o[:, 0]))
    return np.stack(out)


@pytest.mark.parametrize("case", list(J.DECODE_CASES))
@pytest.mark.parametrize("size", [2, 4])
def test_decode_attention_across_ranks(size, case, groups):
    outs = _by_rank(groups[size], "decode", case)
    if J.DECODE_CASES[case][7]:             # the batch split: rank rows
        got = np.concatenate(outs)
    else:                                   # the sequence split: merged
        for o in outs[1:]:
            assert o.tobytes() == outs[0].tobytes()
        got = outs[0]
    assert np.abs(got - _oracle(case)).max() < 1e-5
    assert np.abs(got - J.decode_case(case)).max() <= 1e-6


# --------------------------------------------------------------------------
# (b) the cache write, (c) the row moves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
def test_cache_update_across_ranks_matches_stacked_bytes(size, groups):
    got = np.concatenate(_by_rank(groups[size], "update"), axis=1)
    want = J.update_case()
    assert got.tobytes() == want.tobytes()
    # the position past the cache wrote nothing
    cache, _, pos = J.update_inputs()
    assert pos[-1] == cache.shape[1]
    assert got[-1].tobytes() == cache[-1].tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [2, 4])
def test_move_matches_a_local_gather(size, dtype, groups):
    res = _by_rank(groups[size], "move", dtype)
    x, e = J.move_inputs(size)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    table = J.move_table(size)
    raw = xt.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    want = J.moved(raw.numpy(), table)
    assert np.concatenate([r["raw"] for r in res]).tobytes() == \
        want.tobytes()
    assert np.array_equal(np.concatenate([r["extra"] for r in res]),
                          J.moved(e, table))
    assert np.array_equal(np.concatenate([r["dst_t"] for r in res]),
                          np.concatenate([r["dst"] for r in res]))
    sent = [r["sent"] for r in res]
    assert sent == [r["priced"] for r in res]
    assert all(s > 0 for s in sent)


# --------------------------------------------------------------------------
# (d) the ranked serving loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_ranked_loop_tokens_match_jax_and_stacked(kind, two, jax_tokens,
                                                  stacked):
    toks = [_in_order(t) for t in _by_rank(two, "loop", kind, "tokens")]
    assert toks[1] == toks[0]
    assert len(toks[0]) == len(J.SERVE_LENS)
    assert toks[0] == _in_order(jax_tokens[kind])
    assert toks[0] == _in_order(stacked[kind]["tokens"])


@pytest.mark.parametrize("kind", KINDS)
def test_ranked_loop_builds_nothing_after_warmup(kind, two, stacked):
    for r in _by_rank(two, "loop", kind):
        assert r["recompiles"] == 0
        assert r["counts"] == stacked[kind]["counts"]
        pcs = r["report"]["plan_cache"]
        assert pcs["misses"] == 0
        assert pcs["hits"] == r["report"]["prefill_batches"]


@pytest.mark.parametrize("kind", KINDS)
def test_ranked_loop_bytes_equal_their_pricing(kind, two):
    rks = [r["report"]["ranks"] for r in _by_rank(two, "loop", kind)]
    for what in ("prefill_ship_bytes", "insert_bytes", "merge_bytes"):
        assert [x[what] for x in rks] == [x[what + "_priced"]
                                          for x in rks], what
    # the prompt wider than a rank's prefill tokens spans ranks, and
    # long's merges cross them
    assert sum(x["insert_bytes"] for x in rks) > 0
    assert all(x["prefill_ship_bytes"] > 0 for x in rks)
    assert all((x["merge_bytes"] > 0) == (kind == "long") for x in rks)
    assert [x["slots"] for x in rks] == (
        [[0, 2], [2, 4]] if kind == "decode" else [[0, 2], [0, 2]])


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_stacked_long_loop_matches_jax(mesh, np_params, jax_tokens):
    """The one-process ``--kind long`` loop (the cache over both axes)
    against the JAX 1x1 long loop, at the same prefill budget."""
    got = J.serve_run("long", np_params[1], mesh=mesh)
    assert _in_order(got["tokens"]) == _in_order(jax_tokens["long"])
    assert got["recompiles"] == 0


# --------------------------------------------------------------------------
# (e) what stays refused across ranks
# --------------------------------------------------------------------------

BASE = ["--arch", "stablelm_1_6b", "--smoke", "--mesh", "4x2", "--device",
        "cpu", "--dist-backend", "gloo"]
REFUSALS = {
    "pods": (["--mesh", "2x2x2"], 2,
             r"a pod mesh \(its prefill is dense\).*dense prefill across "
             "ranks"),
    "moe": (["--arch", "granite_moe_3b_a800m"], 2,
            r"non-dense family \(moe\).*MoE, SSM, hybrid"),
    "dense_prefill": (["--prefill-impl", "dense"], 2,
                      "dense prefill across ranks"),
    "one_worker": (["--mesh", "1x2"], 1, "dense prefill across ranks"),
    "split": ([], 3, "3 ranks do not divide the data axis"),
    "nccl_one_card": (["--dist-backend", "nccl", "--device", "cuda:0"], 2,
                      "NCCL cannot run two ranks on one device"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_serve_cli_refusals_name_their_item(name, monkeypatch):
    extra, size, msg = REFUSALS[name]
    for k, v in (("WORLD_SIZE", size), ("RANK", 0), ("LOCAL_RANK", 0),
                 ("LOCAL_WORLD_SIZE", size)):
        monkeypatch.setenv(k, str(v))

    def joined(*a, **k):
        raise AssertionError("joined a process group")
    monkeypatch.setattr(wire, "join", joined)
    with pytest.raises(ValueError, match=msg) as e:
        servelib.loop_from_args(servelib.parse_args(BASE + extra))
    assert "ROADMAP Queue A" in str(e.value) or name in ("split",
                                                         "nccl_one_card")
    assert not torch.distributed.is_initialized()


def test_ranked_loop_refuses_overlap(two):
    """Refused before its slice; now the ranked loop takes
    ``ParallelConfig.overlap``: every prefill plan is the double-buffered
    one, KV rounds cross the ranks, and decode (no rounds) is as
    without it."""
    for kind in KINDS:
        for r in _by_rank(two, "loop_overlap", kind):
            rk = r["report"]["ranks"]
            assert rk["prefill_ship_bytes"] > 0
            assert rk["prefill_ship_wait_s"] <= rk["prefill_ship_s"]
        a = _by_rank(two, "loop_overlap", kind, "report", "ranks")
        b = _by_rank(two, "loop", kind, "report", "ranks")
        for x, y in zip(a, b):
            assert (x["merge_bytes"], x["insert_bytes"]) == (
                y["merge_bytes"], y["insert_bytes"])


@pytest.mark.parametrize("kind", KINDS)
def test_ranked_overlap_loop_tokens_match(kind, two, jax_tokens,
                                          stacked_overlap):
    """The ranked ``overlap`` loop token for token the one-process
    ``overlap`` loop and the reference's 1x1 loop (a one-worker mesh
    plans no rounds, so ``overlap`` changes nothing there:
    ``test_serving_prefill_with_overlap_matches_jax``'s hold)."""
    toks = [_in_order(t) for t in _by_rank(two, "loop_overlap", kind,
                                           "tokens")]
    assert toks[1] == toks[0] and len(toks[0]) == len(J.SERVE_LENS)
    assert toks[0] == _in_order(stacked_overlap[kind]["tokens"])
    assert toks[0] == _in_order(jax_tokens[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_ranked_overlap_loop_bytes_equal_their_pricing(kind, two,
                                                       stacked_overlap):
    """Its prefill ships, inserts and merges each exactly their pricing,
    every batch a plan-cache hit and nothing built after warmup."""
    for r in _by_rank(two, "loop_overlap", kind):
        rk = r["report"]["ranks"]
        for what in ("prefill_ship_bytes", "insert_bytes", "merge_bytes"):
            assert rk[what] == rk[what + "_priced"], what
        assert r["recompiles"] == 0
        assert r["counts"] == stacked_overlap[kind]["counts"]
        pcs = r["report"]["plan_cache"]
        assert pcs["misses"] == 0
        assert pcs["hits"] == r["report"]["prefill_batches"]
