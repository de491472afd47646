"""The jobs the ranks of ``tests/test_torch_ranks.py`` run.

Each rank is a spawned process that joins a gloo process group on
localhost through the port's own ``runtime/wire.join`` (torchrun's
environment variables, set here), runs one job on the CPU and saves its
result for the test process to read.  Nothing here imports JAX or the
reference package: the spawned ranks import only this module and the
port.  :func:`run` gives every group one deadline, so a hung rank fails
its test instead of holding the run.
"""

import dataclasses
import json
import multiprocessing as mp
import os
import socket
import time
import traceback

import numpy as np
import torch

# the executor cases: the layout of tests/test_torch_train.py's
N, TPW, BS, H, KH, D = 4, 64, 16, 4, 2, 32
SEQLENS = [90, 50, 40, 30, 26, 20]
EXEC_CASES = [(impl, mask, coalesce) for impl in ("fused_xla", "xla")
              for mask in ("causal", "swa:24") for coalesce in (1, 4)]
# the ship cases: partial permutations over 4 frames, pairs inside and
# across every split
PERMS = (((0, 2), (1, 0), (3, 1), (2, 3)), ((0, 1), (2, 0), (1, 3)),
         ((3, 2),), ((1, 2), (2, 1), (0, 3), (3, 0)))
SHIP_SHAPE = (N, 3, 2, 4, 8)        # [frames, rows, heads, bs, D]
FORMATS = ("f32", "bf16", "int8")
WIRES = ("f32", "bf16", "int8")
# the train step: tests/test_torch_train.py's smoke case, f32
ARCH, STEP_TPW, STEP_BS = "stablelm_1_6b", 128, 32
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def loader_kw(cfg) -> dict:
    return dict(dist="real_world", n_frames=N, tokens_per_worker=STEP_TPW,
                vocab_size=cfg.vocab_size, seed=0)


def smoke_cfg():
    from repro_torch.configs.base import smoke_config
    return dataclasses.replace(smoke_config(ARCH), param_dtype="float32")


def ship_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHIP_SHAPE).astype(np.float32)
    g = rng.normal(size=SHIP_SHAPE).astype(np.float32)
    x[1, 2] = 0.0                       # an all-zero group (int8 scale 0)
    return x, g


def ship_case(x, g, perm, fmt, ranks=None):
    """``ship`` forward and backward: the received payloads and the
    gradient of ``sum(out * g)`` (global arrays, or a rank's share)."""
    from repro_torch.runtime import wire
    xt = torch.from_numpy(x).requires_grad_(True)
    y = wire.ship(xt, perm, wire.WireFormat(fmt), ranks)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    return y.detach().numpy(), dx.numpy()


def exec_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(N, TPW, h, D)).astype(np.float32)
           for h in (H, KH, KH)]
    cot = rng.normal(size=(N, TPW, H, D)).astype(np.float32)
    return qkv, cot


def exec_case(impl, mask, coalesce, ranks, overlap=False):
    """FCP attention forward and backward on ``ranks``'s frames: o and
    dq, dk, dv (a rank's share, or all frames without a group), on the
    serial or the double-buffered (``overlap``) round loop's plan."""
    from repro_torch.core import executor as ex
    from repro_torch.core.schedule import make_schedule
    from repro_torch.runtime import wire
    ranks = ranks or wire.STACKED
    sched = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                          head_dim=D, mask=mask, coalesce=coalesce,
                          overlap=overlap)
    lo, hi = ranks.share(N)
    qkv, cot = exec_inputs()
    xs = [torch.from_numpy(x[lo:hi]).requires_grad_(True) for x in qkv]
    o = ex.fcp_attention(*xs, ex.schedule_tables(sched, "cpu", 1, ranks),
                         spec=sched.spec, cfg=ex.ExecConfig(impl=impl))
    g = torch.autograd.grad((o * torch.from_numpy(cot[lo:hi])).sum(), xs)
    return [o.detach().numpy()] + [x.numpy() for x in g]


def reshuffle_case(ranks=None):
    """``fcp_reshuffle`` on ``ranks``'s frames: a hidden state with an
    integer position channel riding as f32, stream -> schedule ->
    stream, with the gradient of the round trip; and ``layout="sched"``
    attention between two reshuffles beside the ``layout="stream"``
    call (no gradient)."""
    from repro_torch.core import executor as ex
    from repro_torch.core.schedule import make_schedule
    from repro_torch.runtime import wire
    ranks = ranks or wire.STACKED
    sched = make_schedule(SEQLENS, N, TPW, BS, n_q_heads=H, n_kv_heads=KH,
                          head_dim=D, coalesce=4)
    tabs, spec = ex.schedule_tables(sched, "cpu", 1, ranks), sched.spec
    lo, hi = ranks.share(N)
    rng = np.random.default_rng(2)
    hid = rng.normal(size=(N, TPW, 24)).astype(np.float32)
    pos = sched.batch.positions.reshape(N, TPW).astype(np.float32)
    x = np.concatenate([hid, pos[..., None]], -1)
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)[lo:hi])
    x = torch.from_numpy(x[lo:hi]).requires_grad_(True)
    xs = ex.fcp_reshuffle(x, tabs, spec=spec)
    back = ex.fcp_reshuffle(xs, tabs, spec=spec, reverse=True)
    (gx,) = torch.autograd.grad(back, x, g)
    qkv, _ = exec_inputs(3)
    q, k, v = (torch.from_numpy(a[lo:hi]) for a in qkv)
    with torch.no_grad():
        o_stream = ex.fcp_attention(q, k, v, tabs, spec=spec)

        def move(a, reverse=False):
            return ex.fcp_reshuffle(a.reshape(hi - lo, TPW, -1), tabs,
                                    spec=spec, reverse=reverse
                                    ).reshape(a.shape)
        o_sched = ex.fcp_attention(move(q), move(k), move(v), tabs,
                                   spec=spec, layout="sched")
        o_sched = move(o_sched, reverse=True)
    return {"x": x.detach().numpy(), "moved": xs.detach().numpy(),
            "back": back.detach().numpy(), "g": g.numpy(),
            "gx": gx.numpy(), "o_stream": o_stream.numpy(),
            "o_sched": o_sched.numpy()}


# the flags of the pipelined, overlapped train step
BOTH = dict(overlap=True, layer_pipeline=True)


def step_parts(cfg, np_params, ranks, wire_fmt="f32", flags=None):
    """The model, mesh, batch, attention closure and parameters of the
    smoke train step on ``ranks``'s frames (``flags``: ParallelConfig's
    ``overlap`` and ``layer_pipeline``)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import SyntheticLoader
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime import wire
    ranks = ranks or wire.STACKED
    pcfg = ParallelConfig(block_size=STEP_BS, attention_impl="fused_xla",
                          comm_dtype=wire_fmt, **(flags or {}))
    mesh = StackedMesh((N, 1)).with_ranks(ranks)
    b = SyntheticLoader(**loader_kw(cfg)).next()
    sched = T.build_schedule(cfg, pcfg, b.seqlens, N, STEP_TPW)
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla", 1,
                                ranks)
    batch = T.batch_arrays(b, cfg, "cpu",
                           frames=mesh.frames if ranks.grouped else None)
    return (Model(cfg), mesh, pcfg, batch, attn,
            params_from_numpy(np_params, "cpu"), sched)


def step_grads(cfg, np_params, ranks=None, flags=None):
    """Step-0 loss and gradient leaves (summed over the ranks)."""
    from repro_torch.launch import train as T
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import wire
    model, _, pcfg, batch, attn, params, _ = step_parts(
        cfg, np_params, ranks, flags=flags)
    loss, grads = T.value_and_grad(model, pcfg, attn)(params, batch)
    out = wire.all_sum([loss] + adamw.tree_leaves(grads),
                       ranks or wire.STACKED)
    return float(out[0]), [g.numpy() for g in out[1:]]


def step_log(cfg, np_params, ranks=None, steps: int = 3, flags=None):
    """Three train steps on the first batch: (loss, gnorm) each and the
    parameter leaves after them."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as T
    from repro_torch.optimizer import adamw
    model, mesh, pcfg, batch, attn, params, _ = step_parts(
        cfg, np_params, ranks, flags=flags)
    step = T.build_train_step(model, mesh, pcfg, TrainConfig(**TCFG), attn)
    opt, log = adamw.init(params), []
    for _ in range(steps):
        params, opt, _, loss, gnorm = step(params, opt, None, batch)
        log.append((float(loss), float(gnorm)))
    return log, [p.detach().numpy() for p in adamw.tree_leaves(params)]


def step_bytes(cfg, np_params, ranks, wire_fmt, flags=None):
    """The bytes this rank sends in one train step under ``wire_fmt``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as T
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import wire
    model, mesh, pcfg, batch, attn, params, _ = step_parts(
        cfg, np_params, ranks, wire_fmt, flags)
    step = T.build_train_step(model, mesh, pcfg, TrainConfig(**TCFG), attn)
    wire.reset_wire_stats()
    step(params, adamw.init(params), None, batch)
    return wire.wire_stats()


def trainer(ranks, checkpoint_dir=None):
    """The CLI's plain Trainer over the ranks (random seeded weights),
    checkpointing every step into ``checkpoint_dir`` when given."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import StackedMesh
    return T.Trainer(smoke_cfg(), ParallelConfig(block_size=STEP_BS,
                                                 checkpoint_every=1),
                     TrainConfig(**TCFG), StackedMesh((N, 1)),
                     tokens_per_worker=STEP_TPW, dist="real_world",
                     device="cpu", log_every=10**6, attn_impl="fused_xla",
                     checkpoint_dir=checkpoint_dir,
                     dist_backend="gloo" if ranks is not None else None)


def param_leaves(tr) -> list:
    from repro_torch.optimizer import adamw
    return [p.detach().numpy().copy()
            for p in adamw.tree_leaves(tr.state.params)]


def trainer_run(ranks, steps: int = 3):
    """The plain Trainer over the ranks: its records and its parameter
    leaves after ``steps`` steps."""
    tr = trainer(ranks)
    try:
        recs = tr.run(steps)
    finally:
        tr.close()
    return ([(r.loss, r.gnorm) for r in recs], tr.compiled_at,
            param_leaves(tr))


def checkpoint_resume(ranks, checkpoint_dir):
    """Two steps of the ranked Trainer checkpointing each step (rank 0
    writes, every rank shares the directory), then a new ranked Trainer
    on the directory: the step it resumes at, the parameters the first
    ended with and the ones the second restored, and the second's next
    step's (loss, gnorm)."""
    first = trainer(ranks, checkpoint_dir)
    try:
        first.run(2)
    finally:
        first.close()
    again = trainer(ranks, checkpoint_dir)
    try:
        start, restored = again.start, param_leaves(again)
        rec = again.run(3)[0]
    finally:
        again.close()
    return {"start": start, "saved": param_leaves(first),
            "restored": restored, "next": (rec.loss, rec.gnorm)}


RANKS_MODULE_ARGV = ["--arch", ARCH, "--smoke", "--mesh", f"{N}x1", "--dist",
               "real_world", "--block-size", "64", "--tokens-per-worker",
               "256", "--device", "cpu", "--dist-backend", "gloo",
               "--no-supervised"]


RANKS_MODULE_RUNS = (("fused_xla", 2), ("xla", 1),
                     ("fused_xla+layer-pipeline+overlap", 1))


def ranks_module_run(ranks, out_dir):
    """``repro_torch.launch.ranks`` (the checks the card's smoke runs):
    two CLI runs and the gradient check; each rank's reports and rank
    0's gradient check.  It leaves the group at its end."""
    from repro_torch.launch import ranks as ranks_mod
    ranks_mod.main(["--out", out_dir, "--runs", ",".join(
        f"{name}:{steps}" for name, steps in RANKS_MODULE_RUNS),
        "--grad-layers", "2", "--", *RANKS_MODULE_ARGV])
    out = {}
    for impl, _ in RANKS_MODULE_RUNS:
        with open(os.path.join(out_dir, impl,
                               f"rank{ranks.rank}.json")) as f:
            out[impl] = json.load(f)
    if ranks.rank == 0:
        with open(os.path.join(out_dir, "grads.json")) as f:
            out["grads"] = json.load(f)
    return out


# --------------------------------------------------------------------------
# the jobs
# --------------------------------------------------------------------------

def job_ships(ranks):
    lo, hi = ranks.share(N)
    x, g = ship_inputs()
    return {(p, fmt): ship_case(x[lo:hi], g[lo:hi], perm, fmt, ranks)
            for p, perm in enumerate(PERMS) for fmt in FORMATS}


def job_four(ranks, params_path):
    """The four-rank tests: the ships, and the pod step with both flags,
    each pod split over two ranks."""
    np_params = torch.load(params_path, weights_only=False)
    return {"ships": job_ships(ranks),
            "pod_step_both": pod_step(np_params, ranks, BOTH)}


def job_two(ranks, params_path):
    """Everything the two-rank tests hold: the ships, the executor
    cases, the train step's gradients, steps and wire bytes, the pod
    step with both flags (a pod a rank), the plain Trainer, its
    checkpoint and resume, and ``launch/ranks.py`` (last: it leaves the
    group)."""
    cfg = smoke_cfg()
    np_params = torch.load(params_path, weights_only=False)
    out = {"ships": job_ships(ranks),
           "exec": {c: exec_case(*c, ranks) for c in EXEC_CASES},
           "exec_overlap": {c: exec_case(*c, ranks, overlap=True)
                            for c in EXEC_CASES},
           "reshuffle": reshuffle_case(ranks),
           "grads": step_grads(cfg, np_params, ranks),
           "steps": step_log(cfg, np_params, ranks),
           "bytes": {w: step_bytes(cfg, np_params, ranks, w)
                     for w in WIRES},
           "grads_both": step_grads(cfg, np_params, ranks, BOTH),
           "steps_both": step_log(cfg, np_params, ranks, flags=BOTH),
           "bytes_both": {w: step_bytes(cfg, np_params, ranks, w, BOTH)
                          for w in WIRES},
           "pod_step_both": pod_step(np_params, ranks, BOTH)}
    out["trainer"] = trainer_run(ranks)
    out["checkpoint"] = checkpoint_resume(ranks, os.path.join(
        os.path.dirname(params_path), "checkpoints"))
    out["ranks_module"] = ranks_module_run(ranks, os.path.join(
        os.path.dirname(params_path), "ranks_module"))
    return out


# --------------------------------------------------------------------------
# serving across ranks (tests/test_torch_serve_ranks.py)
# --------------------------------------------------------------------------

# tests/multidevice/run_decode.py's cases: (B, S, HQ, KH, D, the mesh's
# data and model sizes, batch split over the ranks, seed); the batch-split
# case hands each rank its rows, the others split the sequence
DECODE_CASES = {"batch": (8, 512, 4, 2, 32, 2, 4, True, 0),
                "long": (1, 1024, 4, 4, 32, 2, 4, False, 1),
                "model_only": (4, 256, 2, 1, 16, 1, 8, False, 2)}
# a cache write: one row per slot, the last past the cache
UPDATE_CASE = (6, 64, 2, 8)                  # B, S, KH, D
MOVE_ROWS = 12                               # rows a rank holds
# the serving loop: tests/multidevice/run_serve.py's budget (4 x 64) and
# cache; the prompts are tests/test_torch_serving.py's LENS and one wider
# than a rank's 128 prefill tokens
SERVE_LENS = [5, 23, 64, 128, 200]
SERVE_MESH = (4, 2)
SERVE_NEW = 6


def serve_config(kind: str) -> dict:
    return dict(cache_len=320, decode_slots=4 if kind == "decode" else 2,
                queue_depth=8, max_new_tokens=8,
                prefill_tokens_per_worker=64, bucket_min=16, kind=kind)


def serve_prompts(vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, (L,)).astype(np.int32)
            for L in SERVE_LENS]


def decode_inputs(case):
    B, S, HQ, KH, D, *_, seed = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, HQ, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    return q, kc, vc, lengths


def decode_case(case, ranks=None):
    """``cp_decode_attention`` on ``ranks``'s share of a case (its rows,
    or its sequence shards), or on all of it without a group."""
    from repro_torch.core import executor as ex
    from repro_torch.runtime import wire
    ranks = ranks or wire.STACKED
    B, S, *_, nd, nm, batch_split, _ = DECODE_CASES[case]
    q, kc, vc, ln = (torch.from_numpy(x) for x in decode_inputs(case))
    seq_ranks = wire.STACKED
    n_shards = nm if batch_split else nd * nm
    if batch_split:
        lo, hi = ranks.share(B)
        q, kc, vc, ln = q[lo:hi], kc[lo:hi], vc[lo:hi], ln[lo:hi]
    else:
        lo, hi = ranks.share(S)
        kc, vc = kc[:, lo:hi], vc[:, lo:hi]
        seq_ranks = ranks
    return ex.cp_decode_attention(q, kc.contiguous(), vc.contiguous(), ln,
                                  n_shards=n_shards,
                                  cfg=ex.ExecConfig(impl="xla"),
                                  ranks=seq_ranks).numpy()


def update_inputs():
    B, S, KH, D = UPDATE_CASE
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    new = rng.normal(size=(B, KH, D)).astype(np.float32)
    pos = np.array([0, S // 2 - 1, S // 2, S - 1, 3, S], np.int32)
    return cache, new, pos


def update_case(ranks=None):
    """``cp_cache_update`` on ``ranks``'s positions of the cache."""
    from repro_torch.core import executor as ex
    from repro_torch.runtime import wire
    ranks = ranks or wire.STACKED
    cache, new, pos = update_inputs()
    lo, hi = ranks.share(cache.shape[1])
    c = torch.from_numpy(cache[:, lo:hi].copy())
    return ex.cp_cache_update(c, torch.from_numpy(new), torch.from_numpy(pos),
                              ranks).numpy()


def move_table(size: int, seed: int = 0) -> list:
    """Row moves over ``size`` ranks of MOVE_ROWS rows each, every
    destination row written once: runs of rows across ranks and inside
    one, then each other row from a random source row, in random order."""
    M = MOVE_ROWS
    table = [(0, size - 1, 2, 0, 3), (size - 1, size - 1, 4, 8, 2),
             (size - 1, 0, 0, 5, 4)]
    done = {(size - 1) * M + r for r in (0, 1, 2, 8, 9)} | {5, 6, 7, 8}
    rng = np.random.default_rng(seed)
    for d in rng.permutation(size * M):
        if int(d) in done:
            continue
        src = int(rng.integers(0, size * M))
        table.append((src // M, int(d) // M, src % M, int(d) % M, 1))
    return table


def moved(src: np.ndarray, table) -> np.ndarray:
    """The rows ``table`` moves, as one local gather over every rank's
    rows."""
    out, M = np.zeros_like(src), MOVE_ROWS
    for s, d, a, b, n in table:
        out[d * M + b:d * M + b + n] = src[s * M + a:s * M + a + n]
    return out


def move_inputs(size: int):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(size * MOVE_ROWS, 3, 5)).astype(np.float32),
            np.arange(size * MOVE_ROWS * 7, dtype=np.int32).reshape(-1, 7))


def move_case(dtype_name, ranks):
    """``wire.move`` of :func:`move_table` on this rank's rows: a pair of
    tensors along dim 0 (its sent bytes and their price), then one along
    dim 1."""
    from repro_torch.runtime import wire
    x, e = move_inputs(ranks.size)
    x = torch.from_numpy(x).to(getattr(torch, dtype_name))
    e = torch.from_numpy(e)
    lo, hi = ranks.rank * MOVE_ROWS, (ranks.rank + 1) * MOVE_ROWS
    a, f = x[lo:hi].clone(), e[lo:hi].clone()
    b, g = torch.zeros_like(a), torch.zeros_like(f)
    table = move_table(ranks.size)
    wire.reset_wire_stats()
    wire.move([a, f], [b, g], table, ranks)
    sent = wire.wire_stats()["move_bytes"]
    at = a.transpose(0, 1).contiguous()
    bt = torch.zeros_like(at)
    wire.move(at, bt, table, ranks, dim=1)
    return {"dst": b.float().numpy(), "raw": b.view(torch.int16 if
                                                    b.dtype == torch.bfloat16
                                                    else torch.int32).numpy(),
            "extra": g.numpy(), "dst_t": bt.transpose(0, 1).float().numpy(),
            "sent": sent,
            "priced": wire.move_bytes(table, ranks,
                                      a[0].nbytes + f[0].nbytes)}


def serve_loop(kind, np_params, mesh=SERVE_MESH, ranks=None, overlap=False):
    """The port's ServingLoop on the f32 smoke weights (a rank's share
    under ``ranks``; ``overlap``: the double-buffered prefill rounds)."""
    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime.serving import ServingLoop
    m = StackedMesh(mesh)
    if ranks is not None:
        m = m.with_ranks(ranks)
    return ServingLoop(Model(smoke_cfg()), params_from_numpy(np_params,
                                                             "cpu"),
                       m, ParallelConfig(block_size=16, overlap=overlap),
                       ServeConfig(**serve_config(kind)), device="cpu",
                       attn_impl="fused_xla")


def serve_run(kind, np_params, mesh=SERVE_MESH, ranks=None, overlap=False):
    """Warmup and the stream: every request's tokens, the programs built
    after warmup and the report (its ``ranks`` bytes too)."""
    loop = serve_loop(kind, np_params, mesh, ranks, overlap)
    base = loop.warmup()
    rep = loop.run(serve_prompts(smoke_cfg().vocab_size), max_new=SERVE_NEW)
    return {"tokens": {r.rid: list(map(int, r.tokens))
                       for r in loop.stats.finished},
            "recompiles": (sum(loop.compile_counts().values())
                           - sum(base.values())),
            "counts": loop.compile_counts(), "report": rep}


def job_serve(ranks, params_path=None):
    """Everything the serving tests hold across ``ranks``: the decode
    attention and cache write, the row moves and (given the weights) the
    ranked loop under both kinds, serial and with ``overlap``."""
    out = {"decode": {c: decode_case(c, ranks) for c in DECODE_CASES},
           "update": update_case(ranks),
           "move": {d: move_case(d, ranks)
                    for d in ("float32", "bfloat16")}}
    if params_path is not None:
        np_params = torch.load(params_path, weights_only=False)
        out["loop"] = {k: serve_run(k, np_params, ranks=ranks)
                       for k in ("decode", "long")}
        out["loop_overlap"] = {k: serve_run(k, np_params, ranks=ranks,
                                            overlap=True)
                               for k in ("decode", "long")}
    return out


# --------------------------------------------------------------------------
# the Supervisor across ranks (tests/test_torch_supervisor_ranks.py)
# --------------------------------------------------------------------------

# smoke widths, f32; the drills of tests/test_torch_elastic.py and
# tests/test_torch_pods.py cut to few steps: a worker dies at step 3
# after the checkpoint of step 1, a pod dies at step 3 and rejoins at 5
SUP_BS, SUP_TPW, SUP_EVERY = 64, 128, 2
SUP_KILL = dict(total=5, fail_step=3, fail_round=2, every=SUP_EVERY)
SUP_POD = dict(total=7, fail_step=3, fail_round=1, rejoin_step=5,
               every=SUP_EVERY)
SUP_STRAGGLER = dict(total=6, window=2, cooldown=2, factor=2.0)
STRAGGLER_TPW = 256                  # blocks enough for a speed to move
SUP_MASK = "causal"
# the ranked pod step of tests/test_torch_pods.py's
# test_pod_train_step_matches_jax: 2 pods x 2 workers, one pod a rank
POD_P, POD_N, POD_TPW, POD_BS = 2, 2, 128, 32
POD_TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=3,
                grad_compression=True)
# uneven ships: 3 frames over 2 ranks (1 + 2), pairs inside and across
UNEVEN_PERMS = (((0, 2), (2, 1), (1, 0)), ((1, 2), (2, 0)), ((0, 1),))
CLI_ARGV = ["--arch", ARCH, "--smoke", "--dist", "real_world",
            "--block-size", "64", "--tokens-per-worker", "256", "--device",
            "cpu", "--attn-impl", "fused_xla", "--override",
            "param_dtype=float32", "--steps", "2"]


def sup_pcfg(**kw):
    from repro_torch.configs.base import ParallelConfig
    kw.setdefault("checkpoint_every", SUP_EVERY)
    return ParallelConfig(block_size=SUP_BS, remat=False, coalesce=4,
                          in_dtype_bytes=4.0, attn_mask=SUP_MASK, **kw)


class _Recorder:
    """A Supervisor factory: every Supervisor it makes keeps the
    schedules of the first step after each recovery (``after``), and
    the factory keeps the Supervisors (``made``)."""

    def __init__(self, ranked, pcfg, n_workers, pods=1, compression=False,
                 total=8, tpw=SUP_TPW):
        self.ranked, self.pcfg, self.tpw = ranked, pcfg, tpw
        self.n_workers, self.pods = n_workers, pods
        self.compression, self.total, self.made = compression, total, []

    def __call__(self, ckpt_dir, **kw):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.launch import train as T

        class Recording(T.Supervisor):
            def _recover(self, e, step):
                self._record_next = True
                return super()._recover(e, step)

            def _plan(self, seqlens, pods, n, speeds):
                scheds, keys = super()._plan(seqlens, pods, n, speeds)
                if getattr(self, "_record_next", False):
                    self._record_next = False
                    self.after.append(sched_record(scheds, seqlens, pods, n,
                                                   speeds))
                return scheds, keys
        tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=self.total,
                           grad_compression=self.compression)
        sup = Recording(smoke_cfg(), self.pcfg, tcfg,
                        n_workers=self.n_workers, tokens_per_worker=self.tpw,
                        pods=self.pods, dist="real_world",
                        checkpoint_dir=ckpt_dir, checkpoint_keep=8,
                        verbose=False, device="cpu", attn_impl="fused_xla",
                        dist_backend="gloo" if self.ranked else None, **kw)
        sup.after = []
        self.made.append(sup)
        return sup


def sched_record(scheds, seqlens, pods, n, speeds) -> dict:
    """A replan's inputs and its plan arrays (one mask group)."""
    (sched,) = scheds.values()
    arr = sched.arrays
    return {"seqlens": [int(x) for x in seqlens], "pods": pods, "n": n,
            "speeds": None if speeds is None else list(speeds),
            "arrays": {f.name: np.asarray(getattr(arr, f.name))
                       for f in dataclasses.fields(arr)}}


def sup_view(rec: _Recorder, res: dict) -> dict:
    """A drill's result with its primary Supervisor's recoveries, rejoins,
    schedules after each recovery and this rank's frames of the fleet it
    ended on (None on an idle rank)."""
    sup = rec.made[0]
    res = dict(res)
    res.update(recoveries=sup.recoveries, rejoins=sup.rejoins,
               after=sup.after, frames=(sup._frames(sup.pods, sup.n)
                                        if sup.ranks is not None else None),
               saved_steps=(sup.manager.steps() if sup.manager is not None
                            and sup.manager.dir.exists() else None))
    return res


def supervisor_drills(ranked, root) -> dict:
    """The kill drills (worker 1 and worker 0 of a 2x1 fleet, worker 1
    of a 4x1 fleet, again with ``--overlap --layer-pipeline``), the
    straggler drill and the pod drill (2x2x1)."""
    from repro_torch.launch import drills
    out = {}
    for name, n, worker, flags in (("kill_w1", 2, 1, {}),
                                   ("kill_w0", 2, 0, {}),
                                   ("split", 4, 1, {}),
                                   ("split_both", 4, 1, BOTH)):
        rec = _Recorder(ranked, sup_pcfg(**flags), n,
                        total=SUP_KILL["total"])
        out[name] = sup_view(rec, drills.kill_drill(
            rec, os.path.join(root, name), fail_worker=worker, **SUP_KILL))
    st = dict(SUP_STRAGGLER)
    rec = _Recorder(ranked, sup_pcfg(checkpoint_every=0,
                                     health_window=st["window"],
                                     demote_cooldown=st["cooldown"]), 2,
                    total=st["total"], tpw=STRAGGLER_TPW)
    out["straggler"] = sup_view(rec, drills.straggler_drill(
        rec, worker=1, **st))
    rec = _Recorder(ranked, sup_pcfg(), POD_N, pods=POD_P, compression=True,
                    total=SUP_POD["total"])
    out["pod"] = sup_view(rec, drills.pod_drill(
        rec, os.path.join(root, "pod"), **SUP_POD))
    return out


def pod_step(np_params, ranks=None, flags=None):
    """The 2x2x1 pod train step with error-feedback compression on
    ``ranks``'s frames (two ranks: one pod a rank; four: half a pod;
    ``flags``: ParallelConfig's ``overlap`` and ``layer_pipeline``):
    step-0 loss and gradients summed over the ranks, then three steps'
    (loss, gnorm) and the bytes this rank sent in each."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data import SyntheticLoader
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import compression, wire
    ranks = ranks or wire.STACKED
    cfg = smoke_cfg()
    kw = dict(dist="real_world", n_frames=POD_N, tokens_per_worker=POD_TPW,
              vocab_size=cfg.vocab_size, pods=POD_P, seed=0)
    b = SyntheticLoader(**kw).next()
    pcfg = ParallelConfig(block_size=POD_BS, **(flags or {}))
    mesh = StackedMesh((POD_P, POD_N, 1)).with_ranks(ranks)
    sched = T.build_schedule(cfg, pcfg, b.seqlens, POD_N, POD_TPW)
    masks = T.layer_mask_specs(cfg, pcfg)
    attn = T.attention_closures(cfg, pcfg, masks, [masks[0]],
                                {masks[0]: sched}, "cpu", "fused_xla", POD_P,
                                ranks)
    model, params = Model(cfg), params_from_numpy(np_params, "cpu")
    batch = T.batch_arrays(b, cfg, "cpu",
                           frames=mesh.frames if ranks.grouped else None)
    loss, grads = T.value_and_grad(model, pcfg, attn)(params, batch)
    summed = wire.all_sum([loss] + adamw.tree_leaves(grads), ranks)
    step = T.build_train_step(model, mesh, pcfg, TrainConfig(**POD_TCFG),
                              attn)
    opt, res, log = adamw.init(params), compression.init_residuals(params), []
    sent = []
    for _ in range(3):
        wire.reset_wire_stats()
        params, opt, res, loss_i, gnorm = step(params, opt, res, batch)
        log.append((float(loss_i), float(gnorm)))
        sent.append(wire.wire_stats()["sent_bytes"])
    return {"loss": float(summed[0]),
            "grads": [g.numpy() for g in summed[1:]], "log": log,
            "frames": mesh.frames, "sent_bytes": sent}


def uneven_ships(ranks) -> dict:
    """``ship`` of 3 frames over the ranks' uneven shares, forward and
    backward, each format; a broadcast from rank 1 and a one-member
    subgroup's sum."""
    from repro_torch.runtime import wire
    x, g = ship_inputs()
    x, g = x[:3], g[:3]
    lo, hi = ranks.share(3)
    out = {"frames": (lo, hi), "ships": {}}
    for p, perm in enumerate(UNEVEN_PERMS):
        for fmt in FORMATS:
            xt = torch.from_numpy(x[lo:hi]).requires_grad_(True)
            y = wire.ship(xt, perm, wire.WireFormat(fmt), ranks, 3)
            (dx,) = torch.autograd.grad(
                (y * torch.from_numpy(g[lo:hi])).sum(), xt)
            out["ships"][p, fmt] = (y.detach().numpy(), dx.numpy())
    t = [torch.full((3, 2), float(ranks.rank)), torch.arange(
        5, dtype=torch.int32) * (ranks.rank + 1)]
    wire.reset_wire_stats()
    wire.broadcast(t, 1, ranks)
    out["broadcast"] = ([x.numpy() for x in t],
                        wire.wire_stats()["broadcast_bytes"],
                        wire.broadcast_bytes(t, 1, ranks))
    one = wire.subgroup([1], ranks)
    out["one"] = None if one is None else (
        one.size, one.rank, one.members,
        float(wire.all_sum([torch.tensor([2.5])], one)[0]))
    return out


# the CLI runs: a mesh, and the flags of one with both
CLI_RUNS = {"2x1": [], "2x2x1": [],
            "2x1+both": ["--overlap", "--layer-pipeline"]}


def cli_runs() -> dict:
    """The train CLI's default loop on each of CLI_RUNS (the Supervisor
    across ranks under torchrun's environment, stacked without it)."""
    from repro_torch.launch import train as T
    out = {}
    for mesh, flags in CLI_RUNS.items():
        sup = T.main(CLI_ARGV + flags + ["--mesh", mesh.split("+")[0]] + (
            ["--dist-backend", "gloo"] if "WORLD_SIZE" in os.environ
            else []))
        rep = sup.report(0.0)
        out[mesh] = {"type": type(sup).__name__,
                     "fleet": (sup.pods, sup.n),
                     "log": [(r.loss, r.gnorm) for r in sup.history],
                     "members": sup.members, "frames": rep["frames"],
                     "records": len(rep["records"])}
    return out


def small_cache_pod(root) -> dict:
    """The pod drill's loss and rejoin on a ranked Supervisor whose step
    cache holds one program (``plan_cache_size=1``): the survivor rank
    evicts the full fleet's program for its own and builds it again at
    the rejoin, where the idle rank's cache still holds it."""
    from repro_torch.optimizer import adamw
    from repro_torch.runtime import elastic, wire
    rec = _Recorder(True, sup_pcfg(plan_cache_size=1), POD_N, pods=POD_P,
                    compression=True, total=SUP_POD["total"])
    sup = rec(os.path.join(root, "small_cache"))
    sup.run(SUP_POD["total"], rejoin_step=SUP_POD["rejoin_step"],
            fail=elastic.InjectedFailure(pod=1, step=SUP_POD["fail_step"],
                                         round=SUP_POD["fail_round"]))
    return {"compiled_at": list(sup.compiled_at),
            "records": [dataclasses.asdict(r) for r in sup.history],
            "param_digest": wire.digest(
                adamw.tree_leaves(sup.state.params)).hex()}


def job_supervisor(ranks, params_path, root):
    """Everything the Supervisor tests hold across the ranks: uneven
    ships, a broadcast and a one-member group; the drills; a rejoin
    after the survivors evicted the fleet's step program; the ranked pod
    step; the CLI's default loop."""
    np_params = torch.load(params_path, weights_only=False)
    out = {"uneven": uneven_ships(ranks),
           "drills": supervisor_drills(True, root),
           "small_cache": small_cache_pod(root),
           "pod_step": pod_step(np_params, ranks),
           "cli": cli_runs()}
    return out


JOBS = {"four": job_four, "two": job_two, "serve": job_serve,
        "supervisor": job_supervisor}


def _child(rank, size, port, job, kwargs, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    torch.set_num_threads(1)
    from repro_torch.runtime import wire
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        out = JOBS[job](wire.join("gloo", "cpu"), **kwargs)
        torch.save(out, path)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        wire.leave()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(size: int, job: str, out_dir, timeout: float = 120.0,
        **kwargs) -> list:
    """Spawn ``size`` ranks running ``job``; their results in rank order.
    Fails (and kills every rank) when one fails or the group outlives
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, size, port, job, kwargs, str(out_dir)))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks of {job!r} still running "
                                     f"after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errs = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            err = os.path.join(str(out_dir), f"rank{r}.pt.err")
            errs.append(f"rank {r} exit {p.exitcode}: " + (
                open(err).read() if os.path.exists(err) else ""))
    if errs:
        raise AssertionError("\n".join(errs))
    return [torch.load(os.path.join(str(out_dir), f"rank{r}.pt"),
                       weights_only=False) for r in range(size)]
