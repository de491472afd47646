"""Serving steps on stacked workers: bucketed FCP prefill and CP decode
(port of ``repro.launch.serve``; every family.  Serving is text-only,
as in the reference: the audio and vision-language backbones take token
prompts, and no front-end input reaches them).

* ``build_prefill_step`` — packed-stream forward through the attention
  it is given (FCP: the fused run kernel; or the dense escape hatch,
  ``runtime/serving.py``), emitting each prompt's last-token logits and
  the KV cache re-laid-out as ``[L, B, S, KH, D]`` (stream order is
  sequence-major for uniform shapes, so this is a reshape).  Recurrent
  families (SSM, hybrid) also emit each sequence's final SSM state and
  conv tail; the hybrid's shared attention runs through FCP, the SSM
  takes no attention.
* ``build_decode_step`` — one token for the whole batch against the
  sequence-sharded cache: ``cp_decode_attention`` (the per-step flash
  kernel at ``Sq = 1``, one launch per layer or shared-block invocation)
  + ``cp_cache_update``; the SSM family's recurrent step takes neither.

**Across processes.**  Under ``torchrun`` the CLI joins a process group
of R ranks (``--dist-backend nccl``, the default, or ``gloo``; ``--device
cuda`` is ``cuda:LOCAL_RANK``), and rank r holds the frames ``[r·D/R,
(r+1)·D/R)`` of the ``DxM`` mesh's data axis: the FCP prefill runs on
its frames' tokens of each packed batch (``tokens=`` of
``build_prefill_step``), and the decode cache is split as
``cache_specs`` places the data axis (``cache_share``): under
``--kind decode`` each rank holds its share of the slots, under
``--kind long`` its share of every slot's sequence, merged across the
ranks at every decode step (``core.executor.cp_decode_attention``).
``runtime/serving.py`` runs the loop; the weights are replicated and
seeded alike.  ``--overlap`` runs the prefill's round loop with each
round's ships started before the run before it and landed after
(``core.executor``), across ranks too.  Pod meshes, the non-dense
families, the dense prefill and a one-worker mesh are refused across
ranks, each with its ROADMAP Queue A item (:func:`check_ranked`).

CLI: PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch stablelm_1_6b --smoke --mesh 4x2 --tokens 16
     PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve --arch stablelm_1_6b \
        --smoke --mesh 4x2 --device cpu --dist-backend gloo --kind long \
        [--overlap]
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import (ModelConfig, ParallelConfig, apply_overrides,
                            get_config, smoke_config)
from ..core import executor as ex
from ..models import Model
from ..models.registry import RECURRENT
from ..runtime import wire
from .train import (build_schedule, make_fcp_attn_fn,  # noqa: F401
                    param_dtype_bytes, ranked_device, refuse_ranked)


def cache_specs(cfg: ModelConfig, mesh, kind: str):
    """(batch axis, sequence axes) of the decode cache.

    decode: batch over data, cache seq over model.  long (batch=1):
    cache seq over (data, model)."""
    if kind == "long":
        return None, tuple(a for a in ("data", "model")
                           if a in mesh.axis_names)
    batch_axis = "data" if "data" in mesh.axis_names else None
    seq_axes = ("model",) if "model" in mesh.axis_names else ()
    return batch_axis, seq_axes


def cache_share(mesh, kind: str, batch: int, seq_len: int
                ) -> tuple[tuple[int, int], tuple[int, int]]:
    """The decode cache's slots ``[lo, hi)`` and positions ``[lo, hi)``
    this rank holds, by ``cache_specs``: a mesh whose ranks form a
    process group splits the data axis over them, so under ``decode``
    rank r holds its data frames' share of the slots and every position,
    and under ``long`` every slot and its frames' shards of the sequence
    (contiguous: shard ``d·M + m`` of data frame d).  Without a group,
    all of both."""
    ranks = getattr(mesh, "ranks", wire.STACKED)
    if kind == "long":
        return (0, batch), ranks.share(seq_len, even=True)
    return ranks.share(batch, even=True), (0, seq_len)


def build_decode_fns(cfg: ModelConfig, mesh, kind: str,
                     impl: str = "fused"):
    """(decode attention, cache update, batch axis, sequence axes): the
    attention over the mesh's cache shards, merged across the ranks the
    sequence is split over (``cache_share``)."""
    batch_axis, seq_axes = cache_specs(cfg, mesh, kind)
    n_shards = int(np.prod([mesh.shape[a] for a in seq_axes]))
    # the sequence is split over the ranks where the data axis carries it
    # (long); under decode the data axis carries the batch
    ranks = (getattr(mesh, "ranks", wire.STACKED) if kind == "long"
             else wire.STACKED)
    attn = functools.partial(ex.cp_decode_attention, n_shards=n_shards,
                             cfg=ex.ExecConfig(impl=impl), ranks=ranks)
    upd = functools.partial(ex.cp_cache_update, ranks=ranks)
    return attn, upd, batch_axis, seq_axes


def build_decode_step(model: Model, mesh, kind: str, impl: str = "fused"):
    attn_fn, upd_fn, batch_axis, seq_axes = build_decode_fns(
        model.cfg, mesh, kind, impl)

    def decode_step(params, tokens, pos, cache):
        logits, cache = model.decode_step(params, tokens, pos, cache,
                                          attn_fn, upd_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step, batch_axis, seq_axes


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def build_prefill_step(model: Model, attn_fn: Callable | None,
                       batch_size: int, seq_len: int, ragged: bool = False,
                       tokens: tuple[int, int] | None = None):
    """Returns ``prefill_step(params, batch) -> (last_logits, cache)``.

    With ``ragged=True`` (attention families only) the step is
    ``prefill_step(params, batch, last_idx)``: each sequence's logits
    are taken at its true last-token index, so right-padded prompts
    prefill exactly (under a causal mask real tokens never attend the
    padding; the padded cache tail is masked at decode time).  Only the
    gathered rows are unembedded.  Recurrent families cannot pad up
    exactly (the state scans the padding), so they refuse ``ragged`` and
    chunk instead (``runtime/serving.py``).

    ``tokens`` is the range ``[t0, t1)`` of the packed stream this rank
    holds (its frames, across ranks; ragged only): ``batch`` is those
    frames, the cache comes back as the range's rows ``[L, t1 - t0, KH,
    D]`` (a prompt at a bucket edge wider than a rank's tokens spans
    ranks), and the logits ``[batch_size, V]`` are those of the rows
    whose last token the range holds, the others zero."""
    cfg = model.cfg
    if tokens is not None and not ragged:
        raise ValueError("a rank's token range takes the ragged step")
    if ragged and cfg.family in RECURRENT:
        raise ValueError(
            f"ragged prefill is exact only for attention families; "
            f"{cfg.family!r} states would scan the padding — chunk the "
            f"prompt instead (round down to a bucket edge and "
            f"teacher-force the tail)")
    if cfg.family in RECURRENT:
        def recurrent_step(params, batch):
            return model.forward_prefill(params, batch, attn_fn,
                                         batch_size=batch_size,
                                         seq_len=seq_len)
        return recurrent_step

    def ranked_step(params, batch, last_idx):
        x, ks, vs = model.forward_prefill(params, batch, attn_fn,
                                          return_features=True)
        lyr, nf, tpw, kh, dh = ks.shape
        t0, t1 = tokens
        # the row's last token, in the stream and in this rank's range
        g = (torch.arange(batch_size, device=x.device) * seq_len
             + last_idx.long())
        held = (g >= t0) & (g < t1)
        xl = x.reshape(nf * tpw, -1)[(g - t0).clamp(0, t1 - t0 - 1)]
        logits = torch.where(held[:, None], model.unembed(params, xl), 0)
        return logits, {"k": ks.reshape(lyr, nf * tpw, kh, dh),
                        "v": vs.reshape(lyr, nf * tpw, kh, dh)}

    if tokens is not None:
        return ranked_step

    def step(params, batch, last_idx):
        x, ks, vs = model.forward_prefill(params, batch, attn_fn,
                                          return_features=True)
        lyr, _, _, kh, dh = ks.shape
        # frames stream -> [L, B, S, KH, D] (stream is sequence-major)
        ks = ks.reshape(lyr, batch_size, seq_len, kh, dh)
        vs = vs.reshape(lyr, batch_size, seq_len, kh, dh)
        xl = x.reshape(batch_size, seq_len, -1)[
            torch.arange(batch_size, device=x.device), last_idx.long()]
        return model.unembed(params, xl), {"k": ks, "v": vs}

    if ragged:
        return step

    def prefill_step(params, batch):
        last = torch.full((batch_size,), seq_len - 1, dtype=torch.int32,
                          device=batch["tokens"].device)
        return step(params, batch, last)

    return prefill_step


# --------------------------------------------------------------------------
# CLI driver: continuous-batching serving over a mixed-length stream
# --------------------------------------------------------------------------

def serving_stream(rng, vocab: int, n: int, min_len: int, max_len: int,
                   ) -> list[np.ndarray]:
    """Synthetic mixed-length request stream (uniform prompt lengths)."""
    lens = rng.integers(min_len, max_len + 1, (n,))
    return [rng.integers(1, vocab, (int(L),)).astype(np.int32)
            for L in lens]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help="a config of repro_torch/configs: dense "
                        "(stablelm_1_6b, codeqwen1_5_7b, llama3_70b, "
                        "qwen1_5_32b/110b), MoE (granite_moe_3b_a800m, "
                        "moonshot_v1_16b_a3b), SSM (mamba2_130m), hybrid "
                        "(zamba2_2_7b), audio (musicgen_large) or "
                        "vision-language (internvl2_1b; both behind the "
                        "front-end stub, which serving does not read).  "
                        "chip_smoke.py serves all but codeqwen1_5_7b, "
                        "qwen1_5_32b and qwen1_5_110b on the card (most at "
                        "a cut depth)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--mesh", default="1x1",
                   help="DxM (data x model) or PxDxM (pod x data x model)"
                        " stacked mesh: prefill frames over pod x data,"
                        " decode slots over data, cache shards over model")
    p.add_argument("--cache-len", type=int, default=512)
    p.add_argument("--kind", default="decode", choices=["decode", "long"])
    p.add_argument("--override", action="append", default=[])
    # serving-loop knobs (ServeConfig / runtime/serving.py)
    p.add_argument("--slots", type=int, default=8,
                   help="decode batch slots (continuous batching)")
    p.add_argument("--requests", type=int, default=32,
                   help="synthetic request-stream length")
    p.add_argument("--tokens", type=int, default=16,
                   help="tokens to generate per request")
    p.add_argument("--queue-depth", type=int, default=64)
    p.add_argument("--prefill-impl", default="fcp",
                   choices=["fcp", "dense"],
                   help="bucketed FCP prefill (CUDA kernel 1), or the "
                        "dense escape hatch (plain PyTorch; also the "
                        "1-worker path and the pod-mesh fallback)")
    p.add_argument("--prefill-tokens-per-worker", type=int, default=256)
    p.add_argument("--strict-prefill", action="store_true",
                   help="fail instead of falling back to dense prefill "
                        "when prefill_impl='fcp' is unsupported on the "
                        "mesh (pod axis)")
    p.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="software-pipelined prefill rounds: start round"
                        " r+1's ships before run r's compute (across ranks"
                        " posted while it runs) and land them after it")
    p.add_argument("--bucket-min", type=int, default=32,
                   help="smallest prefill bucket edge")
    p.add_argument("--block-size", type=int, default=0,
                   help="FCP scheduling block (0 = auto)")
    p.add_argument("--prompt-len", type=int, default=128,
                   help="max prompt length in the synthetic stream")
    p.add_argument("--prompt-min", type=int, default=1,
                   help="min prompt length in the synthetic stream")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels).  Under torchrun"
                        " cuda is cuda:LOCAL_RANK; two ranks share a card"
                        " only when given one (cuda:0), and only over"
                        " gloo")
    p.add_argument("--dist-backend", default="nccl",
                   choices=list(wire.BACKENDS),
                   help="the process group's backend under torchrun (a "
                        "dense model's FCP prefill frames and its decode "
                        "cache split over the ranks; module docstring); "
                        "nothing falls back to another backend")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def check_ranked(cfg: ModelConfig, scfg, mesh_shape: dict,
                 size: int) -> None:
    """Raise, before the process group is joined, for serving this slice
    does not take across ``size`` ranks: a dense model's FCP prefill and
    its decode cache on a ``DxM`` mesh whose D the ranks divide (each
    refusal names its ROADMAP Queue A item)."""
    n_cp = mesh_shape.get("data", 1)
    if "pod" in mesh_shape:
        # a pod mesh prefills through the dense escape hatch
        refuse_ranked("a pod mesh (its prefill is dense)",
                      "the dense prefill across ranks")
    if cfg.family != "dense":
        refuse_ranked(f"a non-dense family ({cfg.family})",
                      "the MoE, SSM, hybrid and multimodal families")
    if scfg.prefill_impl == "dense":
        refuse_ranked("--prefill-impl dense", "the dense prefill across "
                      "ranks")
    if n_cp == 1:
        refuse_ranked("a one-worker mesh (its prefill is dense)",
                      "the dense prefill across ranks")
    if n_cp % size:
        raise ValueError(f"{size} ranks do not divide the data axis "
                         f"({n_cp} CP workers)")


def loop_from_args(args: argparse.Namespace):
    """``(loop, joined)``: the CLI's ``ServingLoop`` on seeded weights,
    and whether this call joined a process group.  Under torchrun
    (``RANK``, ``WORLD_SIZE``) it joins the group (unless this process
    already has) and the loop holds its rank's share (module docstring;
    ``loop.ranks``)."""
    from ..configs.base import ServeConfig
    from ..runtime.serving import ServingLoop
    from .mesh import parse_mesh
    mesh = parse_mesh(args.mesh)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_overrides(cfg, args.override)
    tpw = args.prefill_tokens_per_worker
    block = args.block_size or min(4096, tpw)
    pcfg = ParallelConfig(block_size=block,
                          in_dtype_bytes=param_dtype_bytes(cfg),
                          overlap=args.overlap)
    scfg = ServeConfig(
        cache_len=args.cache_len, decode_slots=args.slots,
        queue_depth=args.queue_depth, max_new_tokens=args.tokens,
        prefill_tokens_per_worker=tpw, bucket_min=args.bucket_min,
        prefill_impl=args.prefill_impl, kind=args.kind,
        strict_prefill=args.strict_prefill)
    env = wire.launch_env()
    joined = False
    if env is None:
        dev = resolve_device(args.device)
    else:
        check_ranked(cfg, scfg, mesh.shape, env["size"])
        dev = resolve_device(ranked_device(args.dist_backend, args.device,
                                           env))
        joined = not wire.in_group()
        mesh = mesh.with_ranks(wire.join(args.dist_backend, dev))
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    return ServingLoop(model, params, mesh, pcfg, scfg, device=dev), joined


def serving_prompts(args: argparse.Namespace, vocab: int) -> list:
    """The CLI's request stream (``--requests`` prompts of
    ``--prompt-min`` to ``--prompt-len`` tokens, within the cache, from
    ``--seed``): the same on every rank."""
    max_len = min(args.prompt_len, args.cache_len - args.tokens)
    if max_len < max(args.prompt_min, 1):
        raise SystemExit("--cache-len must exceed --tokens and the "
                         "shortest prompt")
    return serving_stream(np.random.default_rng(args.seed), vocab,
                          args.requests, args.prompt_min, max_len)


def serve(loop, args: argparse.Namespace, record: bool = False) -> dict:
    """Warm ``loop`` up, serve the CLI's stream and return the report,
    with the warmup's seconds, the programs built after it
    (``recompiles``) and every request's tokens (``tokens``, by request
    id; across ranks each rank holds them all).  With ``record`` the
    stream's logits go to ``loop.record`` (``ServingLoop``)."""
    # warmup: one request per admissible bucket builds the kernels, plans
    # every bucket and builds every program (on the card: captures its
    # CUDA graph, unless the loop spans ranks); the measured stream then
    # builds nothing
    t0 = time.perf_counter()
    base = loop.warmup()
    warm_s = time.perf_counter() - t0
    if record:
        loop.record = []
    report = loop.run(serving_prompts(args, loop.model.cfg.vocab_size),
                      max_new=args.tokens)
    report["warmup_s"] = warm_s
    report["compile_counts"] = loop.compile_counts()
    report["recompiles"] = (sum(report["compile_counts"].values())
                            - sum(base.values()))
    report["tokens"] = {r.rid: [int(t) for t in r.tokens]
                        for r in loop.stats.finished}
    return report


def main(argv=None):
    args = parse_args(argv)
    loop, joined = loop_from_args(args)
    try:
        report = serve(loop, args)
    finally:
        if loop.ranks.grouped:
            wire.barrier(loop.ranks)
            if joined:
                wire.leave()
    if loop.ranks.rank != 0:
        return report
    ranked = (f", {loop.ranks.size} {loop.ranks.backend} ranks: programs "
              f"run uncaptured" if loop.ranks.grouped else "")
    print(f"warmup {report['warmup_s']:.2f}s over buckets {loop.edges} "
          f"({loop.prefill_impl} prefill, device {loop.device}{ranked})")
    print(f"served {report['requests']} requests / "
          f"{report['generated_tokens']} tokens in "
          f"{report['wall_s']:.2f}s "
          f"({report['sustained_tok_s']:.1f} tok/s sustained)")
    print(f"prefill: {report['prefill_batches']} batches, fill "
          f"{report['prefill_fill']:.2f}, p99 "
          f"{report['prefill_ms']['p99']:.1f}ms | decode: "
          f"{report['decode_steps']} steps, p99 "
          f"{report['decode_ms']['p99']:.1f}ms | queue p99 "
          f"{report['queue_ms']['p99']:.1f}ms")
    print(f"recompiles after warmup: {report['recompiles']}")
    if "plan_cache" in report:
        pcs = report["plan_cache"]
        print(f"plan cache: {pcs['hits']} hits / {pcs['misses']} misses "
              f"(hit rate {pcs['hit_rate']:.2f})")
    if "ranks" in report:
        rk = report["ranks"]
        print(f"rank 0 of {rk['size']}: {rk['insert_bytes']} bytes moved "
              f"at inserts ({rk['insert_s']:.3f}s), {rk['merge_bytes']} "
              f"sent in merges ({rk['merge_s']:.3f}s)")
    for r in loop.stats.finished[:1]:
        print("sample:", np.asarray(r.tokens)[:16])
    return report


if __name__ == "__main__":
    main()
