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

CLI: PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch stablelm_1_6b --smoke --mesh 4x2 --tokens 16
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
                    param_dtype_bytes)


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


def build_decode_fns(cfg: ModelConfig, mesh, kind: str,
                     impl: str = "fused"):
    batch_axis, seq_axes = cache_specs(cfg, mesh, kind)
    n_shards = int(np.prod([mesh.shape[a] for a in seq_axes]))
    attn = functools.partial(ex.cp_decode_attention, n_shards=n_shards,
                             cfg=ex.ExecConfig(impl=impl))
    return attn, ex.cp_cache_update, batch_axis, seq_axes


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
                       batch_size: int, seq_len: int, ragged: bool = False):
    """Returns ``prefill_step(params, batch) -> (last_logits, cache)``.

    With ``ragged=True`` (attention families only) the step is
    ``prefill_step(params, batch, last_idx)``: each sequence's logits
    are taken at its true last-token index, so right-padded prompts
    prefill exactly (under a causal mask real tokens never attend the
    padding; the padded cache tail is masked at decode time).  Only the
    gathered rows are unembedded.  Recurrent families cannot pad up
    exactly (the state scans the padding), so they refuse ``ragged`` and
    chunk instead (``runtime/serving.py``)."""
    cfg = model.cfg
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


def main(argv=None):
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
    p.add_argument("--bucket-min", type=int, default=32,
                   help="smallest prefill bucket edge")
    p.add_argument("--block-size", type=int, default=0,
                   help="FCP scheduling block (0 = auto)")
    p.add_argument("--prompt-len", type=int, default=128,
                   help="max prompt length in the synthetic stream")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    args = p.parse_args(argv)
    env = wire.launch_env()
    if env is not None and env["size"] > 1:
        raise ValueError("serving across ranks is not supported yet "
                         "(ROADMAP Queue A: serving and decode across "
                         "ranks); run the serve CLI in one process")
    dev = resolve_device(args.device)

    from .mesh import parse_mesh
    mesh = parse_mesh(args.mesh)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_overrides(cfg, args.override)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)

    from ..configs.base import ServeConfig
    from ..runtime.serving import ServingLoop
    tpw = args.prefill_tokens_per_worker
    block = args.block_size or min(4096, tpw)
    pcfg = ParallelConfig(block_size=block,
                          in_dtype_bytes=param_dtype_bytes(cfg))
    scfg = ServeConfig(
        cache_len=args.cache_len, decode_slots=args.slots,
        queue_depth=args.queue_depth, max_new_tokens=args.tokens,
        prefill_tokens_per_worker=tpw, bucket_min=args.bucket_min,
        prefill_impl=args.prefill_impl, kind=args.kind,
        strict_prefill=args.strict_prefill)
    loop = ServingLoop(model, params, mesh, pcfg, scfg, device=dev)

    rng = np.random.default_rng(args.seed)
    max_len = min(args.prompt_len, args.cache_len - args.tokens)
    if max_len < 1:
        raise SystemExit("--cache-len must exceed --tokens")

    # warmup: one request per admissible bucket builds the kernels, plans
    # every bucket and builds every program (on the card: captures its
    # CUDA graph); the measured stream then builds nothing
    t0 = time.perf_counter()
    base = loop.warmup()
    warm_s = time.perf_counter() - t0

    stream = serving_stream(rng, cfg.vocab_size, args.requests, 1, max_len)
    report = loop.run(stream, max_new=args.tokens)
    recompiles = (sum(loop.compile_counts().values())
                  - sum(base.values()))

    print(f"warmup {warm_s:.2f}s over buckets {loop.edges} "
          f"({loop.prefill_impl} prefill, device {dev})")
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
    print(f"recompiles after warmup: {recompiles}")
    if "plan_cache" in report:
        pcs = report["plan_cache"]
        print(f"plan cache: {pcs['hits']} hits / {pcs['misses']} misses "
              f"(hit rate {pcs['hit_rate']:.2f})")
    for r in loop.stats.finished[:1]:
        print("sample:", np.asarray(r.tokens)[:16])
    return report


if __name__ == "__main__":
    main()
