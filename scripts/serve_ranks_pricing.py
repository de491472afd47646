"""Host pricing of ``chip_smoke.py`` phase 9's serving runs across ranks.

For each cache layout of ``chip_smoke.SERVE_RANKS`` this runs the port's
``ServingLoop`` host logic on the CPU with the smoke-sized model on the
same mesh, budget, slots, cache and request stream (the stream's lengths
do not depend on the vocabulary, and the batching, slot choices and
decode steps depend on the lengths alone), records every prefill batch
(bucket, slots, last tokens) and the decode steps, and prices them at the
smoke's full-width model (StableLM-2-1.6B at ``RANKS_LAYERS`` layers,
bf16) for each of ``RANKS`` ranks: the FCP prefill's ship bytes
(``wire.rank_wire_bytes``, the forward over every layer), the insert's
moved bytes (``serving.insert_wire_bytes``), the decode merges' bytes
(``serving.merge_wire_bytes``), and each rank's weights and cache; then
the same for the ``--overlap`` run (``chip_smoke.SERVE_OVERLAP``: the
double-buffered plan of every batch).  No kernel runs and no card is
needed::

    PYTHONPATH=src python scripts/serve_ranks_pricing.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ParallelConfig, ServeConfig, apply_overrides, get_config, smoke_config)
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import serving, wire  # noqa: E402


def batches_of(args) -> tuple[list, int]:
    """Every prefill batch of the stream (bucket, slots, last tokens) and
    the decode steps, from the host loop on the smoke model."""
    cfg = dataclasses.replace(smoke_config(args.arch), n_layers=1)
    pcfg = ParallelConfig(block_size=args.block_size)
    scfg = ServeConfig(
        cache_len=args.cache_len, decode_slots=args.slots,
        max_new_tokens=args.tokens, queue_depth=args.queue_depth,
        prefill_tokens_per_worker=args.prefill_tokens_per_worker,
        bucket_min=args.bucket_min, kind=args.kind)
    model = Model(cfg)
    loop = serving.ServingLoop(
        model, model.init(torch.Generator().manual_seed(0), "cpu"),
        parse_mesh(args.mesh), pcfg, scfg, device="cpu",
        attn_impl="fused_xla")
    seen = []
    inner = loop._prefill_and_insert

    def spy(reqs, free):
        seen.append((reqs[0].bucket, list(free[:len(reqs)]),
                     loop._last_index(reqs[0].bucket, reqs)))
        return inner(reqs, free)
    loop._prefill_and_insert = spy
    rep = loop.run(S.serving_prompts(args, cfg.vocab_size),
                   max_new=args.tokens)
    return seen, rep["decode_steps"]


def price(kind: str, extra: tuple = ()) -> None:
    args = C.serve_ranks_args(kind, ["--device", "cpu", *extra])
    cfg = apply_overrides(get_config(args.arch), args.override)
    mesh = parse_mesh(args.mesh)
    n_cp, n_model = mesh.shape["data"], mesh.shape["model"]
    tpw = args.prefill_tokens_per_worker
    budget = n_cp * tpw
    pcfg = ParallelConfig(block_size=args.block_size,
                          in_dtype_bytes=S.param_dtype_bytes(cfg),
                          overlap=args.overlap)
    nh, nkv = cfg.padded_heads(1)
    itemsize = torch.tensor([], dtype=getattr(torch, cfg.param_dtype)
                            ).element_size()
    kv_row = 2 * cfg.n_layers * nkv * cfg.head_dim * itemsize
    batches, steps = batches_of(args)
    R = C.RANKS
    (s0, s1), (p0, p1) = S.cache_share(mesh.with_ranks(
        wire.Ranks(R, 0, "gloo")), kind, args.slots, args.cache_len)
    lay = serving.RankLayout(R, kind, budget // R, s1 - s0, p1 - p0)
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab(1)
    params = (2 * V * d + cfg.n_layers * (
        2 * d * nh * cfg.head_dim + 2 * d * nkv * cfg.head_dim + 3 * d * ff
        + 2 * d) + d)
    cache = kv_row * lay.slots * lay.positions
    print(f"{kind}{' --overlap' if args.overlap else ''}: {cfg.name} "
          f"{cfg.n_layers} layers, {args.requests} requests, mesh "
          f"{args.mesh}, "
          f"{R} ranks; weights {params * itemsize / 2**30:.3f} GiB a rank "
          f"(replicated); cache {cache / 2**30:.3f} GiB a rank "
          f"({lay.slots} slots x {lay.positions} positions)")
    tot = [[0, 0, 0] for _ in range(R)]
    for E, slots, last in batches:
        comp = list(pc.prefill_composition(E, budget))
        spec = S.build_schedule(cfg, pcfg, comp, n_cp, tpw, mask=True).spec
        row = []
        for r in range(R):
            ship = int(cfg.n_layers * wire.rank_wire_bytes(
                spec, wire.Ranks(R, r, "gloo"), nh, nkv, cfg.head_dim,
                pcfg.in_dtype_bytes, 2 if pcfg.attn_out_bf16 else 4)[0])
            ins = serving.insert_wire_bytes(lay, r, E, slots, last, kv_row)
            row.append((ship, ins))
            tot[r][0] += ship
            tot[r][1] += ins
        print(f"  batch E {E}, {len(slots)} request(s) into slots {slots}: "
              + "; ".join(f"rank {r} ships {s} B, inserts {i} B"
                          for r, (s, i) in enumerate(row)))
    merge = serving.merge_wire_bytes(lay, cfg.n_layers, nh, cfg.head_dim,
                                     n_cp * n_model)
    for r in range(R):
        tot[r][2] = merge * steps
    print(f"  {len(batches)} batches, {steps} decode steps of {merge} merge "
          f"bytes a rank; totals per rank (ships, inserts, merges): {tot}")


def main() -> None:
    for kind in C.SERVE_RANKS:
        price(kind)
    price(C.SERVE_OVERLAP, ("--overlap",))


if __name__ == "__main__":
    main()
