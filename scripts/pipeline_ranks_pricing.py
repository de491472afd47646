"""Host pricing of ``chip_smoke.py`` phase 9's training runs across ranks,
flagless and with ``--layer-pipeline --overlap`` (``chip_smoke.RANKS_ARGV``
and ``BOTH_FLAGS``: StableLM-2-1.6B at full width, ``RANKS_LAYERS`` deep,
bf16, a 4x1 mesh, block 512, 2,048 tokens a worker, two ranks).

For each of the stream's first three batches this plans the step as the
train CLI does (the overlap plan under ``--overlap``) and prices, for each
rank, the bytes its ships put on the wire a step
(``chip_smoke.step_wire_price``): flagless, every layer's reshuffle of q,
k and v, its KV rounds and its restore of o, each forward twice under
remat and its backward once; pipelined, every layer's KV rounds alone,
and the hidden state with one position channel in (f32) and the hidden
state out once per mask group, forward and backward.  It prints the
reshuffle and restore share of the flagless step, the pipelined step's,
and the two steps' ratio.  No kernel runs and no card is needed::

    PYTHONPATH=src python scripts/pipeline_ranks_pricing.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.runtime import wire  # noqa: E402


def main() -> None:
    rows = {}
    for tag, flags in (("flagless", []), ("pipelined", C.BOTH_FLAGS)):
        args = T.parse_args(C.RANKS_ARGV + flags + ["--device", "cpu"])
        cfg, pcfg, _ = T.configs_from_args(args)
        mesh = T.parse_mesh(args.mesh)
        loader = T.SyntheticLoader(
            dist=args.dist, n_frames=mesh.shape["data"],
            tokens_per_worker=args.tokens_per_worker,
            vocab_size=cfg.vocab_size, seed=0)
        in_b = T.param_dtype_bytes(cfg)
        out_b = 2 if pcfg.attn_out_bf16 else 4
        nh, nkv = cfg.padded_heads(1)
        rows[tag] = []
        for step in range(3):
            b = loader.next()
            spec = T.build_schedule(cfg, pcfg, b.seqlens,
                                    mesh.shape["data"],
                                    args.tokens_per_worker).spec
            row = []
            for r in range(C.RANKS):
                rk = wire.Ranks(C.RANKS, r, "gloo")
                total = C.step_wire_price(spec, cfg, pcfg, rk, in_b, out_b)
                kf, kb = wire.rank_wire_bytes(spec, rk, nh, nkv,
                                              cfg.head_dim, in_b, out_b,
                                              layout="sched")
                rounds = int(cfg.n_layers * (2 * kf + kb))
                row.append((total, rounds, total - rounds))
            rows[tag].append(row)
            print(f"{tag} step {step}: per rank (bytes a step, of them the "
                  f"KV rounds, the rest: reshuffles and restores or the "
                  f"hidden-state moves) {row}")
    for step, (a, b) in enumerate(zip(rows["flagless"], rows["pipelined"])):
        ratio = [round(y[0] / x[0], 4) for x, y in zip(a, b)]
        moves = [round(y[2] / x[2], 4) for x, y in zip(a, b)]
        print(f"step {step}: pipelined / flagless bytes a rank {ratio}, "
              f"their reshuffle parts {moves}")


if __name__ == "__main__":
    main()
