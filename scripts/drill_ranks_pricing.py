"""Host pricing of ``chip_smoke.py`` phase 9's Supervisor drills across
ranks (``chip_smoke.RANKED_DRILLS``).

For the kill drill (a ``2x1`` mesh, one worker a rank) and the pod drill
(``2x2x1``, one pod a rank) at the smoke's settings (StableLM-2-1.6B at
full width, ``DRILL_LAYERS`` deep, f32, block 512, 2,048 tokens a
worker), this walks each drill's steps (the primary run: the full fleet
until the failure, the survivor fleet from the restored step, the full
fleet again after a rejoin; then the uninterrupted reference run) and
prices, for each of the two ranks: the bytes its FCP ships put on the
wire a step (``wire.rank_wire_bytes`` of the step's plan, every layer's
forward twice under remat and its backward once, over the pods the
ranks split: a pod on each rank never ships across them), the bytes of
the step's gradient sum (``all_sum``, only while both ranks train), the
rejoin's broadcast (``wire.broadcast_bytes``: the state and four int64
of the rejoin's step, loader state and monitor cooldown), and the bytes
of a checkpoint.  The weights are shapes on the ``meta`` device: nothing
is drawn and no card is needed::

    PYTHONPATH=src python scripts/drill_ranks_pricing.py
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.configs.base import ParallelConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLoader  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.runtime import elastic, wire  # noqa: E402

BS, TPW, RANKS = 512, 2048, 2


def steps_of(kind: str) -> list:
    """``(run, step, pods, workers, ranks training)`` for each step the
    drill's primary and reference runs take."""
    fail, every = C.DRILL_FAIL_STEP, C.DRILL_EVERY
    resume = (fail - 1) // every * every      # after the last save
    if kind == "kill":
        total = C.DRILL_TOTAL
        out = [("primary", s, 1, 2, 2) for s in range(fail)]
        out += [("primary", s, 1, 1, 1) for s in range(resume, total)]
        return out + [("reference", s, 1, 1, 1)
                      for s in range(resume, total)]
    total, rejoin = C.POD_DRILL_TOTAL, C.POD_REJOIN
    out = [("primary", s, 2, 2, 2) for s in range(fail)]
    after = ([(s, 1, 2, 1) for s in range(resume, rejoin)]
             + [(s, 2, 2, 2) for s in range(rejoin, total)])
    out += [("primary", *x) for x in after]
    return out + [("reference", *x) for x in after]


def main() -> None:
    cfg = get_config("stablelm_1_6b").replace(n_layers=C.DRILL_LAYERS,
                                              param_dtype="float32")
    params = Model(cfg).init(torch.Generator(), "meta")
    leaves = adamw.tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    grad_bytes = n_params * 4
    state = [*leaves, *leaves, *leaves, torch.zeros((), dtype=torch.int32,
                                                    device="meta")]
    ckpt_bytes = sum(x.numel() * x.element_size() for x in state)
    nh, nkv = cfg.padded_heads(1)
    pcfg = ParallelConfig(block_size=BS, in_dtype_bytes=4.0)
    print(f"parameters {n_params:,}: a gradient sum {grad_bytes:,} B a "
          f"rank, a checkpoint {ckpt_bytes:,} B")
    for kind, pods in (("kill", 1), ("pod", 2)):
        loader = SyntheticLoader(dist="real_world", n_frames=2,
                                 tokens_per_worker=TPW,
                                 vocab_size=cfg.vocab_size, pods=pods,
                                 seed=0)
        total_ship = [0, 0]
        sums = 0
        for run, step, p, n, training in steps_of(kind):
            _, seqlens = loader.composition(step)
            ships = [0, 0]
            if training == 2:
                spec = elastic.replan(seqlens, n, BS, n_q_heads=nh,
                                      n_kv_heads=nkv, head_dim=cfg.head_dim,
                                      pcfg=pcfg, verify=False, pods=p,
                                      base_pods=pods).spec
                for r in range(RANKS):
                    fwd, bwd = wire.rank_wire_bytes(
                        spec, wire.Ranks(RANKS, r, "gloo"), nh, nkv,
                        cfg.head_dim, 4.0, pods=p)
                    ships[r] = int(cfg.n_layers * (2 * fwd + bwd))
                    total_ship[r] += ships[r]
            sums += training == 2
            print(f"{kind} {run} step {step}: fleet {p}x{n} on {training} "
                  f"rank(s), ships a rank {ships} B, gradient sum "
                  f"{grad_bytes if training == 2 else 0:,} B a rank")
        meta = torch.zeros(4, dtype=torch.int64, device="meta")
        bcast = (wire.broadcast_bytes(state + [meta], 0,
                                      wire.Ranks(RANKS, 0, "gloo"))
                 if kind == "pod" else 0)
        saves = len([s for r, s, *_ in steps_of(kind) if r == "primary"
                     and (s + 1) % C.DRILL_EVERY == 0])
        print(f"{kind}: ships {total_ship} B a rank, {sums} gradient sums "
              f"({sums * grad_bytes:,} B a rank), rejoin broadcasts from "
              f"rank 0 {bcast:,} B (each of two rejoins: the primary's and "
              f"the reference's), {saves} checkpoint saves of "
              f"{ckpt_bytes:,} B")


if __name__ == "__main__":
    main()
