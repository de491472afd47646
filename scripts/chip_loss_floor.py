"""Repeat ``chip_smoke.py``'s bf16 step-0 loss check on the card.

    python3 scripts/chip_loss_floor.py [--repeats 4]

Builds the kernels from the checkout, then runs the check's measurement
(``chip_smoke.train_loss_values``: StableLM-2-1.6B at the training
CLI's main path, 24 layers, bf16) ``--repeats`` times in one process,
each from a new trainer on the same seed.  Prints one JSON line a
repeat (the kernels' and the plain path's loss, their difference, the
null floor and its draws) and a last line that says whether the
kernels' and the plain losses were the same bytes in every repeat and
how many noise floors each difference was.  It also captures the plain
fused forward (``fused_flash_fwd_plain``) in a CUDA graph and replays
it against an eager call, since the training and serving programs may
capture it under ``--attn-impl fused_xla``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain_capture(fa, dev) -> dict:
    """One plain fused forward eagerly, then captured and replayed on the
    same inputs: whether both give the same bytes."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    N, SL, EX, H, KH, bs, D, S = 2, 3, 4, 4, 2, 64, 64, 5
    step_q = torch.tensor([[0, 0, 1, 2, 2]] * N, dtype=torch.int32,
                          device=dev)
    step_kv = torch.tensor([[0, 1, 1, 2, 3]] * N, dtype=torch.int32,
                           device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    qs, kxt, vxt = rnd(N, SL, H, bs, D), rnd(N, EX, KH, bs, D), \
        rnd(N, EX, KH, bs, D)
    q_seg = torch.zeros((N, SL, bs), dtype=torch.int32, device=dev)
    k_seg = torch.zeros((N, S, bs), dtype=torch.int32, device=dev)
    q_pos = torch.arange(SL * bs, dtype=torch.int32,
                         device=dev).view(1, SL, bs).repeat(N, 1, 1)
    k_pos = (step_kv[..., None] * bs + torch.arange(
        bs, dtype=torch.int32, device=dev)).contiguous()
    o0 = torch.zeros((N, SL, H, bs, D), device=dev)
    l0 = torch.full((N, SL, H, bs), -1e30, device=dev)

    def run(o, lse):
        return fa.fused_flash_fwd_plain(step_q, step_kv, qs, kxt, vxt, q_seg,
                                        q_pos, k_seg, k_pos, o, lse,
                                        mask=False)
    eager = [x.clone() for x in run(o0.clone(), l0.clone())]
    o, lse = o0.clone(), l0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(o.clone(), lse.clone())                # warm the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(o, lse)
    o.copy_(o0)
    lse.copy_(l0)
    graph.replay()
    torch.cuda.synchronize()
    return {"captured": True,
            "same_bytes": bool(torch.equal(o, eager[0])
                               and torch.equal(lse, eager[1]))}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=4)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_loss_floor: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as trainlib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}", flush=True)
    build.LIBRARIES.build()
    rows = []
    for i in range(args.repeats):
        r = chip_smoke.train_loss_values(trainlib, dev, chip_smoke.TRAIN_ARGV)
        r["floors"] = r["diff"] / r["noise_floor"]
        print(json.dumps({"repeat": i, **r}), flush=True)
        rows.append(r)
    print(json.dumps({
        "kernels_same_bytes": len({r["kernels"] for r in rows}) == 1,
        "plain_same_bytes": len({r["plain"] for r in rows}) == 1,
        "plain_losses": [r["plain"] for r in rows],
        "floors": [r["floors"] for r in rows],
        "plain_capture": plain_capture(fa, dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
