#!/usr/bin/env python3
"""Kernels 3 and 4 at the main-path run with each worker's segments in
table order against longest first, on the card:

    python3 scripts/chip_segment_order.py

The run is the widest of the first training step's plan (as
``chip_smoke.main_path_bwd`` builds it).  Reordering the segment table
changes which blocks start first, not what any block computes, so both
orders must give the same bytes; each order is timed three times in
turns (natural, sorted, sorted, natural, natural, sorted) as
``chip_smoke.time_ms`` times a kernel.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import ParallelConfig, get_config  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.data.loader import SyntheticLoader  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as trainlib  # noqa: E402


def longest_first(segs, dev):
    lo, hi = (x.cpu().numpy() for x in segs)
    order = np.argsort(-(hi - lo), axis=1, kind="stable")
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.take_along_axis(x, order, 1))).to(dev) for x in (lo, hi))


def main() -> None:
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    cfg = get_config("stablelm_1_6b")
    pcfg = ParallelConfig(block_size=512, in_dtype_bytes=2)
    n_cp, tpw = 4, 2048
    b = SyntheticLoader(dist="real_world", n_frames=n_cp,
                        tokens_per_worker=tpw, vocab_size=cfg.vocab_size,
                        seed=0, bucket_min_len=pcfg.block_size).next()
    sched = trainlib.build_schedule(cfg, pcfg, b.seqlens, n_cp, tpw)
    t = ex.schedule_tables(sched, dev)
    run = max((r for r in t["runs"] if r is not None),
              key=lambda r: r["step_q"].shape[1])
    spec = sched.spec
    H, D, KH = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    SL, EX, bs = spec.slots + 1, spec.slots + spec.ext_slots + 1, \
        spec.block_size
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    qs, kxt, vxt = rnd(n_cp, SL, H, bs, D), rnd(n_cp, EX, KH, bs, D), \
        rnd(n_cp, EX, KH, bs, D)
    o2 = rnd(n_cp, SL, H, bs, D, dtype=torch.float32)
    l2 = rnd(n_cp, SL, H, bs, dtype=torch.float32) + 5
    fa.fused_flash_fwd(run["step_q"], run["step_kv"], qs, kxt, vxt,
                       run["q_seg"], run["q_pos"], run["k_seg"],
                       run["k_pos"], o2, l2, mask=spec.mask,
                       segments=run["segments"])
    go = rnd(n_cp, SL, H, bs, D, dtype=torch.float32) * 1e-2
    delta = ((go * o2).sum(-1)
             - 1e-2 * rnd(n_cp, SL, H, bs, dtype=torch.float32)
             ).contiguous()
    fwd_t = (run["step_q"], run["step_kv"], qs, kxt, vxt, run["q_seg"],
             run["q_pos"], run["k_seg"], run["k_pos"], l2, go, delta)
    bwd_t = (run["bwd_q"], run["bwd_kv"], qs, kxt, vxt, run["q_seg"],
             run["q_pos"], run["k_seg_b"], run["k_pos_b"], l2, go, delta)
    for name, fn, tabs, segs in (
            ("fused_flash_bwd_dq", fa.fused_flash_bwd_dq, fwd_t,
             run["segments"]),
            ("fused_flash_bwd_dkv", fa.fused_flash_bwd_dkv, bwd_t,
             run["kv_segments"])):
        lo, hi = (x.cpu().numpy() for x in segs)
        print(name, "segment lengths per worker:", (hi - lo).tolist(),
              flush=True)
        srt = longest_first(segs, dev)
        a = fn(*tabs, mask=spec.mask, segments=segs)
        b_ = fn(*tabs, mask=spec.mask, segments=srt)
        a, b_ = (x if isinstance(x, tuple) else (x,) for x in (a, b_))
        same = all(torch.equal(x, y) for x, y in zip(a, b_))
        times = []
        for which in ("natural", "sorted", "sorted", "natural", "natural",
                      "sorted"):
            s_ = segs if which == "natural" else srt
            times.append((which, cs.time_ms(
                lambda: fn(*tabs, mask=spec.mask, segments=s_))))
        print(name, "same bytes:", same, "times:", times, flush=True)


if __name__ == "__main__":
    main()
