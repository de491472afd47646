#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py
(``--phases llama,train`` runs the build and only the phases named, a
development aid that prints no result line.)

Phases, each reported on its own line with its wall:

1. build   — compile the CUDA kernels from ``kernels/csrc`` (nvcc), print
             ``ptxas -v`` per entry and the HMMA/HGMMA/FFMA counts of
             every kernel (``cuobjdump -sass``); the bf16 D=16, D=64,
             D=80 and D=128 builds of kernel 1, kernel 2's tiled variant
             and kernels 3-6 must hold tensor-core instructions, and
             kernels 3 and 4 no FFMA dot-product loop.
2. kernels — each kernel against its plain PyTorch version on the card,
             first at small shapes (all four mask kinds, GQA groups 1-4,
             7 and 8, D 16, 32, 64, 80 and 128, a fully masked row, ragged
             tiles, a trash step; f32 and bf16), then at the shapes the
             main paths give it, with StableLM's heads (32 of 64),
             Granite's (24 of 64 over 8 kv heads), Moonlight's (16 of
             128), Zamba2's shared block's (32 of 80), InternVL2's (14
             of 64 over 2 kv heads: group 7) and llama3-70b's (64 of 128
             over 8 kv heads: group 8); times (CUDA
             events around 10 launches back to back, median of 21 such
             windows, the plain versions 2 launches and 5 windows
             (PLAIN_TIMING); kernel 2, whose wrapper's host work is of the
             order of its kernels, alone on inputs prepared once, the
             wrapper beside it), bounds and the library yardstick.  Kernel 2
             runs every small case through both its variants (split-KV
             decode and tiled) and the wrapper, with decode rows of
             length 0, 1, a split size -1/+0/+1 and several splits; at
             main-path shapes it is held at decode (8 slots x 2 shards)
             and at the per-step training block, each beside SDPA
             forward's device time.  A second launch gives the same
             bytes (kernel 2 at both shapes, kernel 1 at the serve shape).
   The backward kernels (3-6) the same way: small cases, then the
             widest run of the first training step's plan and one
             per-step block of it, each against its plain version to
             TOL_GRAD, with times, bounds and counted TFLOP/s side by
             side; each runs twice on the same inputs (same bytes) in
             both.  Kernels 5 and 6 are also timed alone on
             inputs prepared once beside the whole wrapper
             (``wrapper_ms``), and are set beside the library yardstick
             (SDPA backward, the device time of its kernels under the
             profiler).
3. serve   — full-width StableLM-2-1.6B (bf16, random seeded weights) on
             a stacked (4 data x 2 model) mesh: warmup, then 16 requests
             through FCP prefill and CP decode, with both kernels'
             launch counters read around that run.  Every serving loop
             here streams through its compiled programs (CUDA graphs of
             the decode step, each bucket's prefill and insert, the fresh
             insert): 0 recompiles after warmup; one decode step and the
             first prefill batch replayed and run eagerly on the same
             inputs, the same bytes; kernels 1 and 2's counted launches
             of a replay against its profile's kernel events; eager and
             replayed walls side by side (``programs`` lines); StableLM's
             stream again through the eager methods (tokens identical,
             tokens/s both ways).  The first prefill
             batch is replayed through the plain versions and compared
             (f32 weights to TOL_SERVE_F32; bf16 weights to a multiple
             of bf16's own noise floor on that batch).  Then the same for
             Granite-3.0-3B-A800M (MoE, 40 experts top-8, 4 of 32 layers)
             and
             Moonlight-16B-A3B (MoE, head_dim 128, 4 of 48 layers), whose
             kernel runs take the experts the plain runs chose
             (``PinnedRoutes``); Zamba2-2.7B (hybrid, head_dim 80, 18 of
             54 layers, 8 requests; its f32 tokens kernels vs plain on a short
             stream, bf16's reported) and Mamba2-130M (SSM, no
             attention, 4 of 24 layers: its prefill held against its
             recurrent decode).
   Every training run below goes through the loops' step programs (one
             CUDA graph per plan key: a key's first step runs eagerly
             and is captured, later steps replay; ``launch/train.py``,
             ``runtime/graphs.py``): each run that reports tokens/s
             first takes one round of the stream's compositions (its
             builds), then times replayed steps and profiles one, and
             fails if a program is built after the round; a ``train
             programs`` line per run gives the builds' eager walls, the
             replayed walls, device ms, busy share, capture seconds,
             graph nodes, peak and the memory reserved with the pool.
4. train   — (a) full width, 4 layers, f32 weights: every parameter's
             gradient through the kernels against the plain versions,
             for the fused (kernels 1, 3, 4) and the per-step (2, 5, 6)
             executor, to TOL_TRAIN_F32; the step programs at
             CHECK_LAYERS, bf16 and f32 (``train_program_checks``): one
             step replayed and two run eagerly from one copied state,
             fused and pallas (the replay the same bytes where eager
             against eager is, else within that spread; the replay's
             counted launches of kernels 1-6 equal the eager step's and
             its profiled kernel events), and zero recompiles after a
             round in the plain loop, the Supervisor, ``--overlap`` and
             the bf16 and int8 wires; (b) the training CLI's plain loop
             (``launch.train --no-supervised``, as the earlier PRs'
             numbers were taken: 24 layers, bf16, 4 stacked workers, 8192
             tokens per step, fused) for a round and 3 replayed steps with
             the launch counters read around them, one more step under
             the profiler, one ``--attn-impl pallas`` step built and
             replayed on the same batch with its counters, and the bf16
             step-0 loss, kernels against plain, held to a multiple of
             its noise floor: the loss moved by the kernel's deviation
             from the plain attention output under random signs.  Then
             Granite at full width: (a) at 4 layers with pinned experts,
             (b) at 4 of 32 layers, 3 fused steps, one profiled, one pallas
             step, the bf16 step-0 loss check and where an MoE layer's
             time goes; and Moonlight at 2 layers: 2 fused steps, one
             pallas step, the loss check; and Zamba2: 6-layer f32
             gradients (one shared-attention invocation), then 12 of 54
             layers: 3 fused steps, one pallas step, the loss check and
             where a Mamba2 layer's time goes (``ssm_breakdown``).
5. the rest of the training path, StableLM at full width:
             (a) 4 layers, f32: the executor at StableLM's shapes with
             the double-buffered round loop on and off (fused and
             pallas: o and dq bitwise, dk/dv to DKDV_TOL), the side
             stream's ship kernels of a forward and of a forward and
             backward (the backward's must land there too), one serving
             prefill batch (logits bitwise), one train step (loss
             bitwise, leaves to TOL_OVERLAP_LEAF), and the layer pipeline
             on and off (loss and leaves to TOL_PIPELINE); (b) full
             depth, bf16: serial and with ``--overlap``, a build step's
             eager call profiled per CUDA stream (``stream_profile``:
             ship kernels on the side and main streams, the side time
             under a main-stream kernel; the side count must be > 0),
             a round, two replayed steps and one profiled, then a round
             and 3 steps with ``--layer-pipeline``
             and 3 with ``--layer-pipeline --overlap`` (one more of each
             profiled: device time, copies, peak), beside the plain step
             of phase 4; (c) the Supervisor (``launch/drills.py``) at 1
             layer, f32: the kill drill (worker 1 lost mid-step at step 3
             of 5, checkpoints every 2 steps under build/, at most 2 steps
             lost, the replay within 1e-6 of an uninterrupted survivor
             run) and the straggler drill (worker 3 2x slow: demoted
             within the window and cooldown, its plan key missing once);
             then the CLI's default command (the Supervisor) for a round
             and 2 replayed full-depth bf16 steps with the counters read
             around them (no recompile, no health event),
             and a checkpoint round trip of its bf16 parameters and AdamW
             state, 4 of its 24 layers (save and restore seconds, bytes
             equal).
6. pods    — StableLM at full width on pod meshes (P pods x D stacked
             workers, every pod on the same D-worker plan, one launch of
             each kernel for all pods): (a) the training CLI's plain loop
             on ``--mesh 2x4x1`` (cell 2's geometry in each pod, 16,384
             tokens a step): at 4 layers, f32, the loss and every
             gradient through kernels 1, 3 and 4 against the plain
             versions (TOL_TRAIN_F32, loss TOL_GRAD) and the 2-pod loss
             against the mean of the two one-pod losses on the same
             frames (POD_LAYOUT_TOL); at full depth, bf16, 3 fused steps
             with the counters read around them and one profiled; one
             ``--attn-impl pallas`` step at 4 layers (kernels 2, 5, 6)
             with its counters; (b) the pod drill
             (``launch/drills.pod_drill``: 1 layer, f32, 2 x 2 workers,
             compression on, pod 1 lost at step 3 and back at step 5 of
             7, checkpoints under build/pods/): at most 2 steps lost,
             the replay within 1e-6, no plan miss and no step program
             built after the rejoin; (c) serving on a 2x2x2 mesh: with f32
             weights at 4 layers, 4 requests, the FCP prefill warns and serves
             densely, its tokens those of a 4x2 FCP loop, and
             ``strict_prefill`` raises; at full depth, bf16, 8 requests
             in phase 3's setting with kernel 2's counter (decode), the
             prefill p50 beside phase 3's.  Then kernels 1 and 3-6 at the
             pod step's shapes (8 frames), each against its plain
             version, the ``stablelm pods`` rows of the kernels line.
7. multimodal — InternVL2-1B (vision-language: 24 layers, d 896, 14 / 2
             heads of 64, ``qkv_bias``, vocab 151655, the front-end stub of
             1024-d patches) and MusicGen-large (audio: d 2048, 32 heads
             of 64, 6 of 48 layers) at full width: served in
             phase 3's setting (text-only, as the reference serves them),
             then trained through the CLI's plain loop (3 fused steps,
             one profiled, a pallas step, the bf16 step-0 loss check;
             InternVL2 first at 4 layers with f32 weights, every leaf's
             gradient against plain) with the device time of the front
             end's product and of the head; then InternVL2's smoke config
             (7 / 1 heads of 16: the path that needs head dim 16) with f32
             weights, every leaf's gradient through kernels 1, 3, 4 and
             2, 5, 6 against plain, a fused and a pallas step; then the
             baseline CP policies (ring, ByteScale, Magi, WLB) on
             StableLM's first training batch through the fused executor
             (one layer's attention, bf16): forward against the dense
             oracle, gradients against plain, each schedule's attention
             device time beside FCP's.
8. llama3 — llama3-70b, the paper's own model (d 8192, 64 / 8 heads of
             128, d_ff 28672, vocab 128256): served in phase 3's setting
             at 8 of 80 layers (f32 prefill logits against plain; its
             stream eagerly too, as StableLM's), then
             trained through the CLI's plain loop: 1 layer with f32
             weights, every leaf's gradient through kernels 1, 3, 4 and
             2, 5, 6 against plain; at 3 of 80 layers, bf16, 3 fused steps
             (one more profiled: device time, GEMM and attention time,
             peak) under ``--remat-policy dots`` (the default, which saves
             the products without batch dimensions) and under
             ``nothing``, a pallas step, and 3 steps with ``--comm-dtype
             int8``.  StableLM's fused step under ``nothing`` beside
             phase 4's (``dots``).  The reference's wire-format section
             at llama3-70b's attention (f32 q, k, v; kernels 1, 3, 4):
             the bf16 and int8 wires' gradient error against the f32
             wire's and their round bytes ratios, held to the
             reference's gates.  No phase here writes a checkpoint.
9. ranks  — FCP across processes: the training CLI's plain loop under
             ``python -m torch.distributed.run --standalone
             --nproc-per-node 2`` with ``--dist-backend gloo --device
             cuda:0`` (two ranks share the card, each holding 2 of the
             4x1 mesh's 4 workers; its ships across ranks and its
             reductions go through gloo, staged through the host; every
             step eager), StableLM at full width and RANKS_LAYERS deep,
             in one torchrun (``repro_torch.launch.ranks``, which runs the
             CLI in each rank): 3 fused steps, its bf16 step-0 loss held to
             BF16_FLOORS noise floors of the one-process stacked run of the
             same arguments (``train_loss_check``), kernels 1, 3 and 4
             launched in each rank (its counters), and each rank's bytes
             on the wire each step equal to their pricing
             (``wire.rank_wire_bytes``); the same with ``--attn-impl
             pallas`` for one step (kernels 2, 5 and 6); at 4 layers, f32,
             every leaf's summed gradient across the two ranks against
             the stacked run's at TOL_GRAD, fused and pallas.  Then the
             CLI in this process as the one rank of an NCCL group, 2
             steps.  Each run's wall, each rank's step walls (and their
             seconds in the ships and the sums) and peak memory, beside
             the one-process eager run's.  In the same torchrun the serve
             CLI across the two ranks on a 4x2 mesh (SERVE_RANKS: each
             rank 2 of the 4 prefill frames), ``--kind decode`` (each rank
             4 of the 8 slots) and ``--kind long`` (each rank half of every
             slot's 12,288 cache positions, the decode merge across the
             ranks), every program eager: 0 programs built after warmup
             and a plan-cache hit on every batch on each rank, kernels 1
             and 2 launched in each, each rank's bytes in the prefill
             ships, the inserts and the merges equal to their pricing, the
             plan keys and tokens the same on both, and each prefill
             batch's and the first decode step's logits within
             BF16_FLOORS noise floors of the one-process loop's on the
             same weights and stream (``serve_stacked``, eager; tokens
             that agree are counted); then ``--kind long`` here as a
             one-rank NCCL group, held the same way.  In the same torchrun
             the Supervisor's drills across the two ranks
             (RANKED_DRILLS, ``launch/drills.py`` on a ranked Supervisor:
             StableLM at full width, f32, DRILL_LAYERS deep, block 512,
             2,048 tokens a worker): the kill drill at R = D = 2 on a 2x1
             mesh (worker 1 lost at step 3: rank 1 idles, rank 0 restores
             and replays) and the pod drill on a 2x2x1 mesh, one pod a
             rank (pod 1 lost at step 3, rank 1 idles, and rejoins at step
             5 from rank 0's broadcast state), each drill's limits held on
             every rank (at most DRILL_EVERY steps lost, the replay within
             1e-6, at the rejoin no plan miss and no step program built,
             the rejoined rank's parameters the survivor's digest),
             kernels 1, 3 and 4 launched in each rank; every rank's
             fleet and own step walls, its bytes and seconds in the ships,
             the sums and the broadcast, and each drill's seconds printed.
             In the same torchrun the plain loop with ``--layer-pipeline
             --overlap`` (RANKS_BOTH), between the flagless fused run and
             the pallas run, 3 fused steps held as the fused run is (its
             step-0 loss against the one-process run with both flags, its
             bytes against the pipelined price, ``step_wire_price``), and
             its f32 gradient check; and the serve CLI's ``--kind long
             --overlap`` (SERVE_OVERLAP), held as the ``long`` run is
             against the one-process ``--overlap`` loop, its tokens
             equal.  The two training runs go again in turns, 2 steps
             each (RANKS_TURN_STEPS; the walls past each run's first
             step compared).  Each rank's host seconds in its ships' own
             calls (``ship_wait_s``: all of a blocking ship's) print
             beside its ships' seconds.
             The one-rank NCCL CLI runs again with both flags (no pair
             crosses ranks there: it holds that the path runs).

The line before the card's line is a JSON object with one entry per
kernel, its StableLM main-path row at the top (kernel 2's at decode) and
every main-path row under ``shapes``, each with the launches of its own
model's runs (the ``stablelm pods`` rows: the pod phase's); the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Without a CUDA device the script fails.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
TOL_O = 1e-4                # max |o_kernel - o_plain| / max |o_plain|
TOL_LSE = 1e-4              # max |lse_kernel - lse_plain| on live rows
TOL_SERVE_F32 = 1e-4        # prefill logits, kernels vs plain, f32 weights
BF16_FLOORS = 2.0           # bf16 weights: at most this many noise floors
LOSS_NULL_DRAWS = 8         # draws of the train loss's noise floor
TOL_GRAD = 1e-4             # backward kernels vs plain, max err / max |plain|
TOL_TRAIN_F32 = 1e-4        # per-leaf train gradients, kernels vs plain
# the plain versions at main-path shapes (tens of ms a call) are timed
# over 5 windows of 2 calls, not the kernels' 21 of 10: a yardstick,
# and the run's time
PLAIN_TIMING = {"n": 2, "windows": 5}
# the plain loop: the phases held against earlier plain-loop numbers
# (the CLI's default is the Supervisor, phase 5)
TRAIN_ARGV = ["--arch", "stablelm_1_6b", "--mesh", "4x1", "--dist",
              "real_world", "--block-size", "512", "--tokens-per-worker",
              "2048", "--attn-impl", "fused", "--steps", "3",
              "--no-supervised"]
MOE_ARCH = "granite_moe_3b_a800m"   # the MoE model at full width
MOE_LAYERS = 4                      # of 32, serving and training
MOE_WHY = ("depth cut for the run's time (phase 7's models took its "
           "place); the layers kept are at full width (d 1536, 24 / 8 "
           "heads of 64, 40 experts top-8)")
D128_ARCH = "moonshot_v1_16b_a3b"   # the MoE model at head_dim 128
D128_SERVE_LAYERS = 4               # of 48: ~0.57 B parameters a layer
D128_TRAIN_LAYERS = 2
D128_WHY = ("depth cut for the run's time; the layers kept are at full "
            "width (d 2048, 16 heads of 128, 64 experts top-6, vocab "
            "163840)")
HYBRID_ARCH = "zamba2_2_7b"         # the hybrid (head_dim 80), full size
HYBRID_SERVE_LAYERS = 18            # of 54: 3 shared-attention invocations
HYBRID_WHY = ("depth cut for the run's time (its host-bound decode loop "
              "took 207 s at 54 layers); the layers kept are at full "
              "width, every 6th followed by the shared block")
HYBRID_SERVE_REQUESTS = 8           # of phase 3's 16
HYBRID_REQUESTS_WHY = (
    "requests cut for the run's time: the serve phase took 69-80 s with "
    "16 on an H100 80GB HBM3 host, its decode loop host-bound; a cut to "
    "6 layers (one shared-block invocation) left the bf16 logits check "
    "without a noise floor: a one-ulp nudge of the attention output "
    "moved no bf16 logit (floor 0.0)")
HYBRID_GRAD_LAYERS = 6              # one shared-attention invocation
HYBRID_TRAIN_LAYERS = 12            # of 54: 2 shared-block invocations
HYBRID_TRAIN_WHY = ("depth cut for the run's time (78.3 s at 54 layers, "
                    "27-35 s at 18 on an H100 80GB HBM3 host); the layers "
                    "kept are at full width, every 6th followed by the "
                    "shared block")
SSM_ARCH = "mamba2_130m"            # the SSM, full width (no attention)
SSM_SERVE_LAYERS = 4                # of 24
SSM_WHY = ("depth cut for the run's time (its host-bound decode loop took "
           "39.9 s at 24 layers); the layers kept are at full width")
TOL_SSM_F32 = 1e-4                  # f32 prefill vs recurrent decode logits
PALLAS_WHY = ("steps cut for the run's time: StableLM's per-step-executor "
              "step builds its program in 12.5-16 s (an eager step of "
              "4.6-4.9 s, a capture of 6-9 s and the graph's "
              "instantiation, 141-152 k nodes, on an H100 80GB HBM3 "
              "host); one key is built and then replayed on the same "
              "batch, the loader rewound, with its counters: kernels 2, "
              "5 and 6, without the rest of a round and the profile")


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def time_ms(fn, n: int = 10, windows: int = 21) -> float:
    """Device ms per call of ``fn``: ``n`` calls back to back between one
    pair of CUDA events, so the host's checks and launches overlap the
    device's work; the median over ``windows`` such windows, after three
    untimed calls."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def compare(name: str, o_k, l_k, o_p, l_p) -> float:
    """Max normalized o error and max abs live-lse error; raises past
    the tolerances.  Returns the max abs o error."""
    import torch
    scale = max(float(o_p.abs().max()), 1.0)
    err_o = float((o_k - o_p).abs().max()) / scale
    live = l_p > -1e29
    err_l = float((l_k - l_p)[live].abs().max()) if live.any() else 0.0
    dead_ok = bool(torch.all(l_k[~live] < -1e29)) and bool(
        torch.equal(o_k[~live], o_p[~live]))
    if not (err_o <= TOL_O and err_l <= TOL_LSE and dead_ok
            and bool(torch.isfinite(o_k).all())):
        raise AssertionError(
            f"{name}: o err {err_o:.3e} (tol {TOL_O}), lse err "
            f"{err_l:.3e} (tol {TOL_LSE}), dead rows ok {dead_ok}")
    return float((o_k - o_p).abs().max())


def _meta(rng, n, docs, pad_frac=0.1):
    """(seg, pos) of ``n`` tokens cut into ``docs`` documents + padding."""
    npad = int(n * pad_frac)
    body = n - npad
    cuts = np.sort(rng.choice(np.arange(1, body), docs - 1, replace=False))
    seg = np.full(n, -1, np.int32)
    pos = np.zeros(n, np.int32)
    lo = 0
    for i, hi in enumerate(list(cuts) + [body]):
        seg[lo:hi] = i
        pos[lo:hi] = np.arange(hi - lo)
        lo = hi
    return seg, pos


# --------------------------------------------------------------------------
# phase 2: kernels
# --------------------------------------------------------------------------

def flash_variants(fa, name, args, mask):
    """Kernel 2 on ``args``: the wrapper (the variant ``fwd_variant``
    picks), then each variant launched directly, each against the plain
    version; the wrapper twice must give the same bytes.  Returns the max
    abs o error."""
    import torch
    o_p, l_p = fa.flash_attention_fwd_plain(*args, mask=mask)
    o_k, l_k = fa.flash_attention_fwd(*args, mask=mask)
    o_2, l_2 = fa.flash_attention_fwd(*args, mask=mask)
    outs = {v: fa._launch_fwd(fa._flash_fwd_prep(*args, mask, None), v)
            for v in ("tiled", "decode")}
    torch.cuda.synchronize()
    err = compare(f"{name} (wrapper)", o_k, l_k, o_p, l_p)
    for v, (o_v, l_v) in outs.items():
        err = max(err, compare(f"{name} ({v})", o_v, l_v, o_p, l_p))
    if not (torch.equal(o_k, o_2) and torch.equal(l_k, l_2)):
        raise AssertionError(f"{name}: a second launch gave other bytes")
    return err


def small_flash_cases(fa, masks, dev):
    """Kernel 2 against its plain version, both variants on every case:
    all four masks, f32 and bf16; D 64, 32, 128, 80 and 16; groups 2, 8,
    4, 1, 3 (granite's) and 7 (internvl2's, at D 16 and 64); a fully
    masked row; a ragged Sq = 72, Sk = 200;
    Sq on both sides of the variant threshold; one document without
    padding (full tiles).
    Then decode rows over a strided cache view: lengths 0, 1, a split
    size -1, +0, +1, and one that spans several splits."""
    import torch
    rng = np.random.default_rng(0)
    t_sq = fa.DECODE_MAX_SQ
    for dtype in (torch.float32, torch.bfloat16):
        for mask in masks:
            for (B, H, KH, Sq, Sk, D), docs, pad in (
                    ((2, 4, 2, 128, 256, 64), 3, 0.1),
                    ((1, 8, 1, 96, 160, 32), 3, 0.1),
                    ((1, 4, 1, 72, 200, 64), 3, 0.1),
                    ((1, 8, 2, 128, 192, 64), 1, 0.0),
                    ((2, 4, 2, t_sq, 300, 64), 2, 0.0),
                    ((2, 4, 4, t_sq + 1, 300, 32), 2, 0.0),
                    ((1, 4, 2, 136, 200, 128), 3, 0.1),
                    ((1, 8, 1, 128, 192, 128), 1, 0.0),
                    ((2, 8, 8, t_sq, 300, 128), 2, 0.0),
                    ((1, 6, 2, 136, 200, 64), 3, 0.1),
                    ((1, 12, 4, 128, 192, 128), 1, 0.0),
                    ((2, 6, 2, t_sq, 300, 128), 2, 0.0),
                    ((1, 4, 4, 136, 200, 80), 3, 0.1),
                    ((1, 4, 4, 128, 192, 80), 1, 0.0),
                    ((2, 4, 4, t_sq, 300, 80), 2, 0.0),
                    ((1, 7, 1, 136, 200, 16), 3, 0.1),
                    ((2, 4, 4, 128, 192, 16), 1, 0.0),
                    ((2, 7, 1, t_sq, 300, 16), 2, 0.0),
                    ((1, 14, 2, 136, 200, 64), 3, 0.1)):
                q = torch.tensor(rng.normal(size=(B, H, Sq, D)),
                                 dtype=dtype, device=dev)
                k = torch.tensor(rng.normal(size=(B, KH, Sk, D)),
                                 dtype=dtype, device=dev)
                v = torch.tensor(rng.normal(size=(B, KH, Sk, D)),
                                 dtype=dtype, device=dev)
                # q and kv share one document structure; q rows are the
                # stream's tail, so causal masking is meaningful
                seg_k, pos_k = _meta(rng, Sk, docs, pad)
                seg_q, pos_q = seg_k[-Sq:].copy(), pos_k[-Sq:].copy()
                seg_q[5] = -1                      # a fully masked row
                t = [torch.from_numpy(np.stack([x] * B)).to(dev)
                     for x in (seg_q, pos_q, seg_k, pos_k)]
                flash_variants(fa, f"flash_attention_fwd {mask} {dtype} "
                               f"{(B, H, KH, Sq, Sk, D)}", (q, k, v, *t),
                               mask)
    # decode shape: Sq = 1 against a strided [B, S, KH, D] cache view
    n = fa.DECODE_SPLIT
    lengths = [0, 1, n - 1, n, n + 1, 3 * n + 60]
    for dtype in (torch.float32, torch.bfloat16):
        for KH, H, D in ((2, 4, 64), (1, 8, 32), (4, 4, 64), (2, 8, 128),
                         (4, 4, 128), (2, 6, 64), (4, 12, 128), (8, 24, 64),
                         (4, 4, 80), (1, 7, 16), (4, 4, 16), (2, 14, 64)):
            B, S = len(lengths), 3 * n + 100
            cache_k = torch.tensor(rng.normal(size=(B, S, KH, D)),
                                   dtype=dtype, device=dev)
            cache_v = torch.tensor(rng.normal(size=(B, S, KH, D)),
                                   dtype=dtype, device=dev)
            q = torch.tensor(rng.normal(size=(B, H, 1, D)), dtype=dtype,
                             device=dev)
            pos = torch.arange(S, dtype=torch.int32, device=dev)
            seg = torch.where(pos[None] < torch.tensor(lengths, device=dev)[
                :, None], 0, -1).int()
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            args = (q, cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                    zero, zero, seg, pos.expand(B, S).contiguous())
            flash_variants(fa, f"flash_attention_fwd decode {dtype} "
                           f"KH={KH} H={H} D={D}", args, False)


def small_fused_cases(fa, masks, dev):
    """Kernel 1 against its plain version: all four masks, f32 and bf16,
    D 64, 32, 128, 80 and 16, groups 2, 8, 4, 4, 3 (twice), 1 and 7 (at
    D 16 and 64), ragged q and kv
    tiles (bs 80 and 72), one document stream (so full tiles occur), a
    fully masked row, a trash step, slots a worker never visits."""
    import torch
    rng = np.random.default_rng(1)
    N, SL, EX = 2, 5, 6
    for dtype in (torch.float32, torch.bfloat16):
        for mask in masks:
            for D, bs, H, KH in ((64, 128, 4, 2), (32, 80, 8, 1),
                                 (128, 128, 8, 2), (64, 72, 4, 1),
                                 (64, 128, 6, 2), (128, 80, 12, 4),
                                 (80, 128, 4, 4), (80, 72, 4, 4),
                                 (16, 128, 7, 1), (16, 72, 4, 4),
                                 (64, 128, 14, 2)):
                qs = torch.tensor(rng.normal(size=(N, SL, H, bs, D)),
                                  dtype=dtype, device=dev)
                kxt = torch.tensor(rng.normal(size=(N, EX, KH, bs, D)),
                                   dtype=dtype, device=dev)
                vxt = torch.tensor(rng.normal(size=(N, EX, KH, bs, D)),
                                   dtype=dtype, device=dev)
                # one document stream: slot s / kv row r at s*bs / r*bs
                q_pos = (np.arange(bs)[None] + np.arange(SL)[:, None] * bs)
                q_seg = np.zeros((SL, bs), np.int32)
                q_seg[SL - 1] = -1                 # trash slot
                q_seg[0, 7] = -1                   # a fully masked row
                kv_pos = (np.arange(bs)[None] + np.arange(EX)[:, None] * bs)
                kv_seg = np.zeros((EX, bs), np.int32)
                kv_seg[EX - 1] = -1                # kv trash row
                # worker 0: slot 0 <- {0}, slot 2 <- {0, 1, 2}, trash step;
                # worker 1: slot 1 <- {0, 1}, slot 2 <- {2}; slot 3 of
                # both workers is never visited (must pass through)
                sq = np.array([[0, 2, 2, 2, SL - 1], [1, 1, 2, SL - 1,
                                                     SL - 1]], np.int32)
                skv = np.array([[0, 0, 1, 2, EX - 1],
                                [0, 1, 2, EX - 1, EX - 1]], np.int32)
                tabs = [torch.from_numpy(x).to(dev) for x in (
                    sq, skv, np.stack([q_seg] * N),
                    np.stack([q_pos] * N).astype(np.int32),
                    kv_seg[skv], kv_pos[skv].astype(np.int32))]
                acc_o = torch.tensor(rng.normal(size=(N, SL, H, bs, D)),
                                     dtype=torch.float32, device=dev)
                acc_l = torch.tensor(rng.normal(size=(N, SL, H, bs)) + 5,
                                     dtype=torch.float32, device=dev)
                acc_l[:, 0] = -1e30                # fresh slot: empty acc
                acc_o[:, 0] = 0
                ko, kl = acc_o.clone(), acc_l.clone()
                po, pl = acc_o.clone(), acc_l.clone()
                st_q, st_kv, qsg, qps, ksg, kps = tabs
                fa.fused_flash_fwd(st_q, st_kv, qs, kxt, vxt, qsg, qps, ksg,
                                   kps, ko, kl, mask=mask)
                fa.fused_flash_fwd_plain(st_q, st_kv, qs, kxt, vxt, qsg,
                                         qps, ksg, kps, po, pl, mask=mask)
                torch.cuda.synchronize()
                name = f"fused_flash_fwd {mask} {dtype} D={D}"
                vis = [0, 1, 2]
                compare(name, ko[:, vis], kl[:, vis], po[:, vis],
                        pl[:, vis])
                if not (torch.equal(ko[:, 3], acc_o[:, 3])
                        and torch.equal(kl[:, 3], acc_l[:, 3])):
                    raise AssertionError(f"{name}: untouched slot changed")
                # worker 0 never visits slot 1, worker 1 never slot 0
                if not (torch.equal(ko[0, 1], acc_o[0, 1])
                        and torch.equal(ko[1, 0], acc_o[1, 0])):
                    raise AssertionError(f"{name}: unvisited slot changed")


def main_path_fused(fa, ex, servelib, cfg, pcfg, dev):
    """The fused kernel at the serving path's shapes: the widest run of
    the bucket-2048 prefill plan (8192 tokens, 4 workers, 512 blocks)."""
    from repro_torch.core import plan_cache as pc
    budget, n_cp, E = 8192, 4, 2048
    sched = servelib.build_schedule(
        cfg, pcfg, list(pc.prefill_composition(E, budget)), n_cp,
        budget // n_cp)
    t = ex.schedule_tables(sched, dev)
    run = max((r for r in t["runs"] if r is not None),
              key=lambda r: r["step_q"].shape[1])
    return fused_fwd_row(fa, run, sched.spec, cfg, n_cp, dev, "serve")


def fused_fwd_row(fa, run, spec, cfg, nf: int, dev, phase: str) -> dict:
    """Kernel 1 on one run of a plan over ``nf`` stacked frames, bf16
    inputs from a seed: against its plain version (and a second launch,
    same bytes), timed, with its bound."""
    import torch
    from repro_torch.kernels import ref
    H, D, KH = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    SL, EX, bs = spec.slots + 1, spec.slots + spec.ext_slots + 1, \
        spec.block_size
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    qs, kxt, vxt = rnd(nf, SL, H, bs, D), rnd(nf, EX, KH, bs, D), \
        rnd(nf, EX, KH, bs, D)
    acc_o0 = rnd(nf, SL, H, bs, D, dtype=torch.float32)
    acc_l0 = rnd(nf, SL, H, bs, dtype=torch.float32) + 5
    ko, kl = acc_o0.clone(), acc_l0.clone()
    po, pl = acc_o0.clone(), acc_l0.clone()

    def kernel():
        return fa.fused_flash_fwd(
            run["step_q"], run["step_kv"], qs, kxt, vxt, run["q_seg"],
            run["q_pos"], run["k_seg"], run["k_pos"], ko, kl,
            mask=spec.mask, segments=run["segments"])

    def plain():
        return fa.fused_flash_fwd_plain(
            run["step_q"], run["step_kv"], qs, kxt, vxt, run["q_seg"],
            run["q_pos"], run["k_seg"], run["k_pos"], po, pl,
            mask=spec.mask)
    kernel()
    plain()
    torch.cuda.synchronize()
    err = compare("fused_flash_fwd main path", ko, kl, po, pl)
    # o's scale bias: the kernel's deviation along the plain output over
    # the q slots the run's steps touch, relative (a drift of the
    # accumulation toward zero shows as a negative value; summation noise
    # as one near 0)
    touched = torch.zeros(nf, SL, dtype=torch.bool, device=dev)
    touched[torch.arange(nf, device=dev)[:, None],
            run["step_q"].long()] = True
    touched[:, spec.q_trash] = False
    dk, pk = (ko - po)[touched].double(), po[touched].double()
    o_bias = float((dk * pk).sum() / (pk * pk).sum())
    # a second launch on the same inputs gives the same bytes
    ko2, kl2 = acc_o0.clone(), acc_l0.clone()
    ko.copy_(acc_o0)
    kl.copy_(acc_l0)
    kernel()
    fa.fused_flash_fwd(run["step_q"], run["step_kv"], qs, kxt, vxt,
                       run["q_seg"], run["q_pos"], run["k_seg"],
                       run["k_pos"], ko2, kl2, mask=spec.mask,
                       segments=run["segments"])
    if not (torch.equal(ko, ko2) and torch.equal(kl, kl2)):
        raise AssertionError("fused_flash_fwd main path: a second launch "
                             "gave other bytes")
    del ko2, kl2
    # timed calls fold into the accumulators in place: the values drift
    # (they stay finite), the work does not, since it depends only on
    # the run's tables
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, **PLAIN_TIMING)
    # the work this run's data needs: valid (q, k) pairs of real steps,
    # the q slots and kv rows the steps touch, accumulators in and out
    wk = torch.arange(nf, device=dev)[:, None]
    sq = run["step_q"].long()
    real = sq != spec.q_trash
    vm = ref.mask_matrix(run["q_seg"][wk, sq], run["q_pos"][wk, sq],
                         run["k_seg"], run["k_pos"], spec.mask)
    pairs = int((vm & real[..., None, None]).sum())
    flops = 4.0 * pairs * H * D
    n_q = sum(len(set(r[m].tolist())) for r, m in zip(sq, real))
    n_kv = sum(len(set(r[m].tolist())) for r, m in
               zip(run["step_kv"].long(), real))
    nbytes = (n_q * H * bs * D * 2 + 2 * n_kv * KH * bs * D * 2
              + 2 * n_q * H * bs * (D + 1) * 4)
    return {"name": "fused_flash_fwd", "phase": phase,
            "max_abs_err": err, "o_scale_bias": o_bias, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **bound(flops, PEAK_BF16, nbytes),
            "shape": f"N={nf} S={sq.shape[1]} SL={SL} EX={EX} H={H} "
                     f"bs={bs} D={D} bf16"}


def main_path_decode(fa, cfg, dev):
    """The decode kernel at the serving path's shapes: 8 slots x 2 cache
    shards of a 4096-token bf16 cache, one layer (the split-KV variant)."""
    import torch
    import torch.nn.functional as F
    B, S, n_sh = 8, 4096, 2
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sl = S // n_sh
    g = torch.Generator(device=dev).manual_seed(3)
    ck = torch.randn((B, S, KH, D), generator=g, device=dev).bfloat16()
    cv = torch.randn((B, S, KH, D), generator=g, device=dev).bfloat16()
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    lengths = torch.tensor(
        np.random.default_rng(4).integers(65, 2081, B), device=dev)
    kc = ck.view(B * n_sh, sl, KH, D).transpose(1, 2)
    vc = cv.view(B * n_sh, sl, KH, D).transpose(1, 2)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    seg = torch.where(pos[None] < lengths[:, None], 0, -1).int()
    seg = seg.view(B * n_sh, sl)
    pos_k = pos.view(n_sh, sl).repeat(B, 1)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    qq = q[:, None].expand(B, n_sh, H, D).reshape(B * n_sh, H, 1, D)
    args = (qq, kc, vc, zero, zero, seg, pos_k)
    if fa.fwd_variant(1) != "decode":
        raise AssertionError("Sq = 1 does not take the decode variant")
    err = flash_variants(fa, "flash_attention_fwd main path decode", args,
                         False)
    # the kernels (split and merge) alone on inputs prepared once: the
    # wrapper's checks take about as long as the kernels, so events around
    # back-to-back wrapper calls would time the host; the wrapper beside
    prep = fa._flash_fwd_prep(*args, False, None)
    ms = time_ms(lambda: fa._launch_fwd(prep, "decode"))
    wrapper_ms = time_ms(lambda: fa.flash_attention_fwd(*args, mask=False))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(*args,
                                                            mask=False),
                       **PLAIN_TIMING)
    # the other variant on the same inputs, for the record
    tiled_ms = time_ms(lambda: fa._launch_fwd(prep, "tiled"))
    # yardstick only (the port never calls it): one library call over
    # the same cache with a length mask, as the device time of its kernels
    amask = (pos[None] < lengths[:, None])[:, None, None, :]
    n_keys = int(lengths.sum())
    flops = 4.0 * n_keys * H * D
    nbytes = 2 * n_keys * KH * D * 2 + B * n_sh * H * D * (2 + 4) \
        + B * n_sh * H * 4
    lib_ms, lib_kernels = device_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
        attn_mask=amask, enable_gqa=H != KH),
        floor=bound(flops, PEAK_BF16, nbytes)["bound_ms"])
    return {"name": "flash_attention_fwd", "phase": "serve",
            "max_abs_err": err, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "tiled_variant_ms": tiled_ms,
            "library": "scaled_dot_product_attention forward, device time "
                       "of its kernels: " + ", ".join(
                           f"{n} {t:.4f}" for n, t in lib_kernels.items()),
            **bound(flops, PEAK_BF16, nbytes),
            "shape": f"B={B}x{n_sh} shards H={H} Sq=1 Sk={sl} D={D} bf16, "
                     f"{n_keys} live keys, {fa.decode_splits(sl)} splits "
                     f"of {fa.DECODE_SPLIT}"}


def compare_grad(name: str, a, b, bf16_out: bool = False) -> float:
    """Max |a - b| over max |b| (raises past TOL_GRAD, or on a
    non-finite value).  An output stored in bf16 may also differ by one
    bf16 ulp of each value (at most 2**-7 of it): the kernel and the
    plain version round f32 sums taken in different orders, which can
    land on either side of a rounding boundary.  Returns the max abs
    error."""
    import torch
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if bf16_out:
        diff = torch.clamp(diff - 2.0 ** -7 * b.abs(), min=0.0)
    err = float(diff.max()) / max(float(b.abs().max()), 1e-30)
    if not (err <= TOL_GRAD and bool(torch.isfinite(a).all())):
        raise AssertionError(f"{name}: err {err:.3e} (tol {TOL_GRAD})")
    return float((a - b).abs().max())


def bwd_tables(sq, skv, kv_seg, kv_pos):
    """The kv-sorted backward tables of q-sorted step tables (per worker,
    by kv row then q slot, as the schedule sorts them)."""
    order = np.lexsort((sq, skv), axis=-1)
    bq = np.take_along_axis(sq, order, -1)
    bkv = np.take_along_axis(skv, order, -1)
    return bq, bkv, kv_seg[bkv], kv_pos[bkv].astype(np.int32)


def small_bwd_fused_cases(fa, masks, dev):
    """Kernels 3 and 4 against their plain versions: shared kv rows, an
    incoming accumulator, a q slot over three steps, trash steps (skipped
    by the segment tables), a fully masked row, GQA groups 2, 8, 1, 4, 3
    and 7 (at D 16 and 64), ragged tiles (bs 80), D 64, 32, 128, 80 and
    16, f32 and bf16 inputs.  Each
    kernel runs twice on the same inputs and must give the same bytes."""
    import torch
    rng = np.random.default_rng(6)
    N, SL, EX = 2, 5, 6
    for dtype in (torch.float32, torch.bfloat16):
        for mask in masks:
            for D, bs, H, KH in ((64, 128, 4, 2), (32, 80, 8, 1),
                                 (64, 80, 4, 4), (32, 128, 8, 2),
                                 (128, 128, 4, 2), (128, 80, 8, 1),
                                 (64, 128, 6, 2), (128, 80, 12, 4),
                                 (80, 128, 4, 4), (80, 80, 4, 4),
                                 (16, 128, 7, 1), (16, 80, 4, 4),
                                 (64, 80, 14, 2)):
                def rnd(*shape, dt=dtype):
                    return torch.tensor(rng.normal(size=shape), dtype=dt,
                                        device=dev)
                qs, kxt, vxt = rnd(N, SL, H, bs, D), rnd(N, EX, KH, bs, D), \
                    rnd(N, EX, KH, bs, D)
                q_pos = (np.arange(bs)[None] + np.arange(SL)[:, None] * bs)
                q_seg = np.zeros((SL, bs), np.int32)
                q_seg[SL - 1] = -1
                q_seg[0, 7] = -1
                kv_pos = (np.arange(bs)[None] + np.arange(EX)[:, None] * bs)
                kv_seg = np.zeros((EX, bs), np.int32)
                kv_seg[EX - 1] = -1
                sq = np.array([[0, 2, 2, 2, SL - 1], [1, 1, 2, SL - 1,
                                                     SL - 1]], np.int32)
                skv = np.array([[0, 0, 1, 2, EX - 1],
                                [0, 1, 2, EX - 1, EX - 1]], np.int32)
                bq, bkv, ksb, kpb = bwd_tables(sq, skv, kv_seg, kv_pos)

                def dev_t(*xs):
                    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                            for x in xs]
                st_q, st_kv, qsg, qps, ksg, kps, b_q, b_kv, ksg_b, kps_b = \
                    dev_t(sq, skv, np.stack([q_seg] * N),
                          np.stack([q_pos] * N).astype(np.int32),
                          kv_seg[skv], kv_pos[skv].astype(np.int32), bq, bkv,
                          ksb, kpb)
                seg_q = dev_t(*fa.run_segments(sq, skip_slot=SL - 1))
                seg_kv = dev_t(*fa.run_segments(bkv, skip_slot=EX - 1))
                o2 = rnd(N, SL, H, bs, D, dt=torch.float32)
                l2 = rnd(N, SL, H, bs, dt=torch.float32) + 5
                l2[:, 0] = -1e30
                o2[:, 0] = 0
                fa.fused_flash_fwd_plain(st_q, st_kv, qs, kxt, vxt, qsg, qps,
                                         ksg, kps, o2, l2, mask=mask)
                go = rnd(N, SL, H, bs, D, dt=torch.float32)
                delta = (go * o2).sum(-1) - rnd(N, SL, H, bs,
                                                dt=torch.float32)
                grads = (l2, go, delta)
                name = f"fused_flash_bwd {mask} {dtype} D={D} bs={bs}"
                dq = fa.fused_flash_bwd_dq(st_q, st_kv, qs, kxt, vxt, qsg,
                                           qps, ksg, kps, *grads, mask=mask,
                                           segments=seg_q)
                dq_p = fa.fused_flash_bwd_dq_plain(
                    st_q, st_kv, qs, kxt, vxt, qsg, qps, ksg, kps, *grads,
                    mask=mask)
                dk, dv = fa.fused_flash_bwd_dkv(
                    b_q, b_kv, qs, kxt, vxt, qsg, qps, ksg_b, kps_b, *grads,
                    mask=mask, segments=seg_kv)
                dk_p, dv_p = fa.fused_flash_bwd_dkv_plain(
                    b_q, b_kv, qs, kxt, vxt, qsg, qps, ksg_b, kps_b, *grads,
                    mask=mask)
                dq2 = fa.fused_flash_bwd_dq(st_q, st_kv, qs, kxt, vxt, qsg,
                                            qps, ksg, kps, *grads, mask=mask,
                                            segments=seg_q)
                dk2, dv2 = fa.fused_flash_bwd_dkv(
                    b_q, b_kv, qs, kxt, vxt, qsg, qps, ksg_b, kps_b, *grads,
                    mask=mask, segments=seg_kv)
                torch.cuda.synchronize()
                # the trash slot / kv trash row: skipped by the kernels
                compare_grad(name + " dq", dq[:, :SL - 1], dq_p[:, :SL - 1])
                compare_grad(name + " dk", dk[:, :EX - 1], dk_p[:, :EX - 1])
                compare_grad(name + " dv", dv[:, :EX - 1], dv_p[:, :EX - 1])
                for n_, a_, again in (("dq", dq, dq2), ("dk", dk, dk2),
                                      ("dv", dv, dv2)):
                    if a_.dtype != torch.float32:
                        raise AssertionError(f"{name} {n_}: dtype {a_.dtype}")
                    if not torch.equal(a_, again):
                        raise AssertionError(f"{name} {n_}: a second launch "
                                             f"gave other bytes")
                # unvisited: slot 3, slot 1 of worker 0, rows 3-4, trash
                if (dq[:, 3].any() or dq[0, 1].any() or dq[:, SL - 1].any()
                        or dk[:, 3:].any() or dv[:, 3:].any()):
                    raise AssertionError(f"{name}: unvisited slot written")


def small_bwd_flash_cases(fa, masks, dev):
    """Kernels 5 and 6 against their plain versions, with a non-zero
    dlse, GQA (groups 2, 8, 4, 3 and 7, the last at D 16 and 64), a fully
    masked row, ragged tiles (Sq and Sk not multiples of 16 or 64), D 64,
    32, 128, 80 and 16, f32 and bf16;
    one document without padding in the group-4 and a D = 128 case, so
    their tiles include ones where every pair is valid.  Each kernel runs
    twice on the same inputs and must give the same bytes."""
    import torch
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        for mask in masks:
            for (B, H, KH, Sq, Sk, D), docs, pad in (
                    ((2, 4, 2, 128, 256, 64), 3, 0.1),
                    ((1, 8, 1, 96, 160, 32), 3, 0.1),
                    ((1, 4, 4, 72, 200, 64), 3, 0.1),
                    ((1, 8, 2, 128, 192, 64), 1, 0.0),
                    ((2, 4, 2, 128, 256, 128), 3, 0.1),
                    ((1, 8, 1, 72, 200, 128), 1, 0.0),
                    ((1, 6, 2, 128, 200, 64), 3, 0.1),
                    ((1, 12, 4, 72, 192, 128), 1, 0.0),
                    ((1, 4, 4, 72, 200, 80), 3, 0.1),
                    ((2, 4, 4, 128, 192, 80), 1, 0.0),
                    ((1, 7, 1, 72, 200, 16), 3, 0.1),
                    ((2, 4, 4, 128, 192, 16), 1, 0.0),
                    ((1, 14, 2, 72, 200, 64), 3, 0.1)):
                def rnd(*shape, dt=dtype):
                    return torch.tensor(rng.normal(size=shape), dtype=dt,
                                        device=dev)
                q, k, v = rnd(B, H, Sq, D), rnd(B, KH, Sk, D), \
                    rnd(B, KH, Sk, D)
                seg_k, pos_k = _meta(rng, Sk, docs, pad)
                seg_q, pos_q = seg_k[-Sq:].copy(), pos_k[-Sq:].copy()
                seg_q[5] = -1
                t = [torch.from_numpy(np.stack([x] * B)).to(dev)
                     for x in (seg_q, pos_q, seg_k, pos_k)]
                o, lse = fa.flash_attention_fwd_plain(q, k, v, *t, mask=mask)
                do = rnd(B, H, Sq, D, dt=torch.float32)
                dlse = rnd(B, H, Sq, dt=torch.float32)
                args = (q, k, v, *t, o, lse, do, dlse)
                name = f"flash_attention_bwd {mask} {dtype} " \
                    f"{(B, H, KH, Sq, Sk, D)}"
                bf = dtype == torch.bfloat16
                dq = fa.flash_attention_bwd_dq(*args, mask=mask)
                dk, dv = fa.flash_attention_bwd_dkv(*args, mask=mask)
                dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(*args,
                                                                mask=mask)
                dq2 = fa.flash_attention_bwd_dq(*args, mask=mask)
                dk2, dv2 = fa.flash_attention_bwd_dkv(*args, mask=mask)
                torch.cuda.synchronize()
                for n_, a_, b_, again in (("dq", dq, dq_p, dq2),
                                          ("dk", dk, dk_p, dk2),
                                          ("dv", dv, dv_p, dv2)):
                    if a_.dtype != dtype:
                        raise AssertionError(f"{name} {n_}: dtype {a_.dtype}")
                    compare_grad(f"{name} {n_}", a_, b_, bf16_out=bf)
                    if not torch.equal(a_, again):
                        raise AssertionError(f"{name} {n_}: a second launch "
                                             f"gave other bytes")


def main_path_bwd(fa, ex, trainlib, cfg, pcfg, dev, pods: int = 1):
    """Kernels 3-6 at the training path's shapes: the widest run of the
    first training step's plan (the CLI's loader and schedule: 8192
    tokens a pod, 4 workers, 512 blocks), and one per-step block of that
    run (the ``pallas`` executor's batched launch over the stacked
    workers).  With ``pods`` > 1, the pod step's shapes (``pods`` x 4
    frames, the pod tables), and kernel 1 on the same run as well."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data.loader import SyntheticLoader
    from repro_torch.kernels import ref
    n_plan, tpw = 4, 2048
    n_cp = pods * n_plan                         # stacked frames
    b = SyntheticLoader(dist="real_world", n_frames=n_plan,
                        tokens_per_worker=tpw, vocab_size=cfg.vocab_size,
                        pods=pods, seed=0,
                        bucket_min_len=pcfg.block_size).next()
    sched = trainlib.build_schedule(cfg, pcfg, b.seqlens, n_plan, tpw)
    t = ex.schedule_tables(sched, dev, pods)
    run = max((r for r in t["runs"] if r is not None),
              key=lambda r: r["step_q"].shape[1])
    spec = sched.spec
    fwd_row = ([fused_fwd_row(fa, run, spec, cfg, n_cp, dev, "train")]
               if pods > 1 else [])
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
             - 1e-2 * rnd(n_cp, SL, H, bs, dtype=torch.float32)).contiguous()
    fwd_t = (run["step_q"], run["step_kv"], qs, kxt, vxt, run["q_seg"],
             run["q_pos"], run["k_seg"], run["k_pos"], l2, go, delta)
    bwd_t = (run["bwd_q"], run["bwd_kv"], qs, kxt, vxt, run["q_seg"],
             run["q_pos"], run["k_seg_b"], run["k_pos_b"], l2, go, delta)

    def k3():
        return fa.fused_flash_bwd_dq(*fwd_t, mask=spec.mask,
                                     segments=run["segments"])

    def p3():
        return fa.fused_flash_bwd_dq_plain(*fwd_t, mask=spec.mask)

    def k4():
        return fa.fused_flash_bwd_dkv(*bwd_t, mask=spec.mask,
                                      segments=run["kv_segments"])

    def p4():
        return fa.fused_flash_bwd_dkv_plain(*bwd_t, mask=spec.mask)
    qt, kt = spec.q_trash, spec.kv_trash
    dq = k3()
    err3 = compare_grad("fused_flash_bwd_dq main path", dq[:, :qt],
                        p3()[:, :qt])
    (dk, dv), (dk_p, dv_p) = k4(), p4()
    err4 = max(compare_grad("fused_flash_bwd_dkv main path dk", dk[:, :kt],
                            dk_p[:, :kt]),
               compare_grad("fused_flash_bwd_dkv main path dv", dv[:, :kt],
                            dv_p[:, :kt]))
    del dk_p, dv_p
    dk2, dv2 = k4()
    if not (torch.equal(k3(), dq) and torch.equal(dk2, dk)
            and torch.equal(dv2, dv)):
        raise AssertionError("fused_flash_bwd main path: a second launch "
                             "gave other bytes")
    del dq, dk, dv, dk2, dv2
    times = {n: time_ms(f, **(PLAIN_TIMING if n[0] == "p" else {}))
             for n, f in (("k3", k3), ("p3", p3), ("k4", k4), ("p4", p4))}
    # the work this run's data needs (real steps' valid pairs, the slots
    # and rows they touch); flop per valid pair and head: dq 6 D (s, g_o.v,
    # ds.k), dk/dv 8 D (s, g_o.v, p.g_o, ds.q)
    wk = torch.arange(n_cp, device=dev)[:, None]
    sq = run["step_q"].long()
    real = sq != spec.q_trash
    vm = ref.mask_matrix(run["q_seg"][wk, sq], run["q_pos"][wk, sq],
                         run["k_seg"], run["k_pos"], spec.mask)
    pairs = int((vm & real[..., None, None]).sum())
    n_q = sum(len(set(r[m].tolist())) for r, m in zip(sq, real))
    n_kv = sum(len(set(r[m].tolist())) for r, m in
               zip(run["step_kv"].long(), real))
    q_in = n_q * H * bs * (D * 2 + D * 4 + 8)     # q bf16, g_o f32, L, delta
    kv_in = 2 * n_kv * KH * bs * D * 2
    shape = (f"N={n_cp} S={sq.shape[1]} SL={SL} EX={EX} H={H} bs={bs} "
             f"D={D} bf16, {pairs} valid pairs")
    rows = fwd_row + [{"name": "fused_flash_bwd_dq", "phase": "train",
             "max_abs_err": err3,
             "ms": times["k3"], "plain_ms": times["p3"], "library_ms": None,
             **bound(6.0 * pairs * H * D, PEAK_BF16,
                     q_in + kv_in + qs.numel() * 4), "shape": shape},
            {"name": "fused_flash_bwd_dkv", "phase": "train",
             "max_abs_err": err4,
             "ms": times["k4"], "plain_ms": times["p4"], "library_ms": None,
             **bound(8.0 * pairs * H * D, PEAK_BF16,
                     q_in + kv_in + 2 * kxt.numel() * 4), "shape": shape}]

    # one per-step block: the step index with the most valid pairs,
    # batched over the 4 workers as the pallas executor launches it
    w = wk[:, 0]
    best = max(range(len(run["steps"])), key=lambda i: int(
        (vm[:, i] & real[:, i, None, None]).sum()))
    ssq, skv, q_seg, q_pos, k_seg, k_pos = run["steps"][best]
    q, k, v = qs[w, ssq], kxt[w, skv], vxt[w, skv]
    fwd_args = (q, k, v, q_seg, q_pos, k_seg, k_pos)
    if fa.fwd_variant(q.shape[-2]) != "tiled":
        raise AssertionError("the training block does not take the tiled "
                             "variant")
    err2 = flash_variants(fa, "flash_attention_fwd main path block",
                          fwd_args, spec.mask)
    o, lse = fa.flash_attention_fwd(*fwd_args, mask=spec.mask)
    do = rnd(*o.shape, dtype=torch.float32) * 1e-2
    live = lse > -1e29
    dlse = torch.where(live, 1e-2 * rnd(*lse.shape, dtype=torch.float32),
                       0.0)
    args = (q, k, v, q_seg, q_pos, k_seg, k_pos, o, lse, do, dlse)
    # the kernels alone are timed on inputs prepared once (contiguous
    # q/k/v, f32 do/lse/dlse and delta); the wrappers (prep + launch) beside
    prep = fa._flash_bwd_prep(*args, spec.mask, None)

    def k5():
        return fa._launch_bwd_dq(prep)

    def w5():
        return fa.flash_attention_bwd_dq(*args, mask=spec.mask)

    def p5():
        return fa.flash_attention_bwd_dq_plain(*args, mask=spec.mask)

    def k6():
        return fa._launch_bwd_dkv(prep)

    def w6():
        return fa.flash_attention_bwd_dkv(*args, mask=spec.mask)

    def p6():
        return fa.flash_attention_bwd_dkv_plain(*args, mask=spec.mask)
    dq = w5()
    err5 = compare_grad("flash_attention_bwd_dq main path", dq, p5(),
                        bf16_out=True)
    (dk, dv), (dk_p, dv_p) = w6(), p6()
    err6 = max(compare_grad("flash_attention_bwd_dkv main path dk", dk, dk_p,
                            bf16_out=True),
               compare_grad("flash_attention_bwd_dkv main path dv", dv, dv_p,
                            bf16_out=True))
    dk2, dv2 = k6()
    if not (torch.equal(k5(), dq) and torch.equal(dk2, dk)
            and torch.equal(dv2, dv)):
        raise AssertionError("flash_attention_bwd main path: a second "
                             "launch gave other bytes")
    del dq, dk, dv, dk_p, dv_p, dk2, dv2
    times = {n: time_ms(f, **(PLAIN_TIMING if n[0] == "p" else {}))
             for n, f in (("k5", k5), ("w5", w5), ("p5", p5), ("k6", k6),
                          ("w6", w6), ("p6", p6))}
    # kernel 2 as at decode: alone on inputs prepared once, the wrapper
    # beside it
    prep2 = fa._flash_fwd_prep(*fwd_args, spec.mask, None)
    times["k2"] = time_ms(lambda: fa._launch_fwd(prep2, "tiled"))
    times["w2"] = time_ms(lambda: fa.flash_attention_fwd(*fwd_args,
                                                         mask=spec.mask))
    times["p2"] = time_ms(lambda: fa.flash_attention_fwd_plain(
        *fwd_args, mask=spec.mask), **PLAIN_TIMING)
    times["d2"] = time_ms(lambda: fa._launch_fwd(prep2, "decode"))
    # yardstick only (the port never calls it): the library's attention
    # backward through autograd over the same block, boolean mask, dlse 0;
    # its device time is the sum of the kernels it launches
    vmask = ref.mask_matrix(q_seg, q_pos, k_seg, k_pos, spec.mask)[:, None]
    pairs = int(vm[:, best].sum())
    # what both kernels read: q, k, v (bf16), do (f32), lse, delta and
    # dlse (f32 per q row), seg/pos (int32); then each one's outputs
    ins = (q.numel() + k.numel() + v.numel()) * 2 + do.numel() * 4 \
        + 3 * lse.numel() * 4 \
        + 4 * sum(x.numel() for x in (q_seg, q_pos, k_seg, k_pos))
    b2 = bound(4.0 * pairs * H * D, PEAK_BF16,
               (q.numel() + k.numel() + v.numel()) * 2
               + 4 * sum(x.numel() for x in (q_seg, q_pos, k_seg, k_pos))
               + q.numel() * 4 + lse.numel() * 4)
    b5 = bound(6.0 * pairs * H * D, PEAK_BF16, ins + q.numel() * 2)
    b6 = bound(8.0 * pairs * H * D, PEAK_BF16, ins + 2 * k.numel() * 2)
    # and its forward alone, without autograd, for kernel 2 (each at
    # least the work of the valid pairs: the rows' bounds are floors)
    with torch.no_grad():
        lib2_ms, lib2_kernels = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vmask,
                                                   enable_gqa=H != KH),
            floor=b2["bound_ms"])
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=vmask,
                                        enable_gqa=H != KH)
    dol = do.to(ol.dtype)
    lib_ms, lib_kernels = device_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dol, retain_graph=True),
        floor=max(b5["bound_ms"], b6["bound_ms"]))
    del ol
    shape = (f"B={n_cp} H={H} Sq=Sk={bs} D={D} bf16, step {best} of the "
             f"run, {pairs} valid pairs")
    lib = ("scaled_dot_product_attention backward (dq, dk, dv together), "
           "device time of its kernels: " + ", ".join(
               f"{n} {ms:.4f}" for n, ms in lib_kernels.items()))
    lib2 = ("scaled_dot_product_attention forward, device time of its "
            "kernels: " + ", ".join(f"{n} {ms:.4f}"
                                    for n, ms in lib2_kernels.items()))
    rows += [{"name": "flash_attention_fwd", "phase": "pallas",
              "max_abs_err": err2,
              "ms": times["k2"], "wrapper_ms": times["w2"],
              "plain_ms": times["p2"],
              "library_ms": lib2_ms, "library": lib2,
              "decode_variant_ms": times["d2"], **b2, "shape": shape}]
    rows += [{"name": "flash_attention_bwd_dq", "phase": "pallas",
              "max_abs_err": err5,
              "ms": times["k5"], "wrapper_ms": times["w5"],
              "plain_ms": times["p5"], "library_ms": lib_ms, "library": lib,
              **b5, "shape": shape},
             {"name": "flash_attention_bwd_dkv", "phase": "pallas",
              "max_abs_err": err6,
              "ms": times["k6"], "wrapper_ms": times["w6"],
              "plain_ms": times["p6"], "library_ms": lib_ms, "library": lib,
              **b6, "shape": shape}]
    return rows


def device_events(prof) -> list:
    """``(name, us)`` of every device activity of a finished
    ``torch.profiler`` run, read from its raw trace: ``prof.events()``
    builds every host and device event's Python object and their tree
    (about 80 us an event), which took tens of seconds of host time for
    one profiled step of the per-step executor."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_ms(fn, n: int = 20, tries: int = 3,
              floor: float = 0.0) -> tuple[float, dict]:
    """Device ms per call of ``fn``: the sum of the device activity of
    ``n`` calls under ``torch.profiler`` over ``n``, after three untimed
    calls; and the same per kernel name.  The profiler now and then
    records no device activity, or only part of it, in a process that
    has profiled before, so a window that records nothing, or whose sum
    falls short of ``floor`` (the least time the call's work can take),
    is tried again, up to ``tries`` windows; then CUDA events time the
    call (``time_ms``, launch gaps included), under a name that says
    so."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per: dict[str, float] = {}
        for name, us in device_events(prof):
            per[name] = per.get(name, 0.0) + us
        per = {name[:90]: us / 1e3 / n for name, us in per.items()}
        if per and sum(per.values()) >= floor:
            return sum(per.values()), per
    ms = time_ms(fn)
    return ms, {"the call between CUDA events (the profiler recorded "
                "nothing, or less than the bound)": ms}


def bound(flops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

class PinnedRoutes:
    """Top-k routing pinned across runs of one model, in place of
    ``moe.route`` inside a ``with`` block: the first call of each layer's
    router (keyed by its weights' address and the input's shape) keeps
    the experts ``moe.route`` chooses; every call, that one too, takes
    the kept experts with the weights its own router probabilities
    (``moe.router_probs``) give them, renormalized as ``moe.route`` does.
    Top-k routing is discontinuous: the kernels' f32 deviation from the
    plain attention (~2**-16 relative, the bf16 hi/lo split) moves some
    tokens across a near-tie of two experts, and a token that takes
    another expert moves every later token it attends to.  A run that
    replays the experts a plain run chose differs from it only through
    continuous functions, so it is held to the dense model's tolerance.
    With ``replay`` set, a router call that was not recorded raises."""

    def __init__(self, moe):
        self.moe, self.inner, self.ids, self.replay = moe, moe.route, {}, False

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.inner

    def __call__(self, x, router, cfg):
        import torch
        key = (router.data_ptr(), tuple(x.shape))
        if key not in self.ids:
            if self.replay:
                raise AssertionError(f"router call {key} was not recorded")
            with torch.no_grad():   # a recomputed layer saves the same
                self.ids[key] = self.inner(x, router, cfg)[1]
        eidx = self.ids[key]
        w = self.moe.router_probs(x, router, cfg).gather(-1, eidx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), eidx


def serve(fa, cfg, pcfg, scfg, dev, n_req=16, max_len=2048,
          eager: bool = False):
    """Serve ``n_req`` requests of 64..``max_len`` prompt tokens (seed 0)
    through the port's ``ServingLoop`` on a stacked 4 x 2 mesh, with the
    counters of kernels 1 and 2 read around the run and the programs
    built after warmup counted (zero recompiles); with ``eager`` the same
    stream again through the eager methods (``eager_stream``: tokens
    identical, tokens/s both ways).  Then hold the first prefill batch's
    logits, kernels against plain, and the programs against the eager
    methods (``program_checks``: bytes, launches against a profile, times
    side by side).

    With f32 weights the kernels run with the experts the plain run chose
    (``PinnedRoutes``; no effect on a dense model) and are held to
    TOL_SERVE_F32.  For an MoE model the unpinned f32 error and a null
    floor (the plain path with each attention output moved by the
    kernels' own deviation from it under random signs, the largest of
    three draws) are printed beside it.

    A recurrent model (SSM, hybrid) chunks its prompts down to a bucket
    edge, and its prefill step reads no last index.  An attention-free
    model (SSM) launches no kernel: its kernel checks give way to
    ``ssm_check`` (the chunked scan against the recurrent decode)."""
    import torch
    from repro_torch.launch import serve as servelib
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model, moe
    from repro_torch.models.registry import RECURRENT
    from repro_torch.runtime.serving import ServingLoop
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    loop = ServingLoop(model, params, StackedMesh((4, 2), ("data", "model")),
                       pcfg, scfg, device=dev)
    t0 = time.perf_counter()
    base = loop.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, (int(L),)).astype(np.int32)
               for L in rng.integers(64, max_len + 1, n_req)]
    first = []
    inner = loop._prefill_and_insert

    def spy(reqs, free):                   # remember the first batch
        if not first and reqs[0].mode != "fresh":
            first.append((reqs[0].bucket, list(reqs)))
        return inner(reqs, free)
    loop._prefill_and_insert = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fused_flash_fwd.launches = 0
    fa.flash_attention_fwd.launches = 0
    report = loop.run(prompts, max_new=scfg.max_new_tokens)
    launches = {"fused_flash_fwd": fa.fused_flash_fwd.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    reserved_gb = torch.cuda.memory_reserved() / 2**30
    loop._prefill_and_insert = inner
    programs = recompile_check(loop, base)
    streams = eager_stream(loop, prompts, scfg.max_new_tokens, dev,
                           report) if eager else None
    if report["requests"] != len(prompts):
        raise AssertionError(f"served {report['requests']} of "
                             f"{len(prompts)} requests")
    for r in loop.stats.finished:
        if r.tokens is None or len(r.tokens) != scfg.max_new_tokens:
            raise AssertionError(f"request {r.rid} did not finish")
    if not bool(torch.isfinite(loop.last_logits.float()).all()):
        raise AssertionError("decode logits not finite")
    for name, n in launches.items():
        if cfg.uses_attention and n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the first prefill batch again, through the kernels and through the
    # plain versions, on the same schedule and weights.  With f32 copies
    # of the weights (and the plain run's experts) the two agree to a few
    # 1e-6, so TOL_SERVE_F32 catches a kernel that is wrong on a few rows.
    # With the bf16 weights a
    # 1-ulp difference in any attention output cascades through 24
    # layers of bf16 rounding to the format's own noise floor (~2e-2), so
    # that comparison is held to a multiple of the floor measured below.
    E, reqs = first[0]
    batch, last = loop.assemble(E, reqs)
    # the programs against the eager methods; then the programs go, and
    # their graphs' pools with them, before the f32 copies of the weights
    # (llama3-70b's 8 layers take 36 GB in f32 beside 31 GiB of pools)
    checks = program_checks(fa, loop, E, batch, last)
    loop._programs.clear()
    loop.last_logits = None
    release()
    params32 = {k: ({n: w.float() for n, w in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    common = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "params": model.param_count(params), "warmup_s": warm_s,
              "wall_s": report["wall_s"],
              "sustained_tok_s": report["sustained_tok_s"],
              "requests": report["requests"],
              "generated_tokens": report["generated_tokens"],
              "tail_tokens": report["tail_tokens"],
              "prefill_batches": report["prefill_batches"],
              "prefill_fill": report["prefill_fill"],
              "decode_steps": report["decode_steps"],
              "prefill_ms_p50": report["prefill_ms"]["p50"],
              "prefill_ms_p99": report["prefill_ms"]["p99"],
              "decode_ms_p50": report["decode_ms"]["p50"],
              "decode_ms_p99": report["decode_ms"]["p99"],
              "plan_cache_hit_rate": report["plan_cache"]["hit_rate"],
              "peak_mem_gib": peak_gb, "reserved_gib": reserved_gb,
              "launches": launches, "first_batch_bucket": E, **programs}
    if streams is not None:
        common["eager_stream"] = streams
    if not cfg.uses_attention:
        hold_replay(checks, None)
        out = {**common, "ssm_check": ssm_check(model, params32, loop, dev)}
        del params32
        return {**out, **checks}
    ragged = cfg.family not in RECURRENT
    logits, pins = {}, {}
    for tag, prm in (("bf16", params), ("f32", params32)):
        pins[tag] = PinnedRoutes(moe)
        for impl in ("fused_xla", "fused"):
            with pins[tag] as pin:
                pin.replay = impl == "fused"
                lg = loop.prefill_fn(E, impl)(prm, batch, last)[0].float()
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"prefill logits not finite ({tag}, "
                                     f"{impl})")
            logits[tag, impl] = lg

    def nerr(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
    errs = {"f32": nerr(logits["f32", "fused"], logits["f32", "fused_xla"]),
            "bf16": nerr(logits["bf16", "fused"], logits["bf16", "fused_xla"]),
            "bf16_vs_f32_plain": nerr(logits["bf16", "fused_xla"],
                                      logits["f32", "fused_xla"])}
    # bf16's noise floor on this batch: the plain path against itself with
    # every attention output nudged by one f32 ulp (relative 2**-23); the
    # largest of three nudges, so one lucky draw cannot set it low
    plain_attn = servelib.make_fcp_attn_fn(loop._schedule_for(E), dev,
                                           pcfg, "fused_xla")
    g = torch.Generator(device=dev).manual_seed(5)

    def nudged(q, k, v):
        o = plain_attn(q, k, v)
        sign = torch.randn(o.shape, generator=g, device=dev).sign()
        return o * (1 + 2.0 ** -23 * sign)
    step = servelib.build_prefill_step(model, nudged, loop.budget // E, E,
                                       ragged=ragged)
    rows = (batch, last) if ragged else (batch,)
    floor = []
    for _ in range(3):
        with pins["bf16"]:                 # the plain run's experts
            lg = step(params, *rows)[0].float()
        floor.append(nerr(lg, logits["bf16", "fused_xla"]))
    errs["bf16_floor"] = max(floor)
    if cfg.n_experts:
        # diagnostics only: the f32 kernels with their own routing, and
        # how far the kernels' deviation moves the plain path's logits
        # when it may flip experts (largest of three random-sign draws)
        kern_attn = servelib.make_fcp_attn_fn(loop._schedule_for(E), dev,
                                              pcfg, "fused")

        def flipped(q, k, v):
            o = plain_attn(q, k, v)
            sign = torch.randint(0, 2, o.shape, generator=g, device=dev)
            return o + (kern_attn(q, k, v) - o) * (2 * sign - 1).to(o.dtype)
        fstep = servelib.build_prefill_step(model, flipped, loop.budget // E,
                                            E, ragged=True)
        errs["f32_unpinned"] = nerr(
            loop.prefill_fn(E, "fused")(params32, batch, last)[0].float(),
            logits["f32", "fused_xla"])
        errs["f32_null_floor"] = max(
            nerr(fstep(params32, batch, last)[0].float(),
                 logits["f32", "fused_xla"]) for _ in range(3))
    del params32, pins
    if errs["f32"] > TOL_SERVE_F32:
        raise AssertionError(f"prefill logits kernels vs plain (f32 "
                             f"weights) {errs['f32']:.3e} > {TOL_SERVE_F32}")
    if errs["bf16"] > BF16_FLOORS * errs["bf16_floor"]:
        raise AssertionError(
            f"prefill logits kernels vs plain (bf16 weights) "
            f"{errs['bf16']:.3e} > {BF16_FLOORS} x the bf16 noise floor "
            f"{errs['bf16_floor']:.3e}")
    hold_replay(checks, errs["bf16_floor"])
    return {**common, "prefill_logits_err": errs, **checks}


def hold_replay(checks: dict, floor) -> None:
    """Replay against eager (``program_checks``): the same bytes, or, where
    not, the bf16 logits within BF16_FLOORS x ``floor`` (none for a model
    without one)."""
    for tag, r in checks["replay_vs_eager"].items():
        if not r["bitwise"] and (floor is None or r["logits_err"]
                                 > BF16_FLOORS * floor):
            raise AssertionError(
                f"{tag} replay vs eager: not the same bytes, logits "
                f"{r['logits_err']:.3e} (bf16 floor {floor})")


def programs_line(tag: str, r: dict, card: str) -> str:
    """One served configuration's programs beside its eager methods."""
    p, rv = r["profile"]["decode_step_replayed"], r["replay_vs_eager"]
    es = r.get("eager_stream")
    bucket = r.get("first_batch_bucket", r.get("prefill_batch_bucket"))
    return (f"  programs {tag}: recompiles after warmup "
            f"{r['recompiles_after_warmup']} ({len(r['programs'])} programs, "
            f"{sum(r['programs'].values())} builds); decode step eager "
            f"{r['decode_step_ms']:.3f} ms, replayed "
            f"{r['decode_step_ms_replayed']:.3f} ms (device "
            f"{p['device_ms']} ms, busy {p['busy_share']}); prefill batch "
            f"(bucket {bucket}) eager {r['prefill_batch_ms']:.3f} ms, "
            f"replayed {r['prefill_batch_ms_replayed']:.3f} ms; warmup "
            f"{r['warmup_s']:.2f} s; peak {r['peak_mem_gib']:.2f} GiB "
            f"(reserved {r['reserved_gib']:.2f}); tok/s "
            f"{r['sustained_tok_s']:.1f}" + (
                f" (eager {es['eager_tok_s']:.1f}, tokens identical "
                f"{es['tokens_identical']})" if es else "")
            + f"; bitwise decode {rv['decode']['bitwise']} prefill "
            f"{rv['prefill']['bitwise']}; on {card}")


def recompile_check(loop, base: dict) -> dict:
    """The programs built, by key, after the measured stream; fails unless
    it built none (zero recompiles after warmup)."""
    built = loop.compile_counts()
    recompiles = sum(built.values()) - sum(base.values())
    if recompiles != 0 or built.keys() != base.keys():
        raise AssertionError(f"recompiles after warmup: {recompiles} "
                             f"(warmup {base}, after the stream {built})")
    return {"programs": built, "recompiles_after_warmup": recompiles}


class EagerPrograms:
    """In place of ``ServingLoop._program``: every program call runs the
    program's eager function on its inputs (moved to the card), nothing
    captured — the loop's dispatch through its eager methods."""

    def __init__(self, dev):
        self.dev = dev

    def __call__(self, name, fn):
        def to(x):
            if isinstance(x, dict):
                return {k: to(v) for k, v in x.items()}
            return x.to(self.dev, non_blocking=True)

        def call(*inputs, held=None):
            return fn(*(to(x) for x in inputs))
        return call


def eager_stream(loop, prompts, max_new: int, dev, report: dict) -> dict:
    """The stream ``loop`` just served through its programs, again
    through the eager methods (``EagerPrograms``): the tokens must be
    identical, request by request; sustained tokens/s both ways."""
    def tokens():
        rs = sorted(loop.stats.finished, key=lambda r: r.rid)
        return [r.tokens.tolist() for r in rs]
    replayed = tokens()
    loop.reset_counters()
    loop._program = EagerPrograms(dev)
    try:
        rep = loop.run(prompts, max_new=max_new)
    finally:
        del loop._program
    same = tokens() == replayed
    out = {"tokens_identical": same,
           "replayed_tok_s": report["sustained_tok_s"],
           "eager_tok_s": rep["sustained_tok_s"],
           "replayed_wall_s": report["wall_s"], "eager_wall_s": rep["wall_s"],
           "eager_decode_steps": rep["decode_steps"]}
    if not same or rep["requests"] != len(prompts):
        raise AssertionError(f"the eager stream's tokens differ from the "
                             f"programs': {out}")
    return out


REPLAY_KERNELS = {"fused_flash_fwd": ("fused_fwd_kernel",),
                  "flash_attention_fwd": ("decode_kernel", "tiled_kernel"),
                  "fused_flash_bwd_dq": ("fused_dq_kernel",),
                  "fused_flash_bwd_dkv": ("fused_dkv_kernel",),
                  "flash_attention_bwd_dq": ("bwd_dq_kernel",),
                  "flash_attention_bwd_dkv": ("bwd_dkv_kernel",)}


def replay_launches(fa, fn, tries: int = 3) -> dict:
    """Kernels 1-6 in one call of ``fn`` (a program's replay): the
    counters' launches against the kernels' device events, by name, in a
    ``torch.profiler`` trace (a split-KV decode launch is one
    ``decode_kernel`` event and a merge); fails unless they are equal.  A
    trace with no device activity (the profiler now and then records
    none in a process that has profiled before) is taken again."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        reset_counters(fa)
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [name for name, _ in device_events(prof)]
        if names:
            break
    counted = {k: getattr(fa, k).launches for k in REPLAY_KERNELS}
    events = {k: sum(any(p in n for p in pat) for n in names)
              for k, pat in REPLAY_KERNELS.items()}
    out = {"counted": counted, "events": events,
           "device_events": len(names)}
    if counted != events or not names:
        raise AssertionError(f"a replay's counted launches are not its "
                             f"kernel events: {out}")
    return out


def program_checks(fa, loop, E: int, batch, last) -> dict:
    """The loop's programs against its eager methods on the same inputs,
    on the card: one decode step from one state and cache (logits, state
    and cache) and the prefill batch ``(batch, last)`` of bucket ``E``
    (logits and caches), bytes equal or not (``hold_replay`` holds them);
    kernels 1 and 2's counted launches of one decode and one prefill
    replay against their profile (``replay_launches``); the decode step's
    and the batch's wall eager and replayed, and their profiles."""
    import torch
    params = loop.params
    step = loop._programs["loop_step"]
    held = (loop.params, loop.state, loop.cache)
    prefill = loop._programs[f"prefill_{E}"]

    def decode_replay():
        return step(held=held)

    def prefill_replay():
        return prefill(batch, last, held=params)

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    def nerr(a, b):
        return float((a.float() - b.float()).abs().max()) / max(
            float(b.float().abs().max()), 1.0)
    st0, c0 = clone(loop.state), clone(loop.cache)
    lg_r = decode_replay().clone()
    st_r, c_r = clone(loop.state), clone(loop.cache)
    for live, saved in ((loop.state, st0), (loop.cache, c0)):
        for k in live:
            live[k].copy_(saved[k])
    del st0, c0
    lg_e = loop._loop_step()
    decode = {"bitwise": bool(
        torch.equal(lg_r, lg_e)
        and all(torch.equal(st_r[k], loop.state[k]) for k in st_r)
        and all(torch.equal(c_r[k], loop.cache[k]) for k in c_r)),
        "logits_err": nerr(lg_r, lg_e)}
    del st_r, c_r
    lg_p, cache_p = prefill_replay()
    lg_p, cache_p = lg_p.clone(), clone(cache_p)
    lg_pe, cache_pe = loop.prefill_fn(E)(params, batch, last)
    pre = {"bitwise": bool(torch.equal(lg_p, lg_pe) and all(
        torch.equal(cache_p[k], cache_pe[k]) for k in cache_p)),
        "logits_err": nerr(lg_p, lg_pe)}
    del lg_p, cache_p, lg_pe, cache_pe
    out = {"replay_vs_eager": {"decode": decode, "prefill": pre},
           "replay_launches": {"decode": replay_launches(fa, decode_replay),
                               "prefill": replay_launches(fa,
                                                          prefill_replay)}}
    # where the time goes: one decode step (all slots, as in the loop) and
    # the prefill batch, eager and replayed, timed and then under the
    # profiler for the device's busy share and its top kernels
    eager_prefill = loop.prefill_fn(E)
    out["decode_step_ms"] = wall_ms(loop._loop_step, 10)
    out["decode_step_ms_replayed"] = wall_ms(decode_replay, 10)
    out["prefill_batch_ms"] = wall_ms(
        lambda: eager_prefill(params, batch, last), 3)
    out["prefill_batch_ms_replayed"] = wall_ms(prefill_replay, 3)
    out["profile"] = {
        "decode_step": profile(loop._loop_step, 5),
        "decode_step_replayed": profile(decode_replay, 5),
        "prefill_batch": profile(lambda: eager_prefill(params, batch, last),
                                 1),
        "prefill_batch_replayed": profile(prefill_replay, 1)}
    return out


def ssm_check(model, params32, loop, dev, n: int = 256) -> dict:
    """An attention-free model on the card, f32 weights: the prefill
    step's last-token logits of an ``n``-token prompt (the chunked SSD
    scan, one chunk per ``ssm_chunk`` tokens) against feeding the same
    prompt token by token through the recurrent decode step from a zero
    cache, held to TOL_SSM_F32 (two forms of one recurrence, summed in
    other orders).  Also checks the prefill's final state against the
    decode's."""
    import torch
    cfg = model.cfg
    if n not in loop.edges or n % cfg.ssm_chunk:
        raise AssertionError(f"no bucket of {n} whole chunks")
    from repro_torch.runtime.serving import Request
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size, n)
    req = Request(rid=-1, prompt=prompt.astype(np.int32), max_new=1,
                  bucket=n, mode="chunk")
    batch, last = loop.assemble(n, [req])
    # the decode cache in f32 (the conv tail is kept in param_dtype)
    m32 = type(model)(cfg.replace(param_dtype="float32"))
    with torch.no_grad():
        lg_p, cache_p = loop.prefill_fn(n)(params32, batch, last)
        cache = m32.init_cache(1, 0, dev)
        tok = torch.from_numpy(prompt.astype(np.int32)).to(dev)
        for t in range(n):
            lg_d, cache = m32.decode_step(
                params32, tok[t:t + 1],
                torch.full((1,), t, dtype=torch.int32, device=dev), cache)
    torch.cuda.synchronize()

    def nerr(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
    out = {"prompt_tokens": n,
           "logits_err": nerr(lg_p[0].float(), lg_d[0].float()),
           "state_err": nerr(cache_p["state"][:, 0], cache["state"][:, 0])}
    if not (out["logits_err"] <= TOL_SSM_F32
            and out["state_err"] <= TOL_SSM_F32):
        raise AssertionError(f"SSM prefill vs recurrent decode (f32): "
                             f"{out} > {TOL_SSM_F32}")
    return out


def serve_tokens(fa, cfg, pcfg, scfg, dev, n_req=4, max_len=512) -> dict:
    """The serving loop twice on one short stream (``n_req`` prompts of
    64..``max_len`` tokens, seed 1), on the kernels (``attn_impl`` fused)
    and on their plain versions (fused_xla), with the same weights:
    f32, whose tokens must be the same (the kernels sit ~1e-6 from plain,
    far inside a top-2 logit gap), and bf16, whose token agreement is
    reported: bf16's own noise floor (~2e-2 of the logits, ``serve``)
    flips near-ties of random weights' logits."""
    import torch
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model
    from repro_torch.runtime.serving import ServingLoop
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, (int(L),)).astype(np.int32)
               for L in rng.integers(64, max_len + 1, n_req)]
    sc = scfg.replace(max_new_tokens=8)
    out = {}
    for tag in ("f32", "bf16"):
        prm = params if tag == "bf16" else {
            k: ({n: w.float() for n, w in v.items()}
                if isinstance(v, dict) else v.float())
            for k, v in params.items()}
        # the caches take the weights' dtype
        m = model if tag == "bf16" else Model(cfg.replace(
            param_dtype="float32"))
        toks = {}
        for impl in ("fused", "fused_xla"):
            loop = ServingLoop(m, prm, StackedMesh((4, 2), ("data",
                                                            "model")),
                               pcfg, sc, device=dev, attn_impl=impl)
            loop.run(prompts, max_new=8)
            toks[impl] = {r.rid: list(map(int, r.tokens))
                          for r in loop.stats.finished}
            del loop
            release()
        same = sum(a == b for r in toks["fused"] for a, b in zip(
            toks["fused"][r], toks["fused_xla"][r]))
        out[tag] = {"same_tokens": same, "tokens": 8 * n_req}
        del prm
    if out["f32"]["same_tokens"] != out["f32"]["tokens"]:
        raise AssertionError(f"f32 tokens kernels vs plain differ: {out}")
    return out


# --------------------------------------------------------------------------
# phase 4: train
# --------------------------------------------------------------------------

def reset_counters(fa) -> None:
    for f in fa.COUNTED:
        f.launches = 0


def read_counters(fa) -> dict:
    return {f.__name__: f.launches for f in fa.COUNTED}


def train_grad_check(trainlib, dev, argv, n_layers: int = 4) -> dict:
    """(a) Full width, ``n_layers`` layers, f32 weights, the first batch
    of the CLI's stream: each parameter's gradient through the kernels
    against the plain versions — fused executor (kernels 1, 3, 4 vs
    fused_xla), then per-step (kernels 2, 5, 6 vs xla).  An MoE model's
    kernel run takes the experts its plain run chose
    (``PinnedRoutes``)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.optimizer import adamw
    tr = trainlib.trainer_from_args(trainlib.parse_args(
        argv + ["--override", f"n_layers={n_layers}",
                "--override", "param_dtype=float32"]))
    tr.state.opt = None          # no step here: the AdamW moments' memory
    try:
        b = tr.loader.next()
        batch = trainlib.batch_arrays(b, tr.cfg, dev)
        sched = trainlib.build_schedule(tr.cfg, tr.pcfg, b.seqlens, tr.n_cp,
                                        tr.tpw, mask=tr.group_masks[0])
        out = {}
        for kern, plain in (("fused", "fused_xla"), ("pallas", "xla")):
            res = {}
            pin = PinnedRoutes(moe)
            for impl in (plain, kern):
                attn = trainlib.make_fcp_attn_fn(sched, dev, tr.pcfg, impl,
                                                 tr.pods)
                with pin:
                    pin.replay = impl == kern
                    loss, g = trainlib.value_and_grad(tr.model, tr.pcfg,
                                                      attn)(tr.state.params,
                                                            batch)
                res[impl] = (float(loss), adamw.tree_leaves(g))
            errs = []
            for a_, b_ in zip(res[kern][1], res[plain][1]):
                errs.append(float((a_ - b_).abs().max())
                            / max(float(b_.abs().max()), 1e-30))
            err = max(errs)
            if not (err <= TOL_TRAIN_F32 and all(
                    bool(torch.isfinite(x).all()) for x in res[kern][1])):
                raise AssertionError(
                    f"train grads {kern} vs {plain} (f32, {n_layers} "
                    f"layers): max leaf err {err:.3e} > {TOL_TRAIN_F32}")
            out[kern] = {"max_leaf_err": err, "loss": res[kern][0],
                         "loss_plain": res[plain][0]}
            del res
        return out
    finally:
        tr.close()


def step_programs(tr) -> dict:
    """A training loop's step programs: the steps that built one, each
    build's eager and capture seconds and graph nodes, and the memory the
    card holds with the loop's graph pool."""
    import torch
    progs = list((tr.step_cache if hasattr(tr, "step_cache")
                  else tr._step_cache).values())
    log_ = [b for p in progs for b in p.build_log]
    return {"compiled_at": list(tr.compiled_at),
            "builds": sum(p.builds for p in progs),
            "eager_ms": [b["eager_s"] * 1e3 for b in log_],
            "capture_s": [b["capture_s"] for b in log_],
            "instantiate_s": [b["instantiate_s"] for b in log_],
            "graph_nodes": [b["nodes"] for b in log_],
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}


def hold_warm(tag: str, tr, warm: int) -> int:
    """Zero recompiles after warmup: every program of ``tr`` was built in
    its first ``warm`` steps, one build each; returns the recompiles (0)."""
    late = [s for s in tr.compiled_at if s >= warm]
    builds = step_programs(tr)["builds"]
    if late or builds != len(tr.compiled_at):
        raise AssertionError(
            f"{tag}: programs built after the first {warm} steps "
            f"{tr.compiled_at} ({builds} builds)")
    return len(late)


class EagerSteps:
    """In place of a training loop's ``_program``: every step runs the
    key's eager step function, nothing captured (one closure built per
    key, as ``compiled_at`` counts).  Only an explicit argument with its
    reason passes it (``train_steps(eager_why=...)``)."""

    def __call__(self, name, fn):
        def call(*inputs, held=None):
            return fn(*inputs)
        call.fn, call.builds, call.build_log = fn, 1, []
        return call


def train_steps(fa, trainlib, dev, argv, steps: int,
                eager_why: str | None = None) -> dict:
    """The training CLI's main path, in process: one round of the
    stream's compositions (each plan key's first step builds its program:
    an eager step, then a capture), then ``steps`` replayed steps with
    the counters read around them, then one more replayed step under the
    profiler; nothing may be built after the round (zero recompiles
    after warmup).  Tokens/s and the profile are the replayed steps';
    the eager walls are the builds' eager calls.  With ``eager_why`` the
    loop's steps all run eagerly (``EagerSteps``), for that reason."""
    import torch
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    if eager_why:
        tr._program = EagerSteps()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm = len(tr.loader.compositions)
        warmup = tr.run(warm)
        reset_counters(fa)
        hist = tr.run(warm + steps)
        launches = read_counters(fa)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile(tr.step, 1)
        recompiles = hold_warm(argv_tag(argv), tr, warm)
        programs = step_programs(tr)
        stats = tr.plan_cache.stats
        n_params = tr.model.param_count(tr.state.params)
        n_layers = tr.cfg.n_layers
        tokens = tr.pods * tr.n_cp * tr.tpw
    finally:
        tr.close()
    del tr
    release()
    losses = [r.loss for r in warmup + hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    for name in ("fused_flash_fwd", "fused_flash_bwd_dq",
                 "fused_flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the train path")
    replayed = [r.ms for r in hist]
    out = {"n_layers": n_layers, "params": n_params, "losses": losses,
            "gnorms": [r.gnorm for r in warmup + hist],
            "step_ms": replayed, "warmup_step_ms": [r.ms for r in warmup],
            "eager_step_ms": float(np.median(programs["eager_ms"]
                                             or replayed)),
            "eager": eager_why,
            "tokens_per_step": tokens,
            "tokens_per_s": tokens / (float(np.mean(replayed)) / 1e3),
            "peak_mem_gib": peak, "launches_steps": launches,
            "launches_per_step": {n: launches[n] / steps for n in (
                "fused_flash_fwd", "fused_flash_bwd_dq",
                "fused_flash_bwd_dkv")},
            "plan_cache": {"hits": stats.hits, "misses": stats.misses},
            "recompiles_after_warmup": recompiles, "programs": programs,
            "profile_step": prof}
    log(programs_train_line(argv_tag(argv), out, card_line()))
    return out


def train_pallas(fa, trainlib, dev, argv) -> dict:
    """One ``--attn-impl pallas`` step (kernels 2, 5 and 6), which builds
    its program, then the loader rewound and the same batch's step
    replayed with its counters (PALLAS_WHY)."""
    argv = [x if x != "fused" else "pallas" for x in argv]
    argv[argv.index("--steps") + 1] = "2"
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    try:
        built = tr.step()
        tr.loader.state.step -= 1
        reset_counters(fa)
        rec = tr.step()
        launches_p = read_counters(fa)
        hold_warm(argv_tag(argv), tr, 1)
        programs = step_programs(tr)
    finally:
        tr.close()
    del tr
    release()
    if not (np.isfinite(rec.loss) and np.isfinite(built.loss)):
        raise AssertionError("pallas train loss not finite")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if launches_p[name] <= 0:
            raise AssertionError(f"{name} never launched on the pallas "
                                 f"train path")
    return {"loss": built.loss, "ms": rec.ms, "build_step_ms": built.ms,
            "eager_step_ms": programs["eager_ms"][0], "launches": launches_p,
            "programs": programs}


def argv_tag(argv) -> str:
    """A training command's model, mesh and the flags it adds to
    TRAIN_ARGV's."""
    extra = [x for x in argv[argv.index("--steps") + 2:]
             if x not in TRAIN_ARGV]
    return " ".join([argv[argv.index("--arch") + 1],
                     argv[argv.index("--mesh") + 1],
                     argv[argv.index("--attn-impl") + 1]] + extra)


def programs_train_line(tag: str, r: dict, card: str) -> str:
    """One trained configuration's step programs beside its eager step."""
    p, pr = r["profile_step"], r["programs"]
    if r.get("eager"):
        tag += f" [EAGER: {r['eager']}]"
    return (f"  train programs {tag}: {pr['builds']} builds (steps "
            f"{pr['compiled_at']}), recompiles after warmup "
            f"{r['recompiles_after_warmup']}; step eager "
            f"{r['eager_step_ms']:.1f} ms (the builds' eager calls "
            f"{[round(x, 1) for x in pr['eager_ms']]}), replayed "
            f"{[round(x, 1) for x in r['step_ms']]} ms (device "
            f"{p['device_ms']} ms, busy {p['busy_share']}); capture "
            f"{[x and round(x, 2) for x in pr['capture_s']]} s, graph nodes "
            f"{pr['graph_nodes']}; tokens/s {r['tokens_per_s']:.1f}; peak "
            f"{r['peak_mem_gib']:.2f} GiB, reserved with the pool "
            f"{pr['reserved_gib']:.2f} GiB; on {card}")


def train_loss_check(trainlib, dev, argv) -> dict:
    """:func:`train_loss_values`, held to BF16_FLOORS x its noise floor."""
    out = train_loss_values(trainlib, dev, argv)
    if not out["diff"] <= BF16_FLOORS * out["noise_floor"]:
        raise AssertionError(
            f"bf16 step-0 loss kernels vs plain differ by {out['diff']:.3e}"
            f" > {BF16_FLOORS} x the bf16 noise floor "
            f"{out['noise_floor']:.3e}")
    return out


def train_loss_values(trainlib, dev, argv) -> dict:
    """The bf16 step-0 loss, kernels (fused) against plain (fused_xla), on
    the same weights and batch (same seed: a new trainer starts where the
    main path started), and its noise floor: a null test, the plain path
    with each attention output moved by the kernel's own deviation from
    it under random signs, the largest of LOSS_NULL_DRAWS.  A deviation
    that is noise (a summation order) moves the loss like these draws; a
    biased one moves it more.  Its size is held by the kernel checks and
    the f32 gradient check.  The serve phase's floor (one f32 ulp,
    largest of three) is reported only.  The kernels and the plain path
    (its sums sorted, ``fused_flash_fwd_plain``) give the same bytes run
    after run, and the draws are seeded, so every number here is too
    (``scripts/chip_loss_floor.py`` repeats it)."""
    import torch
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    try:
        b = tr.loader.next()
        batch = trainlib.batch_arrays(b, tr.cfg, dev)
        sched = trainlib.build_schedule(tr.cfg, tr.pcfg, b.seqlens, tr.n_cp,
                                        tr.tpw, mask=tr.group_masks[0])
        params = tr.state.params
        g = torch.Generator(device=dev).manual_seed(5)
        kern_attn = trainlib.make_fcp_attn_fn(sched, dev, tr.pcfg, "fused")
        plain_attn = trainlib.make_fcp_attn_fn(sched, dev, tr.pcfg,
                                               "fused_xla")

        def loss_of(attn) -> float:
            return float(tr.model.loss(params, batch, attn))

        def flipped(q, k, v):
            o = plain_attn(q, k, v)
            sign = torch.randint(0, 2, o.shape, generator=g, device=dev)
            return o + (kern_attn(q, k, v) - o) * (2 * sign - 1).to(o.dtype)

        def nudged(q, k, v):
            o = plain_attn(q, k, v)
            sign = torch.randn(o.shape, generator=g, device=dev).sign()
            return o * (1 + 2.0 ** -23 * sign)
        with torch.no_grad():
            loss = {"fused": loss_of(kern_attn),
                    "fused_xla": loss_of(plain_attn)}
            null = [loss_of(flipped) - loss["fused_xla"]
                    for _ in range(LOSS_NULL_DRAWS)]
            ulp = [loss_of(nudged) - loss["fused_xla"] for _ in range(3)]
    finally:
        tr.close()
    del tr
    release()
    diff = abs(loss["fused"] - loss["fused_xla"])
    floor = max(abs(x) for x in null)
    return {"kernels": loss["fused"], "plain": loss["fused_xla"],
            "diff": diff, "noise_floor": floor, "null_draws": null,
            "one_ulp_floor": max(abs(x) for x in ulp), "one_ulp_draws": ulp}


def replay_vs_eager(fa, trainlib, dev, argv) -> dict:
    """The first batch's step program at ``argv`` built, then from one
    copied state (weights, AdamW moments and step) one step replayed and
    two run eagerly (``eager_step_fn``): the weights after the step,
    the loss and the gnorm.  Eager against eager is the yardstick: where
    it gives the same bytes the replay must too, else the replay must lie
    within its spread (max |a - b| / max |b| over the weights).  The
    counted launches of kernels 1-6 in the replay equal the eager step's
    and a profiled replay's kernel events (``replay_launches``)."""
    import torch
    from repro_torch.optimizer import adamw
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    try:
        b = tr.loader.next()
        batch = trainlib.batch_arrays(b, tr.cfg, dev)
        prog, eager = tr.step_fn(b, prefetch=False), tr.eager_step_fn(b)
        held = trainlib.held(tr.state)
        prog(batch, held=held)                     # the build
        st = tr.state
        leaves = adamw.tree_leaves({"p": st.params, "m": st.opt.m,
                                    "v": st.opt.v}) + [st.opt.step]
        snap = [x.detach().clone() for x in leaves]

        def step(replay: bool):
            with torch.no_grad():
                for dst, src in zip(leaves, snap):
                    dst.copy_(src)
            torch.cuda.synchronize()
            reset_counters(fa)
            loss, gnorm = prog(batch, held=held) if replay else eager(batch)
            torch.cuda.synchronize()
            return (float(loss), float(gnorm), read_counters(fa),
                    [x.detach().clone() for x in adamw.tree_leaves(
                        st.params)])
        rep_, e1, e2 = step(True), step(False), step(False)
        launches = replay_launches(fa, lambda: prog(batch, held=held))
    finally:
        tr.close()
    del tr
    release()

    def same(x, y):
        return x[:2] == y[:2] and all(torch.equal(a, c)
                                      for a, c in zip(x[3], y[3]))

    def err(x, y):
        return max(float((a.float() - c.float()).abs().max())
                   / max(float(c.float().abs().max()), 1e-30)
                   for a, c in zip(x[3], y[3]))
    out = {"bitwise_replay_vs_eager": same(rep_, e1),
           "bitwise_eager_vs_eager": same(e1, e2),
           "weights_err_replay_vs_eager": min(err(rep_, e1), err(rep_, e2)),
           "weights_err_eager_vs_eager": err(e1, e2),
           "loss": [rep_[0], e1[0], e2[0]], "gnorm": [rep_[1], e1[1], e2[1]],
           "launches_replayed": rep_[2], "launches_eager": e1[2],
           "replay_launches": launches}
    log(f"  replay vs eager {argv_tag(argv)}: bitwise "
        f"{out['bitwise_replay_vs_eager']} (eager vs eager "
        f"{out['bitwise_eager_vs_eager']}), weights "
        f"{out['weights_err_replay_vs_eager']:.3e} (eager vs eager "
        f"{out['weights_err_eager_vs_eager']:.3e}), loss {out['loss']}, "
        f"gnorm {out['gnorm']}")
    if rep_[2] != e1[2]:
        raise AssertionError(f"replayed launches {rep_[2]} != the eager "
                             f"step's {e1[2]}")
    if out["bitwise_eager_vs_eager"] and not out["bitwise_replay_vs_eager"]:
        raise AssertionError(f"the replay is not the eager step's bytes, "
                             f"eager against eager is: {out}")
    if (not out["bitwise_replay_vs_eager"]
            and out["weights_err_replay_vs_eager"]
            > out["weights_err_eager_vs_eager"]):
        raise AssertionError(f"the replay lies outside the eager-against-"
                             f"eager spread: {out}")
    return out


def warm_run(trainlib, argv, steps: int = 2) -> dict:
    """A round of the stream's compositions and ``steps`` more at
    ``argv``: nothing may be built after the round (``hold_warm``); a
    Supervisor records no health event."""
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    warm = len(tr.loader.compositions)
    try:
        tr.run(warm + steps)
    finally:
        tr.close()
    out = {"compiled_at": list(tr.compiled_at), "steps": len(tr.history),
           "recompiles_after_warmup": hold_warm(argv_tag(argv), tr, warm)}
    if isinstance(tr, trainlib.Supervisor):
        out["events"] = len(tr.monitor.events)
        if tr.monitor.events:
            raise AssertionError(f"{argv_tag(argv)}: health events "
                                 f"{tr.monitor.events} in a healthy run")
    del tr
    release()
    return out


RECOMPILE_SETTINGS = (("plain", []), ("supervisor", ["--supervised"]),
                      ("overlap", ["--overlap"]),
                      ("bf16_wire", ["--comm-dtype", "bf16"]),
                      ("int8_wire", ["--comm-dtype", "int8"]))


def train_program_checks(fa, trainlib, dev) -> dict:
    """StableLM at full width, CHECK_LAYERS deep, bf16 and f32 weights:
    replay against eager for the fused (kernels 1, 3, 4) and the pallas
    (2, 5, 6) step (``replay_vs_eager``), and zero recompiles after
    warmup in the plain loop, the Supervisor, ``--overlap`` and the bf16
    and int8 wires (bf16; the plain loop and the Supervisor also f32)."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        base = TRAIN_ARGV + ["--override", f"n_layers={CHECK_LAYERS}",
                             "--override", f"param_dtype={dtype}"]
        for impl in ("fused", "pallas"):
            out[f"replay_{impl}_{dtype}"] = replay_vs_eager(
                fa, trainlib, dev, [x if x != "fused" else impl
                                    for x in base])
        for name, flags in RECOMPILE_SETTINGS:
            if dtype == "float32" and name not in ("plain", "supervisor"):
                continue
            out[f"recompiles_{name}_{dtype}"] = warm_run(trainlib,
                                                         base + flags)
    return out


def timed(tag: str, fn):
    """``fn()``, its wall printed on a line of its own."""
    t0 = time.perf_counter()
    out = fn()
    log(f"  {tag}: {time.perf_counter() - t0:.2f}s")
    return out


def train(fa, trainlib, dev) -> dict:
    """(a) the 4-layer f32 gradient check; (b) the training CLI's main
    path (24 layers, bf16) for 3 fused steps and one profiled, one
    ``--attn-impl pallas`` step (PALLAS_WHY), and the bf16 step-0 loss
    check."""
    out = {"grad_check_4_layers_f32": timed(
        "train f32 gradient check", lambda: train_grad_check(
            trainlib, dev, TRAIN_ARGV))}
    release()
    out["program_checks"] = timed(
        "train program checks", lambda: train_program_checks(
            fa, trainlib, dev))
    out.update(timed("train fused steps", lambda: train_steps(
        fa, trainlib, dev, TRAIN_ARGV, 3)))
    out["pallas_step"] = timed("train pallas step", lambda: train_pallas(
        fa, trainlib, dev, TRAIN_ARGV))
    out["pallas_step"]["steps_cut"] = PALLAS_WHY
    out["bf16_step0_loss"] = timed("train bf16 loss check",
                                   lambda: train_loss_check(
                                       trainlib, dev, TRAIN_ARGV))
    out["bf16_step0_loss"]["main_path_step0"] = out["losses"][0]
    log(f"train bf16 step-0 loss: {json.dumps(out['bf16_step0_loss'])}")
    return out


def model_argv(arch: str, n_layers: int | None, steps: int) -> list:
    """The train CLI's main-path arguments for ``arch`` (its depth cut to
    ``n_layers`` when given)."""
    argv = [x for x in TRAIN_ARGV]
    argv[argv.index("--arch") + 1] = arch
    argv[argv.index("--steps") + 1] = str(steps)
    if n_layers is not None:
        argv += ["--override", f"n_layers={n_layers}"]
    return argv


def train_model(fa, trainlib, dev, arch: str, steps: int,
                n_layers: int | None, why: str) -> dict:
    """A model on the training CLI's main path at full width and
    ``n_layers`` deep (None: the config's own depth): ``steps`` fused
    steps (one more profiled), one ``--attn-impl pallas`` step, and the
    bf16 step-0 loss check."""
    argv = model_argv(arch, n_layers, steps)
    out = timed(f"{arch} fused steps", lambda: train_steps(
        fa, trainlib, dev, argv, steps))
    out["depth"] = {"n_layers": out["n_layers"], "why": why}
    out["pallas_step"] = timed(f"{arch} pallas step", lambda: train_pallas(
        fa, trainlib, dev, argv))
    out["bf16_step0_loss"] = timed(f"{arch} bf16 loss check",
                                   lambda: train_loss_check(
                                       trainlib, dev, argv))
    out["bf16_step0_loss"]["main_path_step0"] = out["losses"][0]
    return out


def moe_breakdown(dev, arch: str, n_layers: int) -> dict:
    """Where an MoE layer's time goes at the training step's shapes (4
    frames of 2048 tokens, bf16, full width), as device time under the
    profiler (``device_ms``): ``moe_ffn`` forward and forward + backward,
    and its expert products alone (the three batched products and the
    SiLU on a buffer of the same shape); the dispatch (routing, sort,
    gathers and scatters, the weighted sum) is the difference.  Per step,
    a layer runs its forward twice (remat) and its backward once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(9)
    lp = moe.init_moe_ffn(cfg.replace(n_layers=1), g, dev)
    lp = {k: v[0].detach().requires_grad_(True) for k, v in lp.items()}
    x = (torch.randn((4, 2048, cfg.d_model), generator=g, device=dev)
         .bfloat16().requires_grad_(True))
    cot = torch.randn(x.shape, generator=g, device=dev).bfloat16()
    ep, cap = lp["router"].shape[-1], moe.capacity(2048, cfg)
    buf = (torch.randn((ep, 4 * cap, cfg.d_model), generator=g, device=dev)
           .bfloat16().requires_grad_(True))
    ws = [lp[n] for n in ("we_i", "we_g", "we_down")]

    def experts():
        h, gt = torch.bmm(buf, ws[0]), torch.bmm(buf, ws[1])
        return torch.bmm(F.silu(gt) * h, ws[2])
    bcot = torch.randn((ep, 4 * cap, cfg.d_model), generator=g,
                       device=dev).bfloat16()
    with torch.no_grad():
        moe_f, _ = device_ms(lambda: moe.moe_ffn(x, lp, cfg), n=5)
        exp_f, _ = device_ms(experts, n=5)
    moe_fb, _ = device_ms(lambda: torch.autograd.grad(
        moe.moe_ffn(x, lp, cfg), [x, *lp.values()], cot), n=5)
    exp_fb, _ = device_ms(lambda: torch.autograd.grad(
        experts(), [buf, *ws], bcot), n=5)
    per_step = {k: n_layers * (f + fb) for k, f, fb in (
        ("moe_ms", moe_f, moe_fb), ("experts_ms", exp_f, exp_fb))}
    per_step["dispatch_ms"] = per_step["moe_ms"] - per_step["experts_ms"]
    # the dispatch is deterministic: a second forward and backward give
    # the same bytes
    runs = []
    for _ in range(2):
        y = moe.moe_ffn(x, lp, cfg)
        runs.append([y.detach(), *torch.autograd.grad(
            y, [x, *lp.values()], cot)])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{arch} moe_ffn: a second forward and "
                             f"backward gave other bytes")
    return {"layer_ms": {"moe_fwd": moe_f, "moe_fwd_bwd": moe_fb,
                         "experts_fwd": exp_f, "experts_fwd_bwd": exp_fb},
            "per_step_ms": per_step, "capacity": cap, "experts": ep}


def ssm_breakdown(dev, arch: str, n_layers: int, prefill_bucket: int
                  ) -> dict:
    """Where a Mamba2 layer's time goes, as device time under the
    profiler (``device_ms``), at the training step's shapes (the
    8192-token stream scanned as one sequence, 4 documents of 2048, bf16,
    full width): one ``mamba_block`` forward and forward + backward, and
    its ``ssd_scan`` alone (f32, as the block calls it); and the forward
    of both at a prefill batch's shape (``8192 / prefill_bucket``
    sequences of ``prefill_bucket`` tokens).  Per step, a layer runs its
    forward twice (remat) and its backward once."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(10)
    lp = {k: v[0].detach().requires_grad_(True) for k, v in
          ssm.init_mamba_layers(cfg, g, 1, dev).items()}
    _, _, nh, din = ssm.ssm_dims(cfg)
    hd, ds = din // nh, cfg.ssm_state

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    out = {}
    for tag, bt, s in (("train", 1, 8192),
                       ("prefill", 8192 // prefill_bucket, prefill_bucket)):
        x = rnd(bt, s, cfg.d_model, dtype=torch.bfloat16).requires_grad_(True)
        pos = (torch.arange(s, device=dev) % 2048).int().expand(bt, s)
        ins = [rnd(bt, s, nh, hd), -torch.rand((bt, s, nh), generator=g,
                                               device=dev),
               rnd(bt, s, ds), rnd(bt, s, ds)]
        with torch.no_grad():
            blk_f, _ = device_ms(lambda: ssm.mamba_block(x, lp, cfg, pos),
                                 n=3)
            ssd_f, _ = device_ms(lambda: ssm.ssd_scan(*ins, cfg.ssm_chunk),
                                 n=3)
        out[tag] = {"mamba_block_fwd": blk_f, "ssd_scan_fwd": ssd_f}
        if tag == "train":
            cot = torch.randn(x.shape, generator=g, device=dev).bfloat16()
            leaves = [x, *lp.values()]
            out[tag]["mamba_block_fwd_bwd"], _ = device_ms(
                lambda: torch.autograd.grad(ssm.mamba_block(x, lp, cfg, pos),
                                            leaves, cot), n=3)
            sins = [t.requires_grad_(True) for t in ins]
            out[tag]["ssd_scan_fwd_bwd"], _ = device_ms(
                lambda: torch.autograd.grad(
                    ssm.ssd_scan(*sins, cfg.ssm_chunk)[0].sum(), sins), n=3)
        del x, ins
        release()
    t = out["train"]
    out["train_per_step_ms"] = {
        k: n_layers * (t[f"{k}_fwd"] + t[f"{k}_fwd_bwd"])
        for k in ("mamba_block", "ssd_scan")}
    out["prefill_per_batch_ms"] = {
        k: n_layers * out["prefill"][f"{k}_fwd"]
        for k in ("mamba_block", "ssd_scan")}
    return out


# --------------------------------------------------------------------------
# phase 5: the rest of the training path (overlap, layer pipeline,
# Supervisor, checkpoints)
# --------------------------------------------------------------------------

DKDV_TOL = 1e-6             # overlap on vs off: dk/dv, normalized (the
                            # reference's run_overlap_executor.py)
TOL_OVERLAP_LEAF = 1e-5     # overlap on vs off: weight gradients, which
                            # sum dk/dv's association-order drift
TOL_PIPELINE = 1e-6         # layer pipeline vs not: loss and every leaf
CHECK_LAYERS = 4            # the overlap and layer-pipeline f32 checks
DRILL_LAYERS = 1            # the kill, straggler and pod drills
DRILL_TOTAL, DRILL_EVERY = 5, 2
DRILL_FAIL_STEP, DRILL_FAIL_WORKER, DRILL_FAIL_ROUND = 3, 1, 2
STRAGGLER_TOTAL, STRAGGLER_WINDOW, STRAGGLER_COOLDOWN = 12, 3, 4
DRILL_WHY = ("depth and steps cut for the run's time: a drill's time is "
             "its checkpoint saves (7.40 GB at 4 layers, about 12 s each "
             "on an H100 80GB HBM3 host; 5.5 GB at 1 layer, the embedding "
             "and head f32 with their AdamW moments) and its f32 steps; "
             "the worker dies mid-step after one committed checkpoint, as "
             "at step 7 of 8, and the limits are the reference runner's")
SUPERVISOR_STEPS = 6        # the CLI's default: a round of 4 and 2 replays
ROUND_TRIP_LAYERS = 4       # of 24: the checkpoint round trip's state
ROUND_TRIP_WHY = ("depth cut for the run's time (the full 16.44 GB state "
                  "saved in 23.4 s and restored in 11.0 s on an H100 80GB "
                  "HBM3 host): the first 4 layers of every stacked layer "
                  "leaf, the embedding, head and norm whole, params and "
                  "both AdamW moments")
BUILD = os.path.join(ROOT, "build")
PATH_KERNELS = {"fused": ("fused_flash_fwd", "fused_flash_bwd_dq",
                          "fused_flash_bwd_dkv"),
                "pallas": ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")}
# ship and copy kernels: the stacked-worker wire is gathers, cats, fills
# and index copies
SHIP_NAMES = ("memcpy", "copy", "index", "cat", "fill", "memset", "where",
              "gather", "scatter")


def _nerr(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def stream_profile(fn, tries: int = 1) -> dict:
    """One call of ``fn`` (after an untimed one) under ``torch.profiler``
    (device activity only), its trace read per CUDA stream: the main
    stream is the one the attention kernels run on, every other one is a
    side stream.  Counts the ship and copy kernels on each, and the share
    of side-stream time that overlaps a main-stream kernel.  A trace with
    no device activity (see ``device_ms``) is taken again, up to
    ``tries`` calls, where a second call of ``fn`` runs the same work."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    path = os.path.join(BUILD, "stream_trace.json")
    os.makedirs(BUILD, exist_ok=True)
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        streams: dict = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in (
                    "kernel", "gpu_memcpy", "gpu_memset"):
                continue
            sid = e.get("args", {}).get("stream", e.get("tid"))
            a = float(e["ts"])
            streams.setdefault(sid, []).append((a, a + float(e["dur"]),
                                                e["name"]))
        if streams:
            break
    if not streams:
        raise AssertionError("the profiler recorded no device activity")

    def n_attn(evs):
        return sum(1 for *_, n in evs if any(k in n for k in ATTN_KERNELS))

    def busy(evs):
        return sum(b - a for a, b, _ in evs)
    main = max(streams, key=lambda s: (n_attn(streams[s]),
                                       busy(streams[s])))
    union: list = []                       # main-stream busy intervals
    for a, b, _ in sorted(streams[main]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]

    def covered(a, b) -> float:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        got = 0.0
        while i < len(union) and union[i][0] < b:
            got += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
        return got

    def ships(evs):
        return [x for x in evs if any(k in x[2].lower() for k in SHIP_NAMES)]
    side = [x for s, evs in streams.items() if s != main for x in evs]
    side_us = busy(side)
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(busy(v) for v in streams.values()) / 1e3,
            "streams": len(streams),
            "side_kernels": len(side), "side_ship_kernels": len(ships(side)),
            "side_ms": side_us / 1e3,
            "main_ship_kernels": len(ships(streams[main])),
            "main_ship_ms": busy(ships(streams[main])) / 1e3,
            "side_overlapped_share": (sum(covered(a, b) for a, b, _ in side)
                                      / side_us if side_us else None)}


def overlap_and_pipeline_checks(fa, ex, trainlib, dev) -> dict:
    """Full width, 4 layers, f32 weights, the first batch of the CLI's
    stream (plain loop):

    * the executor at StableLM's shapes (q/k/v f32, seed 0), the batch's
      plan with overlap on and off, fused (kernels 1, 3, 4) and pallas
      (2, 5, 6): o and dq bitwise, dk/dv within DKDV_TOL;
    * one FCP prefill batch of the serving loop (2 prompts in the 4096
      bucket, so KV ships), overlap on and off: logits bitwise;
    * one fused train step's loss and gradients, overlap on and off: the
      loss bitwise, every leaf within TOL_OVERLAP_LEAF;
    * the same with the layer pipeline on and off: the loss and every
      leaf within TOL_PIPELINE."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.optimizer import adamw
    from repro_torch.runtime.serving import ServingLoop
    tr = trainlib.trainer_from_args(trainlib.parse_args(
        TRAIN_ARGV + ["--override", f"n_layers={CHECK_LAYERS}",
                      "--override", "param_dtype=float32"]))
    out: dict = {}
    try:
        b = tr.loader.next()
        batch = trainlib.batch_arrays(b, tr.cfg, dev)
        mask = tr.group_masks[0]
        pcfgs = {ov: dataclasses.replace(tr.pcfg, overlap=ov)
                 for ov in (False, True)}
        scheds = {ov: trainlib.build_schedule(
            tr.cfg, pcfgs[ov], b.seqlens, tr.n_cp, tr.tpw, mask=mask)
            for ov in (False, True)}
        if not scheds[True].spec.n_rounds:
            raise AssertionError("the overlap plan ships nothing")
        out["plan"] = {"rounds": scheds[True].spec.n_rounds,
                       "ext_slots": {str(ov): scheds[ov].spec.ext_slots
                                     for ov in scheds}}

        # the executor
        c = tr.cfg
        g = torch.Generator(device=dev).manual_seed(0)
        shape = (tr.n_cp, tr.tpw)
        q = torch.randn(*shape, c.n_heads, c.head_dim, generator=g,
                        device=dev)
        k, v = (torch.randn(*shape, c.n_kv_heads, c.head_dim, generator=g,
                            device=dev) for _ in range(2))
        cot = torch.randn(q.shape, generator=g, device=dev)
        for impl in ("fused", "pallas"):
            res = {}
            for ov in (False, True):
                xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
                reset_counters(fa)
                o = ex.fcp_attention(*xs, ex.schedule_tables(scheds[ov], dev),
                                     spec=scheds[ov].spec,
                                     cfg=ex.ExecConfig(impl=impl))
                grads = torch.autograd.grad((o * cot).sum(), xs)
                torch.cuda.synchronize()
                res[ov] = (o.detach(), grads, read_counters(fa))
            (o0, g0, _), (o1, g1, n1) = res[False], res[True]
            errs = [_nerr(a, b_) for a, b_ in zip(g1[1:], g0[1:])]
            launched = {n: n1[n] for n in PATH_KERNELS[impl]}
            if not (torch.equal(o0, o1) and torch.equal(g0[0], g1[0])
                    and max(errs) <= DKDV_TOL and min(launched.values())):
                raise AssertionError(
                    f"overlap executor ({impl}): o bitwise "
                    f"{torch.equal(o0, o1)}, dq bitwise "
                    f"{torch.equal(g0[0], g1[0])}, dk/dv {errs} (tol "
                    f"{DKDV_TOL}), launches {n1}")
            out[f"executor_{impl}"] = {"o_bitwise": True, "dq_bitwise": True,
                                       "dkdv_err": errs, "launches": launched}
            del res, o0, o1, g0, g1

        # the backward's ships run on their forward ops' side stream: a
        # forward and backward puts more ship kernels there than the
        # forward alone
        tabs, spec = ex.schedule_tables(scheds[True], dev), scheds[True].spec

        def fwd():
            with torch.no_grad():
                ex.fcp_attention(q, k, v, tabs, spec=spec)

        def fwd_bwd():
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = ex.fcp_attention(*xs, tabs, spec=spec)
            torch.autograd.grad((o * cot).sum(), xs)
        sides = {tag: stream_profile(fn, tries=3) for tag, fn in (
            ("forward", fwd), ("fwd_bwd", fwd_bwd))}
        if not (0 < sides["forward"]["side_ship_kernels"]
                < sides["fwd_bwd"]["side_ship_kernels"]):
            raise AssertionError(f"side-stream ship kernels: forward "
                                 f"{sides['forward']}, with backward "
                                 f"{sides['fwd_bwd']}")
        out["executor_side_stream"] = sides

        # one prefill batch of the serving loop
        scfg = ServeConfig(cache_len=4096, decode_slots=8, queue_depth=64,
                           max_new_tokens=2, prefill_tokens_per_worker=2048,
                           bucket_min=64)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, c.vocab_size, (L,)).astype(np.int32)
                   for L in (3500, 3900)]
        logits = {}
        with torch.no_grad():
            for ov in (False, True):
                loop = ServingLoop(
                    tr.model, tr.state.params, StackedMesh((4, 2)),
                    ParallelConfig(block_size=512, in_dtype_bytes=4,
                                   overlap=ov), scfg, device=dev)
                reqs = [loop.submit(p, max_new=2) for p in prompts]
                E = reqs[0].bucket
                pb, last = loop.assemble(E, reqs)
                spec = loop._schedule_for(E).spec
                reset_counters(fa)
                logits[ov] = loop.prefill_fn(E)(tr.state.params, pb,
                                                last)[0]
                torch.cuda.synchronize()
                n = read_counters(fa)["fused_flash_fwd"]
                del loop
        if not (spec.overlap and spec.n_rounds and n > 0
                and torch.equal(logits[False], logits[True])):
            raise AssertionError(
                f"prefill batch overlap on vs off: bitwise "
                f"{torch.equal(logits[False], logits[True])} (max diff "
                f"{float((logits[False] - logits[True]).abs().max()):.3e}), "
                f"rounds {spec.n_rounds}, kernel 1 launches {n}")
        out["prefill_batch"] = {"bucket": E, "rounds": spec.n_rounds,
                                "logits_bitwise": True,
                                "fused_flash_fwd_launches": n}
        del logits

        # the train step: overlap, then the layer pipeline
        def step(pcfg, sched):
            attn = trainlib.attention_closures(
                tr.cfg, pcfg, tr.layer_masks, tr.group_masks,
                {mask: sched}, dev, "fused")
            loss, grads = trainlib.value_and_grad(tr.model, pcfg, attn)(
                tr.state.params, batch)
            return loss, adamw.tree_leaves(grads)
        l0, g0 = step(pcfgs[False], scheds[False])
        l1, g1 = step(pcfgs[True], scheds[True])
        err = max(_nerr(a, b_) for a, b_ in zip(g1, g0))
        if not (torch.equal(l0, l1) and err <= TOL_OVERLAP_LEAF):
            raise AssertionError(
                f"train step overlap on vs off: loss {float(l1)} vs "
                f"{float(l0)}, max leaf err {err:.3e} (tol "
                f"{TOL_OVERLAP_LEAF})")
        out["train_step_overlap"] = {"loss_bitwise": True,
                                     "max_leaf_err": err, "loss": float(l0)}
        del g1
        lp = dataclasses.replace(tr.pcfg, layer_pipeline=True)
        l2, g2 = step(lp, scheds[False])
        err = max(_nerr(a, b_) for a, b_ in zip(g2, g0))
        lerr = abs(float(l2) / float(l0) - 1)
        if not (lerr <= TOL_PIPELINE and err <= TOL_PIPELINE):
            raise AssertionError(
                f"train step layer pipeline vs not: loss err {lerr:.3e}, "
                f"max leaf err {err:.3e} (tol {TOL_PIPELINE})")
        out["train_step_layer_pipeline"] = {"loss_err": lerr,
                                            "max_leaf_err": err}
        del g0, g2
    finally:
        tr.close()
    del tr
    release()
    return out


def overlap_step(fa, trainlib, dev, argv) -> dict:
    """A full-depth bf16 fused step of the plain loop with ``argv``'s
    flags: the second step (a build: its eager call, then its capture)
    under ``stream_profile``, whose eager kernels show the streams they
    ran on (a replay's kernels trace on the stream that launched the
    graph); the rest of the round, two replayed steps with the counters
    read around them and one more profiled; nothing built after the
    round."""
    import torch
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm = len(tr.loader.compositions)
        prof = stream_profile(tr.step)
        tr.run(warm)
        reset_counters(fa)
        hist = tr.run(warm + 2)
        launches = read_counters(fa)
        peak = torch.cuda.max_memory_allocated() / 2**30
        replayed = profile(tr.step, 1)
        recompiles = hold_warm(argv_tag(argv), tr, warm)
        programs = step_programs(tr)
        losses = [r.loss for r in tr.history]
        tokens = tr.pods * tr.n_cp * tr.tpw
    finally:
        tr.close()
    del tr
    release()
    for name in ("fused_flash_fwd", "fused_flash_bwd_dq",
                 "fused_flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched ({argv[-1]})")
    if not all(np.isfinite(losses)):
        raise AssertionError("overlap train losses not finite")
    out = {"step_ms": [r.ms for r in hist], "losses": losses,
           "launches": launches, "peak_mem_gib": peak, "profile": prof,
           "profile_step": replayed, "recompiles_after_warmup": recompiles,
           "programs": programs,
           "eager_step_ms": float(np.median(programs["eager_ms"])),
           "tokens_per_s": tokens / (float(np.mean(
               [r.ms for r in hist])) / 1e3)}
    log(programs_train_line(argv_tag(argv), out, card_line()))
    return out


def overlap_phase(fa, ex, trainlib, dev) -> dict:
    out = timed("overlap checks", lambda: overlap_and_pipeline_checks(
        fa, ex, trainlib, dev))
    log(f"  overlap / layer-pipeline checks: {json.dumps(out)}")
    out["step_serial"] = timed("overlap serial steps", lambda: overlap_step(
        fa, trainlib, dev, TRAIN_ARGV))
    out["step_overlap"] = timed("overlap steps", lambda: overlap_step(
        fa, trainlib, dev, TRAIN_ARGV + ["--overlap"]))
    for tag in ("step_serial", "step_overlap"):
        p = out[tag]["profile"]
        log(f"  {tag}: a build's eager call: device {p['device_ms']:.1f} ms "
            f"in a {p['wall_ms']:.1f} ms window (with the capture); "
            f"ship/copy kernels: side stream "
            f"{p['side_ship_kernels']} (of {p['side_kernels']}, "
            f"{p['side_ms']:.1f} ms), main stream {p['main_ship_kernels']} "
            f"({p['main_ship_ms']:.1f} ms); side time under a main-stream "
            f"kernel {p['side_overlapped_share']}")
    if out["step_overlap"]["profile"]["side_ship_kernels"] <= 0:
        raise AssertionError("no ship kernel ran on a side stream under "
                             "--overlap")
    return out


def layer_pipeline_phase(fa, trainlib, dev) -> dict:
    """Three full-depth bf16 fused steps with ``--layer-pipeline``, then
    with ``--layer-pipeline --overlap`` (each one more profiled)."""
    return {"layer_pipeline": train_steps(
                fa, trainlib, dev, TRAIN_ARGV + ["--layer-pipeline"], 3),
            "layer_pipeline_overlap": train_steps(
                fa, trainlib, dev,
                TRAIN_ARGV + ["--layer-pipeline", "--overlap"], 3)}


def supervisor_phase(fa, trainlib, dev) -> dict:
    """StableLM at full width, DRILL_LAYERS deep, f32, 4 stacked workers,
    the CLI's plan settings: the kill drill (worker 1 dies mid-step at
    step DRILL_FAIL_STEP of DRILL_TOTAL, checkpoints every 2 steps under
    build/) and the straggler drill (worker 3 2x slow); then the CLI's
    default command (the Supervisor) for 3 full-depth bf16 steps with the
    counters read around them, and a checkpoint round trip of its params
    and AdamW state (ROUND_TRIP_LAYERS of them)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                          get_config)
    from repro_torch.launch import drills
    from repro_torch.optimizer import adamw
    root = os.path.join(BUILD, "supervisor")
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("stablelm_1_6b").replace(n_layers=DRILL_LAYERS,
                                              param_dtype="float32")

    def factory(**pkw):
        pcfg = ParallelConfig(block_size=512, in_dtype_bytes=4,
                              checkpoint_every=DRILL_EVERY, **pkw)

        def make(ckpt_dir, **kw):
            tcfg = TrainConfig(lr=3e-4, warmup_steps=2,
                               total_steps=DRILL_TOTAL)
            return trainlib.Supervisor(
                cfg, pcfg, tcfg, n_workers=4, tokens_per_worker=2048,
                dist="real_world", checkpoint_dir=ckpt_dir,
                checkpoint_keep=3, verbose=False, device=dev,
                attn_impl="fused", **kw)
        return make
    out: dict = {"drill_depth": f"{DRILL_LAYERS} layer(s), {DRILL_TOTAL} "
                                f"steps: {DRILL_WHY}"}
    t0 = time.perf_counter()
    out["kill_drill"] = drills.kill_drill(
        factory(), root, total=DRILL_TOTAL, fail_step=DRILL_FAIL_STEP,
        fail_worker=DRILL_FAIL_WORKER, fail_round=DRILL_FAIL_ROUND,
        every=DRILL_EVERY)
    out["kill_drill"]["seconds"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    release()
    t0 = time.perf_counter()
    out["straggler_drill"] = drills.straggler_drill(
        factory(health_window=STRAGGLER_WINDOW,
                demote_cooldown=STRAGGLER_COOLDOWN),
        total=STRAGGLER_TOTAL, window=STRAGGLER_WINDOW,
        cooldown=STRAGGLER_COOLDOWN)
    out["straggler_drill"]["seconds"] = time.perf_counter() - t0
    release()
    log(f"  drills: {json.dumps(out)}")

    # the CLI's default command: the Supervisor, one round of the stream
    # and two replayed steps
    t_cli = time.perf_counter()
    argv = [x for x in TRAIN_ARGV if x != "--no-supervised"]
    argv[argv.index("--steps") + 1] = str(SUPERVISOR_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(fa)
    sup = trainlib.main(argv)
    launches = read_counters(fa)
    if not isinstance(sup, trainlib.Supervisor):
        raise AssertionError(f"the CLI's default ran {type(sup).__name__}")
    for name in ("fused_flash_fwd", "fused_flash_bwd_dq",
                 "fused_flash_bwd_dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched under the "
                                 f"Supervisor")
    warm = len(sup.loader.compositions)
    out["cli_default"] = {
        "step_ms": [r.ms for r in sup.history],
        "losses": [r.loss for r in sup.history], "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "recompiles_after_warmup": hold_warm("supervisor", sup, warm),
        "programs": step_programs(sup),
        "summary": {k: v for k, v in sup.summary().items()
                    if k in ("steps", "n_workers", "compiles", "events")}}
    if not all(np.isfinite(out["cli_default"]["losses"])):
        raise AssertionError("Supervisor losses not finite")
    if sup.monitor.events:
        raise AssertionError(f"the healthy Supervisor run recorded "
                             f"{sup.monitor.events} (a build step's wall "
                             f"demoted a worker?)")
    log(f"  supervisor CLI default steps: {time.perf_counter() - t_cli:.2f}s")

    # a checkpoint round trip of the full-width bf16 params + AdamW state,
    # its depth cut to ROUND_TRIP_LAYERS (the stacked layer leaves' first
    # rows)
    def cut(t):
        return {k: ({n: w[:ROUND_TRIP_LAYERS] for n, w in v.items()}
                    if k == "layers" else v) for k, v in t.items()}
    opt = sup.state.opt
    tree = {"params": cut(sup.state.params),
            "opt": dataclasses.replace(opt, m=cut(opt.m), v=cut(opt.v))}
    path = os.path.join(root, "round_trip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpointer.save(path, tree, extra={"step": 2})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpointer.restore(path, tree)
    restore_s = time.perf_counter() - t0
    leaves, got = adamw.tree_leaves(tree["params"]), adamw.tree_leaves(
        back["params"])
    for name in ("m", "v"):
        leaves += adamw.tree_leaves(getattr(tree["opt"], name))
        got += adamw.tree_leaves(getattr(back["opt"], name))
    leaves.append(tree["opt"].step)
    got.append(back["opt"].step)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    same = all(a.dtype == b.dtype and torch.equal(a.detach().cpu(), b)
               for a, b in zip(leaves, got))
    shutil.rmtree(root, ignore_errors=True)
    if not same:
        raise AssertionError("checkpoint round trip changed a byte")
    out["checkpoint_round_trip"] = {
        "bytes": nbytes, "leaves": len(leaves), "save_s": save_s,
        "restore_s": restore_s, "bytes_equal": True,
        "depth": f"{ROUND_TRIP_LAYERS} of {sup.cfg.n_layers} layers: "
                 f"{ROUND_TRIP_WHY}"}
    del sup, tree, back, leaves, got
    release()
    return out


# --------------------------------------------------------------------------
# phase 6: pod meshes (the pod train step, the pod drill, pod-mesh serving)
# --------------------------------------------------------------------------

# 2 pods of cell 2's geometry: 16,384 tokens a step
POD_ARGV = ["--arch", "stablelm_1_6b", "--mesh", "2x4x1", "--dist",
            "real_world", "--block-size", "512", "--tokens-per-worker",
            "2048", "--attn-impl", "fused", "--steps", "3",
            "--no-supervised"]
POD_LAYOUT_TOL = 1e-6       # 2-pod loss vs the mean of the one-pod losses
POD_DRILL_TOTAL, POD_DRILL_EVERY = 7, 2    # DRILL_WHY: steps cut from 12
POD_FAIL_STEP, POD_FAIL_ROUND, POD_REJOIN = 3, 1, 5     # from 5, 1, 9
POD_CHECK_REQUESTS = 4      # the f32 dispatch check's stream, from 8
POD_SERVE_REQUESTS = 8      # full depth, bf16, on the 2x2x2 mesh
POD_SERVE_WHY = ("requests cut from 16 for the run's time: the dense "
                 "prefill of a pod mesh takes 1.47 s a batch at full depth")


def pod_checks(trainlib, dev) -> dict:
    """The pod step at full width, 4 layers, f32, the CLI's first batch:
    the loss and every parameter's gradient through the kernels (fused:
    1, 3, 4) against the plain versions (fused_xla) to TOL_TRAIN_F32;
    then the layout: the 2-pod loss against the mean of the two one-pod
    losses on the same frames (each pod holds the same composition) to
    POD_LAYOUT_TOL."""
    import torch
    from repro_torch.optimizer import adamw
    tr = trainlib.trainer_from_args(trainlib.parse_args(
        POD_ARGV + ["--override", "n_layers=4",
                    "--override", "param_dtype=float32"]))
    try:
        b = tr.loader.next()
        batch = trainlib.batch_arrays(b, tr.cfg, dev)
        sched = trainlib.build_schedule(tr.cfg, tr.pcfg, b.seqlens, tr.n_cp,
                                        tr.tpw, mask=tr.group_masks[0])
        params = tr.state.params
        res = {}
        for impl in ("fused_xla", "fused"):
            attn = trainlib.make_fcp_attn_fn(sched, dev, tr.pcfg, impl,
                                             tr.pods)
            loss, g = trainlib.value_and_grad(tr.model, tr.pcfg, attn)(
                params, batch)
            res[impl] = (float(loss), adamw.tree_leaves(g))
        errs = [float((a - b_).abs().max()) / max(float(b_.abs().max()),
                                                  1e-30)
                for a, b_ in zip(res["fused"][1], res["fused_xla"][1])]
        finite = all(bool(torch.isfinite(x).all()) for x in res["fused"][1])
        out = {"loss": res["fused"][0], "loss_plain": res["fused_xla"][0],
               "loss_rel_err": abs(res["fused"][0] / res["fused_xla"][0]
                                   - 1),
               "max_leaf_err": max(errs)}
        del res
        if not (out["max_leaf_err"] <= TOL_TRAIN_F32 and finite
                and out["loss_rel_err"] <= TOL_GRAD):
            raise AssertionError(f"pod step kernels vs plain (f32, 4 "
                                 f"layers): {out}")
        n = tr.n_cp
        with torch.no_grad():
            pod = float(tr.model.loss(params, batch, trainlib.make_fcp_attn_fn(
                sched, dev, tr.pcfg, "fused", tr.pods)))
            one = trainlib.make_fcp_attn_fn(sched, dev, tr.pcfg, "fused")
            each = [float(tr.model.loss(
                params, {k: v[p * n:(p + 1) * n] for k, v in batch.items()},
                one)) for p in range(tr.pods)]
        out.update(pod_loss=pod, one_pod_losses=each,
                   layout_rel_err=abs(pod / float(np.mean(each)) - 1))
        if not out["layout_rel_err"] <= POD_LAYOUT_TOL:
            raise AssertionError(
                f"2-pod loss {pod} vs the one-pod losses' mean "
                f"{np.mean(each)}: {out['layout_rel_err']:.3e} > "
                f"{POD_LAYOUT_TOL}")
        return out
    finally:
        tr.close()


def pod_train_phase(fa, trainlib, dev) -> dict:
    """(a) the 4-layer f32 checks; the pod step at full depth, bf16 (3
    fused steps with the counters read around them, one profiled); one
    ``--attn-impl pallas`` pod step at 4 layers with its counters."""
    out = {"checks_4_layers_f32": timed("pod checks", lambda: pod_checks(
        trainlib, dev))}
    release()
    log(f"  pod checks (4 layers, f32): {json.dumps(out)}")
    out.update(timed("pod fused steps", lambda: train_steps(
        fa, trainlib, dev, POD_ARGV, 3)))
    out["pallas_step_4_layers"] = timed(
        "pod pallas step", lambda: train_pallas(
            fa, trainlib, dev, POD_ARGV + ["--override", "n_layers=4"]))
    return out


def pod_drill_phase(fa, trainlib, dev) -> dict:
    """(b) the pod drill (``launch/drills.pod_drill``): StableLM at full
    width, DRILL_LAYERS deep, f32, 2 pods x 2 workers of 2048 tokens,
    block 512, error-feedback compression on; pod 1 dies at step
    POD_FAIL_STEP (round 1) and rejoins at step POD_REJOIN of
    POD_DRILL_TOTAL, checkpoints every 2 steps under build/."""
    import shutil
    from repro_torch.configs.base import (ParallelConfig, TrainConfig,
                                          get_config)
    from repro_torch.launch import drills
    root = os.path.join(BUILD, "pods")
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("stablelm_1_6b").replace(n_layers=DRILL_LAYERS,
                                              param_dtype="float32")
    pcfg = ParallelConfig(block_size=512, in_dtype_bytes=4,
                          checkpoint_every=POD_DRILL_EVERY)

    def make(ckpt_dir, **kw):
        tcfg = TrainConfig(lr=1e-3, warmup_steps=2,
                           total_steps=POD_DRILL_TOTAL,
                           grad_compression=True)
        return trainlib.Supervisor(
            cfg, pcfg, tcfg, n_workers=2, tokens_per_worker=2048, pods=2,
            dist="real_world", checkpoint_dir=ckpt_dir, verbose=False,
            device=dev, attn_impl="fused", **kw)
    t0 = time.perf_counter()
    reset_counters(fa)
    try:
        out = drills.pod_drill(make, root, total=POD_DRILL_TOTAL,
                               fail_step=POD_FAIL_STEP,
                               fail_round=POD_FAIL_ROUND,
                               rejoin_step=POD_REJOIN, every=POD_DRILL_EVERY)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = read_counters(fa)
    out["seconds"] = time.perf_counter() - t0
    out["depth"] = (f"{DRILL_LAYERS} layer(s), {POD_DRILL_TOTAL} steps: "
                    f"{DRILL_WHY}")
    for name in PATH_KERNELS["fused"]:
        if out["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in the pod drill")
    release()
    return out


def pod_serve_phase(fa, dev) -> dict:
    """(c) StableLM at full width on a 2x2x2 pod mesh.  With f32 weights
    at 4 layers, 8 requests: FCP prefill warns and serves densely, its
    tokens those of a 4x2 FCP loop on the same prompts, and
    ``strict_prefill`` raises.  Then full depth, bf16, POD_SERVE_REQUESTS
    requests in cell 1's setting: the prefill that served, prefill p50,
    the decode step's wall and profile, with the counters read around the
    run."""
    import warnings
    import torch
    from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                          get_config)
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import Model
    from repro_torch.runtime.serving import ServingLoop
    scfg = ServeConfig(cache_len=4096, decode_slots=8, queue_depth=64,
                       max_new_tokens=32, prefill_tokens_per_worker=2048,
                       bucket_min=64)

    def build(model, params, mesh, pcfg, sc):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loop = ServingLoop(model, params, mesh, pcfg, sc, device=dev)
        return loop, any("pod meshes" in str(w.message) for w in caught)

    def prompts(vocab, n):
        rng = np.random.default_rng(0)
        return [rng.integers(1, vocab, (int(L),)).astype(np.int32)
                for L in rng.integers(64, 2049, n)]
    out: dict = {}
    cfg = get_config("stablelm_1_6b").replace(n_layers=4,
                                              param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    pcfg = ParallelConfig(block_size=512, in_dtype_bytes=4)
    ps, toks = prompts(cfg.vocab_size, POD_CHECK_REQUESTS), {}
    for tag, shape in (("fcp_4x2", (4, 2)), ("pod_2x2x2", (2, 2, 2))):
        loop, warned = build(model, params, StackedMesh(shape), pcfg, scfg)
        reset_counters(fa)
        rep = loop.run(ps, max_new=scfg.max_new_tokens)
        toks[tag] = {r.rid: r.tokens.tolist() for r in loop.stats.finished}
        out[tag] = {"prefill_impl": rep["prefill_impl"], "warned": warned,
                    "requests": rep["requests"],
                    "launches": read_counters(fa)}
        del loop
    release()
    if not (out["fcp_4x2"]["prefill_impl"] == "fcp"
            and not out["fcp_4x2"]["warned"]
            and out["pod_2x2x2"]["prefill_impl"] == "dense"
            and out["pod_2x2x2"]["warned"]):
        raise AssertionError(f"pod-mesh prefill dispatch: {out}")
    if out["pod_2x2x2"]["launches"]["fused_flash_fwd"] != 0 or \
            out["pod_2x2x2"]["launches"]["flash_attention_fwd"] <= 0:
        raise AssertionError(f"pod-mesh serving launches: {out}")
    if toks["pod_2x2x2"] != toks["fcp_4x2"] or \
            len(toks["fcp_4x2"]) != POD_CHECK_REQUESTS:
        raise AssertionError("pod-mesh dense tokens differ from the 4x2 FCP "
                             "loop's")
    out["tokens_equal"] = True
    try:
        build(model, params, StackedMesh((2, 2, 2)), pcfg,
              scfg.replace(strict_prefill=True))
        raise AssertionError("strict_prefill did not raise on a pod mesh")
    except ValueError as e:
        if "strict_prefill" not in str(e):
            raise
        out["strict_prefill_raised"] = str(e)
    del model, params
    release()

    # full depth, bf16: cell 1's stream on the pod mesh
    cfg = get_config("stablelm_1_6b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    loop, warned = build(model, params, StackedMesh((2, 2, 2)),
                         ParallelConfig(block_size=512, in_dtype_bytes=2),
                         scfg)
    t0 = time.perf_counter()
    base = loop.warmup()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(fa)
    rep = loop.run(prompts(cfg.vocab_size, POD_SERVE_REQUESTS),
                   max_new=scfg.max_new_tokens)
    launches = read_counters(fa)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    programs = recompile_check(loop, base)
    if rep["requests"] != POD_SERVE_REQUESTS or \
            launches["flash_attention_fwd"] <= 0 or \
            launches["fused_flash_fwd"] != 0:
        raise AssertionError(f"pod-mesh serving: {rep['requests']} "
                             f"requests, launches {launches}")
    if not bool(torch.isfinite(loop.last_logits.float()).all()):
        raise AssertionError("pod-mesh decode logits not finite")
    first = loop.stats.finished[0]
    batch, last = loop.assemble(first.bucket, [first])
    out["full_depth_bf16"] = {
        "prefill_impl": rep["prefill_impl"], "warned": warned,
        "requests_cut": POD_SERVE_WHY,
        "warmup_s": warm_s, "wall_s": rep["wall_s"],
        "sustained_tok_s": rep["sustained_tok_s"],
        "requests": rep["requests"], "prefill_batches": rep["prefill_batches"],
        "prefill_ms_p50": rep["prefill_ms"]["p50"],
        "prefill_ms_p99": rep["prefill_ms"]["p99"],
        "decode_ms_p50": rep["decode_ms"]["p50"],
        "decode_steps": rep["decode_steps"], "launches": launches,
        "peak_mem_gib": peak, "reserved_gib": reserved, **programs,
        "prefill_batch_bucket": first.bucket,
        **program_checks(fa, loop, first.bucket, batch, last)}
    hold_replay(out["full_depth_bf16"], None)
    del loop, model, params, batch
    release()
    return out


def pod_phase(fa, ex, trainlib, dev, cfg, pcfg) -> tuple[dict, list]:
    """Phase 6: (a), (b), (c), then kernels 1-6 at the pod step's shapes
    (the rows of the ``stablelm pods`` path)."""
    out = {}
    for tag, fn in (("train", lambda: pod_train_phase(fa, trainlib, dev)),
                    ("drill", lambda: pod_drill_phase(fa, trainlib, dev)),
                    ("serve", lambda: pod_serve_phase(fa, dev))):
        t0 = time.perf_counter()
        out[tag] = fn()
        out[tag]["part_seconds"] = time.perf_counter() - t0
        log(f"  pods {tag}: ok {out[tag]['part_seconds']:.2f}s "
            f"{json.dumps(out[tag])}")
    t0 = time.perf_counter()
    rows = main_path_bwd(fa, ex, trainlib, cfg, pcfg, dev, pods=2)
    release()
    out["kernel_rows_seconds"] = time.perf_counter() - t0
    return out, rows


# --------------------------------------------------------------------------
# phase 7: the vision-language and audio families, head dim 16, the
# baseline CP policies
# --------------------------------------------------------------------------

VLM_ARCH = "internvl2_1b"       # full width and depth: 24 layers, d 896,
                                # 14 / 2 heads of 64, qkv_bias, vocab 151655
AUDIO_ARCH = "musicgen_large"   # full width: d 2048, 32 heads of 64
AUDIO_LAYERS = 6                # of 48: ~0.5 B parameters
AUDIO_WHY = ("depth cut for the run's time (at 48 layers it served in "
             "44.4 s and trained in 108.1 s, at 12 in 8-10 s and 22-30 s "
             "on an H100 80GB HBM3 host); the layers kept are at full "
             "width (d 2048, 32 heads of 64, d_ff 8192, vocab 2048)")
POLICIES = ("ring", "bytescale", "magi", "wlb")


def multimodal_breakdown(dev, arch: str) -> dict:
    """Two pieces of a multimodal train step that no other model has, at
    its shapes (4 frames of 2048 tokens, the stub's 256 patches a frame,
    bf16, full width), as device time under the profiler
    (``device_ms``): the front end's product (``frontend_proj``, forward
    and its weight gradient; the patches take none) and the head (final
    norm, the untied ``lm_head`` product over the padded vocabulary, the
    f32 cross entropy, forward and backward)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.loader import SyntheticLoader
    from repro_torch.launch import train as trainlib
    from repro_torch.models import layers, transformer
    cfg = get_config(arch).replace(n_layers=1)
    g = torch.Generator(device=dev).manual_seed(11)
    params = transformer.init_params(cfg, g, dev)
    b = SyntheticLoader(dist="real_world", n_frames=4, tokens_per_worker=2048,
                        vocab_size=cfg.vocab_size, seed=0).next()
    batch = trainlib.batch_arrays(b, cfg, dev)
    fe = batch["frontend_embeds"]
    proj = params["frontend_proj"].detach().requires_grad_(True)
    gp = torch.randn((*fe.shape[:2], cfg.d_model), generator=g,
                     device=dev).bfloat16()

    def front():
        y = torch.matmul(fe.to(proj.dtype), proj)
        return torch.autograd.grad(y, proj, gp)
    head_w = {k: params[k].detach().requires_grad_(True)
              for k in ("final_norm", "embed" if cfg.tie_embeddings
                        else "lm_head")}
    x = torch.randn((*batch["tokens"].shape, cfg.d_model), generator=g,
                    device=dev).bfloat16().requires_grad_(True)

    def head():
        loss = layers.cross_entropy(transformer.unembed(head_w, cfg, x),
                                    batch["labels"], batch["loss_mask"],
                                    cfg.vocab_size)
        return torch.autograd.grad(loss, [x, *head_w.values()])
    n_fe, n_tok = fe.shape[0] * fe.shape[1], x.shape[0] * x.shape[1]
    f_flop = 2 * 2.0 * n_fe * cfg.frontend_dim * cfg.d_model
    h_flop = 3 * 2.0 * n_tok * cfg.d_model * cfg.padded_vocab(1)
    out = {"frontend_proj_ms": device_ms(
               front, n=5, floor=bound(f_flop, PEAK_BF16, 0)["bound_ms"])[0],
           "frontend_proj_flop": f_flop,
           "head_ms": device_ms(
               head, n=3, floor=bound(h_flop, PEAK_BF16, 0)["bound_ms"])[0],
           "head_flop": h_flop,
           "padded_vocab": cfg.padded_vocab(1)}
    out["head_tflops"] = h_flop / out["head_ms"] / 1e9
    del params, head_w, x, batch
    release()
    return out


def d16_phase(fa, trainlib, dev) -> dict:
    """The path that needs head dim 16: internvl2's smoke config (2
    layers, 7 query heads over 1 kv head of 16, ``qkv_bias``, the front
    end) on the training CLI's shapes (4 workers of 2048 tokens, 512
    blocks): every leaf's gradient through kernels 1, 3, 4 and through
    2, 5, 6 against the plain versions with f32 weights
    (TOL_TRAIN_F32), one fused step with the counters read around it and
    one pallas step."""
    argv = model_argv(VLM_ARCH, None, 1) + ["--smoke"]
    out = {"grad_check_f32": train_grad_check(trainlib, dev, argv, 2)}
    release()
    steps = train_steps(fa, trainlib, dev, argv, 1)
    out["fused_step"] = {k: steps[k] for k in (
        "losses", "step_ms", "launches_steps")}
    out["pallas_step"] = train_pallas(fa, trainlib, dev, argv)
    return out


def policies_phase(fa, ex, trainlib, dev, cfg, pcfg) -> dict:
    """The paper's baseline CP policies (ring, ByteScale, Magi, WLB) and
    FCP's own plan through the port's fused executor (kernels 1, 3, 4),
    on the first fused training batch of ``cfg`` (the train CLI's loader:
    4 workers of 2048 tokens, 512 blocks), one layer's attention at full
    width, bf16: the forward against the plain dense oracle (f32 products
    over the same bf16 values) to TOL_O and each schedule's attention
    device time (forward and backward), FCP's beside them; with f32
    q/k/v, the q/k/v gradients against the plain executor on the same
    schedule to TOL_GRAD.
    The assignments are built as ``benchmarks/common.py`` builds them.
    Information only: no time is gated."""
    import torch
    from repro_torch.core import blocks as bl
    from repro_torch.core import cost_model as cm
    from repro_torch.core import policies
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.loader import SyntheticLoader
    from repro_torch.models import dense_attn_fn
    n, tpw = 4, 2048
    b = SyntheticLoader(dist="real_world", n_frames=n, tokens_per_worker=tpw,
                        vocab_size=cfg.vocab_size, seed=0,
                        bucket_min_len=pcfg.block_size).next()
    fcp = trainlib.build_schedule(cfg, pcfg, b.seqlens, n, tpw)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    batch = fcp.batch
    deps = bl.kv_dependencies(batch, mask=True)
    owners = {
        "ring": policies.assign_ring(batch, n),
        "bytescale": policies.assign_bytescale(batch, n, tpw),
        "magi": policies.assign_magi(batch, deps, n, H, D),
        "wlb": policies.assign_wlb(batch, deps, n, tpw, cm.GPU_X, H, KH, D)}
    scheds = {"fcp": fcp}
    for name, a in owners.items():
        scheds[name] = make_schedule(
            b.seqlens, n, tpw, pcfg.block_size, n_q_heads=H, n_kv_heads=KH,
            head_dim=D, coalesce=pcfg.coalesce, wire=pcfg.comm_dtype,
            in_dtype_bytes=pcfg.in_dtype_bytes, assignment=a, verify=True)
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q32, k32, v32 = rnd(n, tpw, H, D), rnd(n, tpw, KH, D), rnd(n, tpw, KH, D)
    cot = rnd(n, tpw, H, D)
    seg = torch.from_numpy(batch.seg_ids).to(dev).reshape(n, tpw)
    pos = torch.from_numpy(batch.positions).to(dev).reshape(n, tpw)
    qkv16 = [x.bfloat16() for x in (q32, k32, v32)]
    with torch.no_grad():
        want = dense_attn_fn(seg, pos)(*(x.float() for x in qkv16))
    out = {"seqlens": [int(x) for x in b.seqlens]}
    for name, s in scheds.items():
        tabs = ex.schedule_tables(s, dev)

        def run(impl, qkv, tabs=tabs, s=s):
            xs = [x.clone().requires_grad_(True) for x in qkv]
            o = ex.fcp_attention(*xs, tabs, spec=s.spec,
                                 cfg=ex.ExecConfig(impl=impl))
            return o.detach(), torch.autograd.grad(o, xs, cot)
        reset_counters(fa)
        o, _ = run("fused", qkv16)
        launches = read_counters(fa)
        for kname in ("fused_flash_fwd", "fused_flash_bwd_dq",
                      "fused_flash_bwd_dkv"):
            if launches[kname] <= 0:
                raise AssertionError(f"policy {name}: {kname} not launched")
        torch.cuda.synchronize()
        err_o = float((o - want).abs().max()) / max(
            float(want.abs().max()), 1.0)
        if not (err_o <= TOL_O and bool(torch.isfinite(o).all())):
            raise AssertionError(f"policy {name}: forward err {err_o:.3e} "
                                 f"against the dense oracle (tol {TOL_O})")
        # the gradients with f32 q/k/v (the kernels' f32 path), so the
        # comparison is the kernels' and not bf16's rounding of partial
        # sums the executor adds across runs
        _, gk = run("fused", (q32, k32, v32))
        _, gp = run("fused_xla", (q32, k32, v32))
        err_g = max(compare_grad(f"policy {name} d{x} (f32)", a, b_)
                    for x, a, b_ in zip("qkv", gk, gp))
        ms, _ = device_ms(lambda run=run: run("fused", qkv16), n=5)
        out[name] = {"assignment": [int(x) for x in s.assignment],
                     "n_rounds": s.spec.n_rounds, "n_steps": s.spec.n_steps,
                     "fwd_err": err_o, "grad_max_abs_err_f32": err_g,
                     "attention_fwd_bwd_device_ms": ms,
                     "launches": launches}
        del o, gk, gp
    release()
    return out


def multimodal_phase(fa, trainlib, dev, pcfg, scfg) -> tuple[dict, dict]:
    """internvl2-1b and musicgen-large at full width: served in phase 3's
    setting (16 requests, f32 prefill logits against plain; text-only, as
    the reference serves them), then trained through the CLI's plain loop
    (internvl2 first at 4 layers with f32 weights, every leaf's gradient
    against plain; then 3 fused steps, one profiled, a pallas step and
    the bf16 step-0 loss check; the front end's and the head's device
    time).  Returns (served, trained), keyed by model."""
    from repro_torch.configs.base import get_config
    served, trained = {}, {}
    for tag, arch, depth, why in (
            ("internvl2", VLM_ARCH, None, "the full depth, no cut"),
            ("musicgen", AUDIO_ARCH, AUDIO_LAYERS, AUDIO_WHY)):
        c = get_config(arch)
        t0 = time.perf_counter()
        served[tag] = serve(fa, c.replace(n_layers=depth or c.n_layers),
                            pcfg, scfg, dev)
        served[tag]["depth"] = f"{depth or c.n_layers} of {c.n_layers} " \
            f"layers: {why}"
        log(f"phase multimodal serve {tag}: ok "
            f"{time.perf_counter() - t0:.2f}s {json.dumps(served[tag])}")
        release()
        t0 = time.perf_counter()
        trained[tag] = {}
        if tag == "internvl2":
            trained[tag]["grad_check_4_layers_f32"] = train_grad_check(
                trainlib, dev, model_argv(arch, None, 3))
            release()
        depth_arg = depth if depth != c.n_layers else None
        trained[tag].update(train_model(fa, trainlib, dev, arch, 3,
                                        depth_arg, why))
        trained[tag]["breakdown"] = multimodal_breakdown(dev, arch)
        log(f"phase multimodal train {tag}: ok "
            f"{time.perf_counter() - t0:.2f}s {json.dumps(trained[tag])}")
        release()
    return served, trained


# --------------------------------------------------------------------------
# phase 8: llama3-70b (the paper's own model), the remat policies, the
# quantized wires
# --------------------------------------------------------------------------

LLAMA_ARCH = "llama3_70b"       # d 8192, 64 / 8 heads of 128 (GQA group
                                # 8), d_ff 28672, vocab 128256 untied
LLAMA_TRAIN_LAYERS = 3          # of 80: 4.67 B parameters
LLAMA_TRAIN_WHY = (
    "depth cut to fit the card: bf16 parameters and gradients with f32 "
    "AdamW moments take 12 B a parameter, 25.2 GB for the embedding and "
    "untied head and 10.3 GB a layer, beside the f32 logits of 8192 "
    "tokens and their gradient (4.2 GB each); 3 layers peaked at 67.5 GiB "
    "under dots on an H100 80GB HBM3, a 4th would pass 70; the layers "
    "kept are at full width")
LLAMA_INT8_EAGER_WHY = (
    "the int8 wire's step programs do not fit beside the rest of the "
    "script: alone in a process they captured and replayed (952.7 ms a "
    "step, peak 67.46 GiB allocated, 77.81 GiB reserved with the pool "
    "of the card's 79.18, on an H100 80GB HBM3 at 700 W), but after the "
    "earlier phases the first capture ran out of memory (72.76 GiB "
    "allocated, 8.19 GiB of them in the pool, a 3.91 GiB request with "
    "3.38 GiB free), so this run steps eagerly; dots and nothing, the "
    "same depth, are captured")
LLAMA_GRAD_LAYERS = 1           # f32: both runs' gradients on the card
LLAMA_GRAD_WHY = (
    "depth cut to fit the card: f32 weights and two runs' f32 gradients "
    "take 12 B a parameter, beside the plain attention's f32 score "
    "tensors of 64 heads (7.25 GiB each); at 2 layers the plain run's "
    "attention backward ran out of the card's 79 GiB")
LLAMA_SERVE_LAYERS = 8          # of 80
LLAMA_SERVE_WHY = (
    "depth cut to fit the card and the run's time: the logits check adds "
    "an f32 copy of the weights (4 B a parameter, 35.8 GB at 8 layers); "
    "the layers kept are at full width")
# the reference's wire gates (scripts/check_bench.py): round bytes at
# most this share of the f32 wire's, and the gradients' error against
# the f32 wire's at most this (max |a - b| / max(1, max |b|)), above 0
WIRE_LIMITS = {"bf16": {"round_bytes_ratio": 0.55, "grad_err": 1e-2},
               "int8": {"round_bytes_ratio": 0.35, "grad_err": 3e-2}}


def step_summary(r: dict) -> dict:
    """The numbers PERF.md sets side by side for one ``train_steps``
    run."""
    p = r["profile_step"]
    return {"step_ms": r["step_ms"], "tokens_per_s": r["tokens_per_s"],
            "device_ms": p["device_ms"], "busy_share": p["busy_share"],
            "window_ms": p["wall_ms"], "gemm_ms": p["gemm_ms"],
            "copies_ms": p["copies_ms"],
            "attention_kernels_ms": p["attention_kernels_ms"],
            "peak_mem_gib": r["peak_mem_gib"], "losses": r["losses"]}


def llama_train_phase(fa, trainlib, dev) -> dict:
    """llama3-70b through the training CLI's plain loop at full width:
    (a) LLAMA_GRAD_LAYERS deep with f32 weights, every leaf's gradient
    through kernels 1, 3, 4 and 2, 5, 6 against the plain versions
    (TOL_TRAIN_F32); (b) LLAMA_TRAIN_LAYERS deep, bf16: 3 fused steps
    (one more profiled) under each remat policy (``--remat-policy dots``,
    the default, then ``nothing``), one pallas step, and 3 fused steps
    (one more profiled) with ``--comm-dtype int8``; each after a round of
    the stream's builds, every profile a replay of the same batch of the
    stream.  No phase here writes a checkpoint (a
    2-layer state is about 45 GB)."""
    argv = model_argv(LLAMA_ARCH, LLAMA_TRAIN_LAYERS, 3)
    out = {"depth": {"n_layers": LLAMA_TRAIN_LAYERS, "why": LLAMA_TRAIN_WHY}}
    log(f"  card memory before llama3's training: "
        f"{json.dumps(card_memory())}")
    out["grad_check_f32"] = timed("llama3 f32 gradient check", lambda: {
        **train_grad_check(trainlib, dev, model_argv(LLAMA_ARCH, None, 3),
                           LLAMA_GRAD_LAYERS),
        "n_layers": LLAMA_GRAD_LAYERS, "why": LLAMA_GRAD_WHY})
    release()
    for policy in ("dots", "nothing"):
        r = timed(f"llama3 fused steps, remat {policy}", lambda: train_steps(
            fa, trainlib, dev, argv + ["--remat-policy", policy], 3))
        out[policy] = r if policy == "dots" else step_summary(r)
        log(f"  llama3 remat {policy}: "
            f"{json.dumps(step_summary(r))}")
    out.update({k: out["dots"][k] for k in ("launches_steps", "n_layers",
                                            "params", "tokens_per_s")})
    out["pallas_step"] = timed("llama3 pallas step", lambda: train_pallas(
        fa, trainlib, dev, argv))
    r = timed("llama3 fused steps, int8 wire", lambda: train_steps(
        fa, trainlib, dev, argv + ["--comm-dtype", "int8"], 3,
        eager_why=LLAMA_INT8_EAGER_WHY))
    out["int8_wire"] = step_summary(r)
    log(f"  llama3 int8 wire: {json.dumps(out['int8_wire'])} (f32 wire: "
        f"step_ms {out['dots']['step_ms']} device_ms "
        f"{out['dots']['profile_step']['device_ms']})")
    return out


def wire_formats(fa, ex, dev, cfg, n: int = 4, tpw: int = 2048,
                 bs: int = 512) -> dict:
    """The reference's ``wire_formats_section``
    (``benchmarks/bench_executor.py``) at llama3-70b's attention (64 / 8
    heads of 128, f32 q, k and v from a seed) on the training CLI's first
    plan (4 workers of 2048 tokens, block 512, coalesce 16, causal):
    each format's round bytes from its own plan
    (``cost_model.spec_wire_bytes``) against the f32 plan's; the
    gradients of ``sum(o * key)`` through kernels 1, 3 and 4 on the f32
    plan with only the spec's wire swapped, against the f32 wire's,
    held to the reference's gates (WIRE_LIMITS); the forward and
    backward's wall."""
    import dataclasses
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.loader import SyntheticLoader
    hq, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = SyntheticLoader(dist="real_world", n_frames=n, tokens_per_worker=tpw,
                        vocab_size=cfg.vocab_size, seed=0,
                        bucket_min_len=bs).next()
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((n, tpw, hq, d), generator=g, device=dev)
    k, v = (torch.randn((n, tpw, kvh, d), generator=g, device=dev)
            for _ in range(2))
    key = torch.randn(q.shape, generator=g, device=dev)
    out: dict = {"config": {"n_workers": n, "tokens_per_worker": tpw,
                            "block_size": bs, "heads": hq, "kv_heads": kvh,
                            "head_dim": d, "coalesce": 16,
                            "seqlens": [int(x) for x in b.seqlens]}}
    base, grads32 = None, None
    for fmt in ("f32", "bf16", "int8"):
        sched = make_schedule(b.seqlens, n, tpw, bs, n_q_heads=hq,
                              n_kv_heads=kvh, head_dim=d, mask=True,
                              coalesce=16, wire=fmt)
        row = {"comm_bytes": cm.spec_wire_bytes(sched.spec, hq, kvh, d)}
        if base is None:
            base = sched
        spec = dataclasses.replace(base.spec, wire=sched.spec.wire)
        tabs = ex.schedule_tables(base, dev)

        def step():
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = ex.fcp_attention(*xs, tabs, spec=spec,
                                 cfg=ex.ExecConfig(impl="fused"))
            return torch.autograd.grad((o * key).sum(), xs)
        reset_counters(fa)
        grads = step()
        torch.cuda.synchronize()
        row["launches"] = {n_: c for n_, c in read_counters(fa).items()
                           if n_ in PATH_KERNELS["fused"]}
        if min(row["launches"].values()) <= 0 or not all(
                bool(torch.isfinite(x).all()) for x in grads):
            raise AssertionError(f"wire {fmt}: launches {row['launches']}, "
                                 f"gradients finite?")
        row["fwd_bwd_ms"] = wall_ms(step, 5)
        if fmt == "f32":
            grads32 = grads
        else:
            row["grad_err_vs_f32"] = max(
                float((a - b_).abs().max()) / max(1.0, float(b_.abs().max()))
                for a, b_ in zip(grads, grads32))
            row["round_bytes_ratio"] = (row["comm_bytes"]["rounds"]
                                        / out["f32"]["comm_bytes"]["rounds"])
            row["total_bytes_ratio"] = (row["comm_bytes"]["total"]
                                        / out["f32"]["comm_bytes"]["total"])
            lim = WIRE_LIMITS[fmt]
            if not (0 < row["grad_err_vs_f32"] <= lim["grad_err"]
                    and row["round_bytes_ratio"]
                    <= lim["round_bytes_ratio"]):
                raise AssertionError(f"wire {fmt}: {row} against the "
                                     f"reference's gates {lim}")
        out[fmt] = row
        del grads
    del grads32
    release()
    return out


def llama_phase(fa, ex, trainlib, dev, pcfg, scfg, plain_step) -> tuple:
    """Phase 8: llama3-70b served (LLAMA_SERVE_LAYERS deep, phase 3's
    setting and checks) and trained (``llama_train_phase``); StableLM's
    fused step under ``--remat-policy nothing`` beside the train phase's
    default (``dots``) one; the wire formats.  Returns (served, trained,
    extra)."""
    from repro_torch.configs.base import get_config
    c = get_config(LLAMA_ARCH)
    t0 = time.perf_counter()
    served = serve(fa, c.replace(n_layers=LLAMA_SERVE_LAYERS), pcfg, scfg,
                   dev, eager=True)
    served["depth"] = (f"{LLAMA_SERVE_LAYERS} of {c.n_layers} layers: "
                       f"{LLAMA_SERVE_WHY}")
    log(f"phase llama3 serve: ok {time.perf_counter() - t0:.2f}s "
        f"{json.dumps(served)}")
    release()
    t0 = time.perf_counter()
    trained = llama_train_phase(fa, trainlib, dev)
    log(f"phase llama3 train: ok {time.perf_counter() - t0:.2f}s "
        f"{json.dumps(trained)}")
    t0 = time.perf_counter()
    # a round and 3 steps, then the profiled one: the train phase's step
    # (the same batch), so the two profiles time the same plan
    extra = {"stablelm_remat": {"dots": plain_step or step_summary(
        train_steps(fa, trainlib, dev, TRAIN_ARGV, 3))}}
    extra["stablelm_remat"]["nothing"] = step_summary(train_steps(
        fa, trainlib, dev, TRAIN_ARGV + ["--remat-policy", "nothing"], 3))
    log(f"phase stablelm remat policies: ok {time.perf_counter() - t0:.2f}s "
        f"{json.dumps(extra['stablelm_remat'])}")
    t0 = time.perf_counter()
    extra["wire_formats"] = wire_formats(fa, ex, dev, c)
    log(f"phase wire formats: ok {time.perf_counter() - t0:.2f}s "
        f"{json.dumps(extra['wire_formats'])}")
    return served, trained, extra


RANKS = 2                       # gloo ranks on the one card
RANKS_LAYERS = 4                # of 24
RANKS_WHY = ("depth cut for the run's time: every step runs eagerly, its "
             "ships across ranks and its gradient sum through gloo's "
             "loopback TCP (at 8 of 24 layers a step took 6.8-7.7 s, 5.7-7.1 "
             "s of it in the ships and the sums, and the phase 157-212 s on "
             "an H100 80GB HBM3 host at 700 W); two ranks on one card each "
             "hold the whole model and its AdamW state; the layers kept are "
             "at full width (d 2048, 32 heads of 64)")
RANKS_GRAD_LAYERS = 4           # the f32 gradient check
RANKS_ARGV = TRAIN_ARGV + ["--override", f"n_layers={RANKS_LAYERS}"]
RANKED_FLAGS = ["--dist-backend", "gloo", "--device", "cuda:0"]
RANKS_TIMEOUT = 600             # seconds a torchrun may take
# the Supervisor's drills across the two ranks: phase 5's kill drill on a
# 2x1 mesh (one worker a rank) and phase 6's pod drill on 2x2x1 (one pod a
# rank), at their totals, fail step and checkpoint cadence
RANKED_DRILLS = f"kill@2x1:{DRILL_TOTAL},pod@2x2x1:{POD_DRILL_TOTAL}"
RANKED_DRILL_ARGV = [
    "--drills", RANKED_DRILLS, "--drill-args",
    f"--override n_layers={DRILL_LAYERS} --override param_dtype=float32 "
    f"--checkpoint-every {DRILL_EVERY}"]
RANKED_DRILL_WHY = (
    "phases 5's and 6's settings (DRILL_WHY: steps cut from the reference "
    "runner's 12, 1 layer, 5.5 GB checkpoints): the kill drill 5 steps and "
    "the pod drill 7, worker 1 or pod 1 lost at step 3, checkpoints every "
    "2 steps, the pod rejoining at step 5 (launch/ranks.py's FAIL_STEP "
    "and REJOIN_STEP); both fail in round 2 (FAIL_ROUND; the pod phase's "
    "is 1), which only names the round "
    "in the failure's record; every two-rank step sums 1.8 GB of f32 "
    "gradients through gloo's loopback TCP")
# serving across the ranks: cell 1's setting (block 512, 2,048 prefill
# tokens a worker, a 4x2 mesh) at RANKS_LAYERS deep, 16 new tokens a
# request; per kind the requests and the serve CLI's own arguments
SERVE_RANKS_ARGV = ["--arch", "stablelm_1_6b", "--mesh", "4x2",
                    "--override", f"n_layers={RANKS_LAYERS}",
                    "--block-size", "512", "--prefill-tokens-per-worker",
                    "2048", "--tokens", "16"]
SERVE_RANKS = {
    # 8 slots (4 a rank), 64-2,048-token prompts
    "decode": (8, ["--slots", "8", "--cache-len", "4096", "--prompt-min",
                   "64", "--prompt-len", "2048", "--seed", "0"]),
    # 2 slots, the cache's 12,288 positions 6,144 a rank; seed 5 draws
    # prompts of 6,170, 6,994, 2,187 and 7,012 tokens: three span both
    # ranks' prefill frames (4,096 tokens a rank) and caches
    "long": (4, ["--slots", "2", "--cache-len", "12288", "--prompt-min",
                 "2048", "--prompt-len", "8192", "--seed", "5"]),
}
# the runs with both of the executor's scheduling flags across the ranks:
# the plain loop for 3 fused steps and its f32 gradient check (run name
# of launch/ranks.py), and the serve CLI's --overlap under --kind long
BOTH_FLAGS = ["--layer-pipeline", "--overlap"]
RANKS_BOTH = "fused+layer-pipeline+overlap"
RANKS_TURN_STEPS = 2            # the second turn of each of the two runs
SERVE_OVERLAP = "long"          # SERVE_RANKS' kind run with --overlap
SERVE_NULL_DRAWS = 3            # draws of the serving logits' noise floor
SERVE_RANKS_WHY = ("requests cut from phase 3's 16 to 8 (decode) and 4 "
                   "(long) for the run's time: a ranked loop runs every "
                   "program eagerly, its prefill ships and inserts through "
                   "gloo's loopback TCP, and its warmup builds every "
                   "bucket from 32 to 4,096 (decode) or 8,192 (long)")


def torchrun(nproc: int, argv: list, what: str) -> float:
    """``python -m torch.distributed.run --standalone`` of ``nproc``
    ranks running ``argv`` (``-m module ...``) from the repository root
    (the training CLI's ranks: ``repro_torch.launch.ranks``, which load
    the kernels this process built: ``kernels/build.py``'s stamp);
    raises with the ranks' last output on a failure.  Returns its wall."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src") + (
                   os.pathsep + os.environ["PYTHONPATH"]
                   if os.environ.get("PYTHONPATH") else ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", *argv]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=RANKS_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"ranks {what}: no end after {RANKS_TIMEOUT} "
                             f"s") from e
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"ranks {what}: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    return wall


def rank_reports(out_dir: str, nproc: int) -> list:
    reps = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    return reps


def nccl_one_rank(fa, trainlib, argv: list) -> dict:
    """The training CLI in this process as the one rank of an NCCL group
    (torchrun's environment set around it): its trainer's report."""
    import socket
    import torch
    from repro_torch.runtime import wire
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(fa)
    wire.reset_wire_stats()
    t0 = time.perf_counter()
    try:
        tr = trainlib.main(argv + ["--dist-backend", "nccl", "--device",
                                   "cuda"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    report = tr.report(wall)
    del tr
    release()
    return {"wall_s": wall, "reports": [report]}


def step_wire_price(spec, cfg, pcfg, rk, in_b: float, out_b: float) -> int:
    """A rank's bytes on the wire in one train step of a one-mask model
    on ``spec``'s plan: every layer's forward ships twice (the forward,
    and its recompute under remat), its backward once
    (``wire.rank_wire_bytes``); under ``--layer-pipeline`` a layer ships
    its KV rounds alone, and the hidden state with one position channel
    moves in and the hidden state out once, forward and backward
    (``wire.reshuffle_wire_bytes``: outside the layers' checkpoints)."""
    from repro_torch.runtime import wire
    nh, nkv = cfg.padded_heads(1)
    if not pcfg.layer_pipeline:
        fwd, bwd = wire.rank_wire_bytes(spec, rk, nh, nkv, cfg.head_dim,
                                        in_b, out_b)
        return int(cfg.n_layers * (2 * fwd + bwd))
    fwd, bwd = wire.rank_wire_bytes(spec, rk, nh, nkv, cfg.head_dim, in_b,
                                    out_b, layout="sched")
    moves = (wire.reshuffle_wire_bytes(spec, rk, cfg.d_model + 1)
             + wire.reshuffle_wire_bytes(spec, rk, cfg.d_model,
                                         reverse=True))
    return int(cfg.n_layers * (2 * fwd + bwd) + sum(moves))


def ranks_pricing(trainlib, argv, steps: int, nproc: int) -> list:
    """Each rank's bytes on the wire for each of the first ``steps``
    batches of ``argv``'s stream, priced from the plans a one-process run
    makes (:func:`step_wire_price`)."""
    from repro_torch.runtime import wire
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    try:
        cfg, pcfg = tr.cfg, tr.pcfg
        in_b = trainlib.param_dtype_bytes(cfg)
        out_b = 2 if pcfg.attn_out_bf16 else 4
        priced = []
        for _ in range(steps):
            b = tr.loader.next()
            spec = trainlib.build_schedule(cfg, pcfg, b.seqlens, tr.n_cp,
                                           tr.tpw, mask=tr.group_masks[0]
                                           ).spec
            priced.append([step_wire_price(
                spec, cfg, pcfg, wire.Ranks(nproc, r, "gloo"), in_b, out_b)
                for r in range(nproc)])
    finally:
        tr.close()
    del tr
    release()
    return priced


def hold_ranked(tag: str, run: dict, kernels: tuple, priced: list | None,
                loss_ref: dict | None, card: str) -> dict:
    """A ranked run's checks: finite losses the same on every rank, each
    kernel of its path launched in each rank, each rank's bytes on the
    wire each step equal to ``priced``, and its step-0 loss within
    BF16_FLOORS noise floors of the one-process run's (``loss_ref``)."""
    reps = run["reports"]
    losses = [[x["loss"] for x in r["records"]] for r in reps]
    if not (all(np.isfinite(losses[0])) and all(x == losses[0]
                                                 for x in losses)):
        raise AssertionError(f"ranks {tag}: losses {losses}")
    for r in reps:
        for name in kernels:
            if r["launches"][name] <= 0:
                raise AssertionError(f"ranks {tag}: {name} never launched "
                                     f"in rank {r['rank']}")
    sent = [[x["sent_bytes"] for x in r["records"]] for r in reps]
    if priced is not None:
        want = [[row[r] for row in priced[:len(sent[r])]]
                for r in range(len(reps))]
        if sent != want:
            raise AssertionError(f"ranks {tag}: bytes on the wire {sent} "
                                 f"against their pricing {want}")
    out = {"wall_s": run["wall_s"], "losses": losses[0],
           "step_ms": [[x["ms"] for x in r["records"]] for r in reps],
           "ship_s": [[x["ship_s"] for x in r["records"]] for r in reps],
           "ship_wait_s": [[x["ship_wait_s"] for x in r["records"]]
                           for r in reps],
           "reduce_s": [[x["reduce_s"] for x in r["records"]]
                        for r in reps],
           "peak_mem_gib": [r["peak_mem_gib"] for r in reps],
           "sent_bytes": sent,
           "launches": [{n: r["launches"][n] for n in kernels}
                        for r in reps],
           "backend": reps[0]["backend"],
           "frames": [r["frames"] for r in reps]}
    if loss_ref is not None:
        diff = abs(losses[0][0] - loss_ref["kernels"])
        out["step0_vs_stacked"] = {"ranked": losses[0][0],
                                   "stacked": loss_ref["kernels"],
                                   "diff": diff,
                                   "noise_floor": loss_ref["noise_floor"]}
        if not diff <= BF16_FLOORS * loss_ref["noise_floor"]:
            raise AssertionError(
                f"ranks {tag}: step-0 loss {losses[0][0]} against the "
                f"stacked run's {loss_ref['kernels']}: {diff:.3e} > "
                f"{BF16_FLOORS} x the noise floor "
                f"{loss_ref['noise_floor']:.3e}")
    def rounded(key, n):
        return [[round(x, n) for x in r] for r in out[key]]
    log(f"  ranks {tag}: wall {out['wall_s']:.1f} s, step ms per rank "
        f"{rounded('step_ms', 1)} (in the ships across ranks s "
        f"{rounded('ship_s', 2)}, of them in the ships' own calls s "
        f"{rounded('ship_wait_s', 2)}, in the sums over the ranks s "
        f"{rounded('reduce_s', 2)}), peak GiB "
        f"per rank {[round(x, 2) for x in out['peak_mem_gib']]}, bytes on "
        f"the wire per rank and step {sent}; on {card}")
    return out


def stacked_eager_steps(trainlib, argv, steps: int) -> dict:
    """The one-process stacked run of ``argv``, every step eager
    (``EagerSteps``, as the ranked steps run): the walls, losses and peak
    the ranked runs are set beside."""
    import torch
    tr = trainlib.trainer_from_args(trainlib.parse_args(argv))
    tr._program = EagerSteps()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs = tr.run(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        tr.close()
    del tr
    release()
    return {"step_ms": [r.ms for r in recs], "losses": [r.loss for r in recs],
            "peak_mem_gib": peak}


def serve_ranks_args(kind: str, extra: list):
    """The serve CLI's arguments of phase 9's ``kind`` run."""
    from repro_torch.launch import serve as S
    n, argv = SERVE_RANKS[kind]
    return S.parse_args(SERVE_RANKS_ARGV + argv + extra + [
        "--kind", kind, "--requests", str(n)])


def serve_stacked(kind: str, dev, extra: tuple = ()) -> dict:
    """The yardstick of a ranked serving run: the one-process stacked loop
    of the same arguments, every program eager (``EagerPrograms``, as the
    ranked ones run), in this process: its report (tokens, walls, peak),
    its recorded logits (``ServingLoop.record``), and the logits' noise
    floors at its first prefill batch and its first decode step: a null
    test, as ``train_loss_check``'s, the plain path with each attention
    output moved by the kernel's own deviation from it under random
    signs, against the plain path (the largest of SERVE_NULL_DRAWS)."""
    import torch
    from repro_torch.launch import serve as S
    args = serve_ranks_args(kind, ["--device", "cuda:0", *extra])
    release()
    loop, _ = S.loop_from_args(args)
    loop._program = EagerPrograms(dev)
    first, state = [], {}
    inner_prefill, inner_step = loop._prefill_and_insert, loop._dispatch_step

    def spy_prefill(reqs, free):
        if loop.record is not None and not first:
            first.append((reqs[0].bucket, list(reqs)))
        return inner_prefill(reqs, free)

    def spy_step():
        if loop.record is not None and not state:
            state.update(tok=loop.state["tok"].clone(),
                         pos=loop.state["pos"].clone(),
                         cache={k: c.clone() for k, c in loop.cache.items()})
        return inner_step()
    loop._prefill_and_insert, loop._dispatch_step = spy_prefill, spy_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report = S.serve(loop, args, record=True)
    report["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    g = torch.Generator(device=dev).manual_seed(5)

    def flipped(kern, plain):
        def attn(*a):
            o = plain(*a)
            sign = torch.randint(0, 2, o.shape, generator=g, device=dev)
            return o + (kern(*a) - o) * (2 * sign - 1).to(o.dtype)
        return attn
    E, reqs = first[0]
    batch, last = loop.assemble(E, reqs)
    rows = list(range(len(reqs)))

    def prefill(attn):
        step = S.build_prefill_step(loop.model, attn, loop.budget // E, E,
                                    ragged=True)
        return step(loop.params, batch, last)[0][rows].float()
    fcp = {impl: S.make_fcp_attn_fn(loop._schedule_for(E), dev, loop.pcfg,
                                    impl) for impl in ("fused", "fused_xla")}
    plain = prefill(fcp["fused_xla"])
    floor_prefill = max(_nerr(prefill(flipped(fcp["fused"],
                                              fcp["fused_xla"])), plain)
                        for _ in range(SERVE_NULL_DRAWS))
    dec = {impl: S.build_decode_fns(loop.model.cfg, loop.mesh, kind, impl)
           for impl in ("fused", "fused_xla")}
    held = [r["slots"] for r in loop.record if r["phase"] == "decode"][0]

    def decode(attn):
        cache = {k: c.clone() for k, c in state["cache"].items()}
        lg, _ = loop.model.decode_step(loop.params, state["tok"],
                                       state["pos"], cache, attn,
                                       dec["fused"][1])
        return lg[held].float()
    plain_d = decode(dec["fused_xla"][0])
    floor_decode = max(_nerr(decode(flipped(dec["fused"][0],
                                            dec["fused_xla"][0])), plain_d)
                       for _ in range(SERVE_NULL_DRAWS))
    out = {"report": report, "record": loop.record,
           "floors": {"prefill": floor_prefill, "decode": floor_decode}}
    del loop, state, batch, plain, plain_d
    release()
    return out


def hold_serve_ranked(tag: str, reps: list, records: list, ref: dict,
                      card: str, hold_tokens: bool = False) -> dict:
    """A ranked serving run's checks against its stacked yardstick
    (``serve_stacked``): 0 programs built after warmup and a plan-cache
    hit on every prefill batch on every rank; kernels 1 and 2 launched in
    each rank; each rank's bytes in the prefill ships, the inserts and the
    merges equal to their host pricing; the plan keys and the tokens the
    same on every rank; each prefill batch's last-token logits and the
    first decode step's, on the rank that holds them, within BF16_FLOORS
    noise floors of the stacked loop's.  The tokens that agree with the
    stacked loop's are counted, and held equal only with
    ``hold_tokens`` (bf16 argmax near-ties may flip)."""
    for r in reps:
        pcs = r["plan_cache"]
        if r["recompiles"] != 0 or pcs["misses"] or \
                pcs["hits"] != r["prefill_batches"]:
            raise AssertionError(
                f"ranks serve {tag}: rank {r['ranks']['rank']} recompiles "
                f"{r['recompiles']}, plan cache {pcs} over "
                f"{r['prefill_batches']} batches")
        for name in ("fused_flash_fwd", "flash_attention_fwd"):
            if r["launches"][name] <= 0:
                raise AssertionError(f"ranks serve {tag}: {name} never "
                                     f"launched in rank {r['ranks']['rank']}")
        rk = r["ranks"]
        for what in ("prefill_ship_bytes", "insert_bytes", "merge_bytes"):
            if rk[what] != rk[what + "_priced"]:
                raise AssertionError(
                    f"ranks serve {tag}: rank {rk['rank']} {what} "
                    f"{rk[what]} against their pricing "
                    f"{rk[what + '_priced']}")
    for key in ("plan_keys", "tokens"):
        if any(r[key] != reps[0][key] for r in reps):
            raise AssertionError(f"ranks serve {tag}: the ranks' {key} "
                                 f"differ")
    want = ref["report"]["tokens"]
    got = {int(k): v for k, v in reps[0]["tokens"].items()}
    if sorted(got) != sorted(want):
        raise AssertionError(f"ranks serve {tag}: requests {sorted(got)} "
                             f"against the stacked loop's {sorted(want)}")
    agree = sum(a == b for k in want for a, b in zip(got[k], want[k]))
    total = sum(len(v) for v in want.values())
    if hold_tokens and got != {int(k): v for k, v in want.items()}:
        raise AssertionError(f"ranks serve {tag}: {agree} of {total} "
                             f"tokens agree with the stacked loop's")
    stk = {}
    for e in ref["record"]:
        for i, key in enumerate(e.get("rids", e.get("slots"))):
            stk[e["phase"], key] = e["logits"][i]
    errs = {"prefill": [], "decode": []}
    for rec in records:
        for e in rec:
            for i, key in enumerate(e.get("rids", e.get("slots"))):
                errs[e["phase"]].append(_nerr(e["logits"][i],
                                              stk[e["phase"], key]))
    worst = {k: max(v, default=0.0) for k, v in errs.items()}
    for k in errs:
        floor = ref["floors"][k]
        if not errs[k] or worst[k] > BF16_FLOORS * floor:
            raise AssertionError(
                f"ranks serve {tag}: {k} logits against the stacked loop's "
                f"{worst[k]:.3e} over {len(errs[k])} rows > {BF16_FLOORS} x "
                f"the noise floor {floor:.3e}")
    stacked = ref["report"]
    out = {"run_wall_s": [r["run_wall_s"] for r in reps],
           "stream_wall_s": [r["wall_s"] for r in reps],
           "sustained_tok_s": [r["sustained_tok_s"] for r in reps],
           "stacked_eager_wall_s": stacked["wall_s"],
           "stacked_eager_tok_s": stacked["sustained_tok_s"],
           "stacked_peak_mem_gib": stacked["peak_mem_gib"],
           "warmup_s": [r["warmup_s"] for r in reps],
           "prefill_batches": reps[0]["prefill_batches"],
           "decode_steps": reps[0]["decode_steps"],
           "prefill_ms_p50": [r["prefill_ms"]["p50"] for r in reps],
           "decode_ms_p50": [r["decode_ms"]["p50"] for r in reps],
           "peak_mem_gib": [r["peak_mem_gib"] for r in reps],
           "ranks": [r["ranks"] for r in reps],
           "launches": [{n: r["launches"][n] for n in (
               "fused_flash_fwd", "flash_attention_fwd")} for r in reps],
           "logits_err": worst, "logits_rows": {k: len(v)
                                                for k, v in errs.items()},
           "noise_floors": ref["floors"],
           "tokens_agreeing": f"{agree} of {total}"}
    log(f"  ranks serve {tag}: stream wall s "
        f"{[round(x, 2) for x in out['stream_wall_s']]} ({[round(x, 1) for x in out['sustained_tok_s']]} tok/s) against "
        f"the stacked eager loop's {stacked['wall_s']:.2f} s "
        f"({stacked['sustained_tok_s']:.1f} tok/s); per rank bytes moved at"
        f" inserts {[x['insert_bytes'] for x in out['ranks']]} "
        f"({[round(x['insert_s'], 3) for x in out['ranks']]} s), sent in "
        f"merges {[x['merge_bytes'] for x in out['ranks']]} "
        f"({[round(x['merge_s'], 3) for x in out['ranks']]} s), in the "
        f"prefill ships {[x['prefill_ship_bytes'] for x in out['ranks']]} "
        f"({[round(x['prefill_ship_s'], 3) for x in out['ranks']]} s, "
        f"of them in the ships' own calls "
        f"{[round(x['prefill_ship_wait_s'], 3) for x in out['ranks']]} s); "
        f"peak GiB {[round(x, 2) for x in out['peak_mem_gib']]} (stacked "
        f"{stacked['peak_mem_gib']:.2f}); logits err {worst} (floors "
        f"{ref['floors']}); tokens agreeing {out['tokens_agreeing']}; on "
        f"{card}")
    return out


def nccl_serve_one_rank(fa, kind: str) -> tuple[dict, list]:
    """The serve CLI's loop in this process as the one rank of an NCCL
    group (torchrun's environment set around it): its report (as
    ``launch/ranks.serve_run`` writes one) and its recorded logits."""
    import socket
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.runtime import wire
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(fa)
    wire.reset_wire_stats()
    args = serve_ranks_args(kind, ["--dist-backend", "nccl", "--device",
                                   "cuda"])
    t0 = time.perf_counter()
    try:
        loop, joined = S.loop_from_args(args)
        try:
            report = S.serve(loop, args, record=True)
        finally:
            wire.barrier(loop.ranks)
            if joined:
                wire.leave()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    import hashlib
    report.update(
        run_wall_s=time.perf_counter() - t0, launches=read_counters(fa),
        plan_keys=sorted(hashlib.sha256(repr(k).encode()).hexdigest()[:16]
                         for k in loop.plan_cache.keys()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    record = loop.record
    del loop
    release()
    return json.loads(json.dumps(report)), record


def ranks_phase(fa, trainlib, dev, card: str) -> dict:
    """Phase 9 (module docstring): one torchrun of two gloo ranks for the
    fused run, the pallas run, the gradient check and the serving runs
    (``repro_torch.launch.ranks``), then the one-rank NCCL runs here."""
    import shutil
    import torch
    release()
    out = {"depth": {"n_layers": RANKS_LAYERS, "why": RANKS_WHY}}
    out["stacked_bf16_step0_loss"] = ref = timed(
        "ranks stacked loss check", lambda: train_loss_check(
            trainlib, dev, RANKS_ARGV))
    out["stacked_eager"] = st = timed(
        "ranks stacked eager steps", lambda: stacked_eager_steps(
            trainlib, RANKS_ARGV, 3))
    log(f"  ranks stacked (one process, eager): step ms "
        f"{[round(x, 1) for x in st['step_ms']]}, losses {st['losses']}, "
        f"peak {st['peak_mem_gib']:.2f} GiB; on {card}")
    out["stacked_bf16_step0_loss_both"] = ref_both = timed(
        "ranks stacked loss check with both flags", lambda: train_loss_check(
            trainlib, dev, RANKS_ARGV + BOTH_FLAGS))
    priced = ranks_pricing(trainlib, RANKS_ARGV, 3, RANKS)
    priced_both = ranks_pricing(trainlib, RANKS_ARGV + BOTH_FLAGS, 3, RANKS)
    log(f"  ranks priced bytes a rank and step: {priced} (flagless), "
        f"{priced_both} ({' '.join(BOTH_FLAGS)})")
    stacked = {}
    for kind in SERVE_RANKS:
        stacked[kind] = timed(f"ranks stacked serve {kind}",
                              lambda: serve_stacked(kind, dev))
    ov_kind = SERVE_OVERLAP
    stacked["overlap"] = timed(
        f"ranks stacked serve {ov_kind} --overlap",
        lambda: serve_stacked(ov_kind, dev, ("--overlap",)))
    out_dir = os.path.join(BUILD, "ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    serve_runs = []
    for kind, flags in [(k, []) for k in SERVE_RANKS] + [
            (ov_kind, ["--overlap"])]:
        n, argv = SERVE_RANKS[kind]
        serve_runs += ["--serve", " ".join(
            [f"{kind}:{n}", *SERVE_RANKS_ARGV, *argv, *flags,
             *RANKED_FLAGS])]
    # the flagless fused run and the run with both flags in turns
    # (fused, both, pallas, both, fused: RANKS_TURNS)
    wall = torchrun(RANKS, [
        "-m", "repro_torch.launch.ranks", "--out", out_dir, "--runs",
        f"fused:3,{RANKS_BOTH}:3,pallas:1,{RANKS_BOTH}:{RANKS_TURN_STEPS},"
        f"fused:{RANKS_TURN_STEPS}", "--grad-layers",
        str(RANKS_GRAD_LAYERS), *serve_runs, *RANKED_DRILL_ARGV, "--",
        *RANKS_ARGV, *RANKED_FLAGS], "gloo")
    out["torchrun_wall_s"] = wall
    log(f"  ranks torchrun (2 gloo ranks: fused, {RANKS_BOTH}, pallas, "
        f"gradient checks, serving {', '.join(SERVE_RANKS)} and {ov_kind} "
        f"--overlap, drills {RANKED_DRILLS}): wall {wall:.1f} s")
    out["drills"] = hold_ranked_drills(out_dir, card)
    for impl, kernels, loss_ref, price in (
            ("fused", PATH_KERNELS["fused"], ref, priced),
            (RANKS_BOTH, PATH_KERNELS["fused"], ref_both, priced_both),
            ("pallas", PATH_KERNELS["pallas"], None, priced),
            (RANKS_BOTH + ".2", PATH_KERNELS["fused"], ref_both,
             priced_both),
            ("fused.2", PATH_KERNELS["fused"], ref, priced)):
        reps = rank_reports(os.path.join(out_dir, impl), RANKS)
        out[impl] = hold_ranked(
            f"gloo {impl}", {"wall_s": reps[0]["wall_s"], "reports": reps},
            kernels, price, loss_ref, card)
    out["turns"] = ranks_turns(out)
    log(f"  ranks in turns (fused, {RANKS_BOTH}, pallas, {RANKS_BOTH}, "
        f"fused; each rank's steps past a run's first): "
        f"{json.dumps(out['turns'])}; on {card}")
    with open(os.path.join(out_dir, "grads.json")) as f:
        grads = json.load(f)
    for impl in ("fused", RANKS_BOTH, "pallas"):
        r = grads[impl]
        if not (r["finite"] and r["max_leaf_err"] <= TOL_GRAD):
            raise AssertionError(
                f"ranks f32 gradients ({impl}, {RANKS_GRAD_LAYERS} layers) "
                f"against the stacked run: max leaf err "
                f"{r['max_leaf_err']:.3e} > {TOL_GRAD}")
    out["grad_check_f32"] = grads
    log(f"  ranks f32 gradients vs stacked: {json.dumps(grads)}")
    nccl = [x for x in RANKS_ARGV]
    nccl[nccl.index("--steps") + 1] = "2"
    out["nccl_one_rank"] = hold_ranked("nccl one rank", nccl_one_rank(
        fa, trainlib, nccl), PATH_KERNELS["fused"], None, ref, card)
    # the started and landed ships under NCCL: a one-rank group has no
    # pair across ranks, so this holds only that the path runs (a pair
    # across NCCL ranks needs two cards)
    out["nccl_one_rank_both"] = hold_ranked(
        "nccl one rank " + " ".join(BOTH_FLAGS), nccl_one_rank(
            fa, trainlib, nccl + BOTH_FLAGS), PATH_KERNELS["fused"], None,
        ref_both, card)
    out["serve"] = {"requests_why": SERVE_RANKS_WHY,
                    "settings": {k: SERVE_RANKS_ARGV + v[1]
                                 for k, v in SERVE_RANKS.items()}}
    for kind, tag, ref_loop in [(k, k, stacked[k]) for k in SERVE_RANKS] + [
            (ov_kind, "overlap", stacked["overlap"])]:
        d = os.path.join(out_dir, f"serve_{kind}" + (
            "_overlap" if tag == "overlap" else ""))
        reps = rank_reports(d, RANKS)
        records = [torch.load(os.path.join(d, f"rank{r}_logits.pt"))
                   for r in range(RANKS)]
        out["serve"][tag] = hold_serve_ranked(
            f"gloo {kind}" + (" --overlap" if tag == "overlap" else ""),
            reps, records, ref_loop, card, hold_tokens=tag == "overlap")
    rep, rec = nccl_serve_one_rank(fa, "long")
    out["serve"]["nccl_one_rank_long"] = hold_serve_ranked(
        "nccl one rank long", [rep], [rec], stacked["long"], card)
    return out


def ranks_turns(out: dict) -> dict:
    """The flagless fused run and the run with both flags, taken in turns:
    each one's step walls past its runs' first step, every rank's, and
    their median."""
    turns = {}
    for tag, names in (("flagless", ("fused", "fused.2")),
                       (RANKS_BOTH, (RANKS_BOTH, RANKS_BOTH + ".2"))):
        ms = [x for n in names for per_rank in out[n]["step_ms"]
              for x in per_rank[1:]]
        turns[tag] = {"step_ms": ms, "median_ms": float(np.median(ms))}
    return turns


def hold_ranked_drills(out_dir: str, card: str) -> dict:
    """The ranked drills' checks (module docstring, phase 9), from each
    rank's ``drill_<kind>/rank<r>.json``; their walls, bytes and seconds
    printed."""
    from repro_torch.launch import drills
    out = {"settings": RANKED_DRILLS, "why": RANKED_DRILL_WHY}
    for kind in ("kill", "pod"):
        reps = rank_reports(os.path.join(out_dir, f"drill_{kind}"), RANKS)
        for r in reps:
            tag = f"ranks drill {kind} rank {r['rank']}"
            for name in PATH_KERNELS["fused"]:
                if r["launches"][name] <= 0:
                    raise AssertionError(f"{tag}: {name} never launched")
            if not (0 <= r["steps_lost"] <= DRILL_EVERY
                    and r["replay_max_diff"] <= drills.REPLAY_TOL):
                raise AssertionError(
                    f"{tag}: lost {r['steps_lost']} steps, replay diff "
                    f"{r['replay_max_diff']:.3e}")
            if kind == "pod":
                rj = r["rejoin"]
                if not (rj["plan_misses_after"] == rj["plan_misses_before"]
                        and rj["compiles_after"] == rj["compiles_before"]
                        and rj["builds_after"] == rj["builds_before"]
                        and rj["broadcast_bytes"] == rj["broadcast_priced"]):
                    raise AssertionError(f"{tag}: after the rejoin {rj}")
        if kind == "pod" and len({r["param_digest"] for r in reps}) != 1:
            raise AssertionError(
                f"ranks drill pod: the rejoined rank's parameters differ "
                f"from the survivor's ({[r['param_digest'] for r in reps]})")
        keys = ("sent_bytes", "ship_s", "reduce_s", "broadcast_bytes",
                "broadcast_s")
        res = {"seconds": [r["seconds"] for r in reps],
               "members": [r["members"] for r in reps],
               "fleet_ms": [[x["ms"] for x in r["records"]] for r in reps],
               "rank_ms": [[x["rank_ms"] for x in r["records"]]
                           for r in reps],
               "steps": [[(x["step"], x["pods"], x["n_workers"])
                          for x in r["records"]] for r in reps],
               "wire": [{k: r["wire"][k] for k in keys} for r in reps],
               "launches": [{n: r["launches"][n]
                             for n in PATH_KERNELS["fused"]} for r in reps],
               "steps_lost": reps[0]["steps_lost"],
               "replay_max_diff": max(r["replay_max_diff"] for r in reps),
               "recovery_wall_s": [r["recovery_wall_s"] for r in reps],
               "peak_mem_gib": [r["peak_mem_gib"] for r in reps]}
        if kind == "pod":
            res["rejoin"] = [r["rejoin"] for r in reps]
            res["rejoin_ms"] = [r["rejoin_ms"] for r in reps]
        out[kind] = res
        log(f"  ranks drill {kind}: seconds per rank "
            f"{[round(x, 2) for x in res['seconds']]}, fleet step ms per "
            f"rank {[[round(x, 1) for x in y] for y in res['fleet_ms']]}, "
            f"own step ms {[[round(x, 1) for x in y] for y in res['rank_ms']]}"
            f", wire per rank {json.dumps(res['wire'])}, steps lost "
            f"{res['steps_lost']}, replay diff {res['replay_max_diff']:.3e}"
            f"; on {card}")
    return out


def release() -> None:
    """Free what a phase left on the card before the next one measures its
    peak: reference cycles first (the serve phase's spied method, a
    serving loop's programs with their graphs and pools, a trainer's
    closures), then the allocator's cache."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def card_memory() -> dict:
    """What the allocator holds after ``release()``: allocated and
    reserved GiB, and the graph pools' share of each (segments outside
    the default pool, from ``torch.cuda.memory_snapshot()``)."""
    import torch
    release()
    pools = [g for g in torch.cuda.memory_snapshot()
             if tuple(g.get("segment_pool_id", (0, 0))) != (0, 0)]
    return {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "pool_segments": len(pools),
            "pool_reserved_gib": sum(g["total_size"] for g in pools) / 2**30,
            "pool_allocated_gib": sum(g["allocated_size"]
                                      for g in pools) / 2**30}


def wall_ms(fn, n: int) -> float:
    """Mean wall ms of ``fn`` (host and device: synchronized), after
    one untimed call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile(fn, n: int) -> dict:
    """Device busy share and top kernels of ``n`` calls of ``fn`` under
    ``torch.profiler`` (its host-side instrumentation inflates the wall,
    so the share is a lower bound).  Device fields are None when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev: dict[str, float] = {}
    for name, us in device_events(prof):
        dev[name] = dev.get(name, 0.0) + us
    busy_ms = sum(dev.values()) / 1e3 / n
    # the copies PERF.md counts: device-to-device copies and the index
    # kernels (gathers, scatters, index_put) of the executor's writes
    copies = sum(us for name, us in dev.items()
                 if "Memcpy" in name or "index" in name.lower()) / 1e3 / n
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    attn = {k: sum(us for name, us in dev.items() if k in name) / 1e3 / n
            for k in ATTN_KERNELS}
    gemm = sum(us for name, us in dev.items()
               if any(g in name.lower() for g in GEMM_NAMES)) / 1e3 / n
    return {"wall_ms": wall * 1e3 / n,
            "device_ms": busy_ms if dev else None,
            "busy_share": busy_ms / (wall * 1e3 / n) if dev else None,
            "copies_ms": copies if dev else None,
            "gemm_ms": gemm if dev else None,
            "attention_kernels_ms": {k: v for k, v in attn.items() if v},
            "top_ms": [[name[:70], us / 1e3 / n] for name, us in top]}


# cuBLAS's and CUTLASS's GEMM kernels, by name (the products of the
# layers, the head and their gradients)
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


# the device functions of kernels 1-6 (the decode variant's split and
# merge launches are kernel 2 too)
ATTN_KERNELS = ("fused_fwd_kernel", "tiled_kernel", "decode_kernel",
                "merge_kernel", "fused_dq_kernel", "fused_dkv_kernel",
                "bwd_dq_kernel", "bwd_dkv_kernel")


SASS_LIBS = ("flash_attention_fwd", "fused_flash_fwd", "fused_flash_bwd_dq",
             "fused_flash_bwd_dkv", "flash_attention_bwd")


def sass_mma_counts(build) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) and FFMA per kernel in the
    SASS (``cuobjdump -sass``) of the libraries of kernels 1-6."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    counts: dict[str, dict] = {}
    for lib in SASS_LIBS:
        out = subprocess.run(
            [tool, "-sass", str(build.BUILD_DIR / f"lib{lib}.so")],
            capture_output=True, text=True, check=True, timeout=120).stdout
        fn = None
        for line in out.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
            elif fn is not None:
                for op in counts[fn]:
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
    return counts


# An FFMA dot-product loop over D = 64 needs at least D FFMA for each
# product it forms (the f32-FMA loops kernels 3 and 4 once had unrolled
# to 768 and 512); the tile bodies on the tensor cores keep FFMA for the
# exponent (one per score element a lane holds) and stay well under this.
MAX_FFMA_NO_DOT_LOOP = 4 * 64


def check_tensor_cores(counts: dict) -> None:
    """The bf16 D = 16, 64, 80 and 128 builds of kernel 1, kernel 2's tiled
    variant and kernels 3-6 must hold HMMA or HGMMA instructions; those of
    kernels 3 and 4 fewer than MAX_FFMA_NO_DOT_LOOP FFMA (no dot-product
    loop on the CUDA cores: the exponent's FFMA per score element a lane
    holds do not grow with D)."""
    for prefix in ("tiled_kernel", "fused_fwd_kernel", "fused_dq_kernel",
                   "fused_dkv_kernel", "bwd_dq_kernel", "bwd_dkv_kernel"):
        for d in (16, 64, 80, 128):
            hits = [c for fn, c in counts.items() if prefix in fn
                    and "__nv_bfloat16" in fn and f"Li{d}E" in fn]
            if not hits or not all(c["HMMA"] + c["HGMMA"] > 0 for c in hits):
                raise AssertionError(f"no tensor-core instructions in the "
                                     f"bf16 D={d} build of {prefix}: {hits}")
            if prefix.startswith("fused_d") and not all(
                    c["FFMA"] < MAX_FFMA_NO_DOT_LOOP for c in hits):
                raise AssertionError(f"{prefix}: bf16 D={d} build holds "
                                     f"{hits} FFMA, an FFMA dot-product loop")


# what ``--phases`` may name (the build always runs)
PHASES = ("kernels", "serve", "train", "rest", "pods", "multimodal", "llama",
          "ranks")


def parse_phases(argv) -> tuple:
    """``--phases a,b`` runs only those phases, a development aid: only a
    run of every phase (the default) prints the kernels line and the
    last line."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ", ".join(PHASES))
    names = tuple(p.parse_args(argv).phases.split(","))
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}")
    return names


def main() -> int:
    phases = parse_phases(sys.argv[1:])
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import (ParallelConfig, ServeConfig,
                                          get_config)
    from repro_torch.core import executor as ex
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as servelib
    from repro_torch.launch import train as trainlib
    from repro_torch.masks import CAUSAL, FULL, chunked, sliding_window
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # the build is made and timed here from the checkout's sources,
    # whatever an earlier run left in build/kernels
    build.STAMP.unlink(missing_ok=True)
    secs = build.LIBRARIES.build()
    log(f"phase build: ok {secs:.2f}s (each source's nvcc: " + ", ".join(
        f"{n} {t:.1f}s" for n, t in build.LIBRARIES.source_seconds.items())
        + ")")
    for name, out in build.LIBRARIES.build_log.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")
    sass = sass_mma_counts(build)
    for fn, c in sass.items():
        log(f"  sass {fn}: {json.dumps(c)}")
    check_tensor_cores(sass)

    masks = (CAUSAL, sliding_window(96), chunked(96), FULL)
    if "kernels" in phases:
        t0 = time.perf_counter()
        small_flash_cases(fa, masks, dev)
        small_fused_cases(fa, masks, dev)
        small_bwd_fused_cases(fa, masks, dev)
        small_bwd_flash_cases(fa, masks, dev)
        log(f"phase kernels (small shapes): ok "
            f"{time.perf_counter() - t0:.2f}s")
    cfg = get_config("stablelm_1_6b")
    cfg_moe = get_config(MOE_ARCH)
    cfg128 = get_config(D128_ARCH)
    cfg_z = get_config(HYBRID_ARCH)
    cfg_vl = get_config(VLM_ARCH)
    pcfg = ParallelConfig(block_size=512, in_dtype_bytes=2)
    # every kernel at the main paths' shapes of each model: StableLM (32
    # heads of 64), Granite (24 of 64 over 8 kv heads: GQA group 3),
    # Moonlight (16 of 128), Zamba2's shared block (32 of 80), InternVL2
    # (14 of 64 over 2 kv heads: GQA group 7) and llama3-70b (64 of 128
    # over 8 kv heads: GQA group 8)
    t0 = time.perf_counter()
    rows = []
    paths = tuple((p, c) for p, c in (
        ("stablelm", cfg), ("granite", cfg_moe), ("moonshot", cfg128),
        ("zamba2", cfg_z), ("internvl2", cfg_vl),
        ("llama3", get_config(LLAMA_ARCH)))
        if "kernels" in phases or (p == "llama3" and "llama" in phases))
    for path, c in paths:
        new = timed(f"main-path rows {path}", lambda: [
            main_path_fused(fa, ex, servelib, c, pcfg, dev),
            main_path_decode(fa, c, dev),
            *main_path_bwd(fa, ex, trainlib, c, pcfg, dev)])
        for r in new:
            r["path"] = path
        rows += new
        release()
    for r in rows:
        wrapper = "".join(f" {x}={r[x]:.4f}" for x in (
            "wrapper_ms", "tiled_variant_ms", "decode_variant_ms") if x in r)
        log(f"phase kernels {r['name']} [{r['shape']}]: ok "
            f"ms={r['ms']:.4f}{wrapper} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, "
            f"{r['flops']:.3e} flop, {r['bytes']:.3e} B) "
            f"library_ms={r['library_ms']} max_abs_err="
            f"{r['max_abs_err']:.3e}" + (
                f" o_scale_bias={r['o_scale_bias']:.3e}"
                if "o_scale_bias" in r else ""))
        if "library" in r:
            log(f"  library: {r['library']}")
    # the backward kernels' rates side by side: counted flop (valid pairs
    # only) over each kernel's time, the fused run (3, 4) beside the
    # per-step block (5, 6)
    for path, _ in paths:
        log(f"phase kernels counted TFLOP/s ({path}): " + ", ".join(
            f"{r['name']} {r['flops'] / r['ms'] / 1e9:.1f}" for r in rows
            if "bwd" in r["name"] and r["path"] == path))
    release()
    log(f"phase kernels (main-path shapes): ok "
        f"{time.perf_counter() - t0:.2f}s")

    scfg = ServeConfig(cache_len=4096, decode_slots=8, queue_depth=64,
                       max_new_tokens=32, prefill_tokens_per_worker=2048,
                       bucket_min=64)
    served, trained = {}, {}
    t_phase = time.perf_counter()
    for tag, c, depth, why in (
            ("stablelm", cfg, None, None),
            ("granite", cfg_moe, MOE_LAYERS, MOE_WHY),
            ("moonshot", cfg128, D128_SERVE_LAYERS, D128_WHY),
            ("zamba2", cfg_z, HYBRID_SERVE_LAYERS, HYBRID_WHY),
            ("mamba2", get_config(SSM_ARCH), SSM_SERVE_LAYERS, SSM_WHY)):
        if "serve" not in phases:
            break
        t0 = time.perf_counter()
        cut = c.replace(n_layers=depth or c.n_layers)
        n_req = HYBRID_SERVE_REQUESTS if tag == "zamba2" else 16
        served[tag] = serve(fa, cut, pcfg, scfg, dev, n_req=n_req,
                            eager=tag == "stablelm")
        if depth is not None:
            served[tag]["depth_cut"] = f"{depth} of {c.n_layers} layers: {why}"
        if tag == "zamba2":
            served[tag]["requests_cut"] = (f"{n_req} requests: "
                                           f"{HYBRID_REQUESTS_WHY}")
            release()           # the served loop's graphs and their pools
            served[tag]["tokens_kernels_vs_plain"] = serve_tokens(
                fa, cut, pcfg, scfg, dev)
        log(f"phase serve {tag}: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(served[tag])}")
        release()
    if "serve" in phases:
        log(f"phase serve: ok {time.perf_counter() - t_phase:.2f}s")

    tr = None
    if "train" in phases:
        t_phase = t0 = time.perf_counter()
        tr = train(fa, trainlib, dev)
        log(f"phase train stablelm: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(tr)}")
        trained["stablelm"] = tr
        t0 = time.perf_counter()
        trained["granite"] = {"grad_check_4_layers_f32": train_grad_check(
            trainlib, dev, model_argv(MOE_ARCH, None, 3))}
        release()
        trained["granite"].update(train_model(
            fa, trainlib, dev, MOE_ARCH, 3, MOE_LAYERS, MOE_WHY))
        trained["granite"]["moe_breakdown"] = moe_breakdown(
            dev, MOE_ARCH, trained["granite"]["n_layers"])
        log(f"phase train granite: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(trained['granite'])}")
        t0 = time.perf_counter()
        trained["moonshot"] = train_model(
            fa, trainlib, dev, D128_ARCH, 2, D128_TRAIN_LAYERS, D128_WHY)
        log(f"phase train moonshot: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(trained['moonshot'])}")
        t0 = time.perf_counter()
        trained["zamba2"] = {
            f"grad_check_{HYBRID_GRAD_LAYERS}_layers_f32": train_grad_check(
                trainlib, dev, model_argv(HYBRID_ARCH, None, 3),
                HYBRID_GRAD_LAYERS)}
        release()
        trained["zamba2"].update(train_model(
            fa, trainlib, dev, HYBRID_ARCH, 3, HYBRID_TRAIN_LAYERS,
            HYBRID_TRAIN_WHY))
        trained["zamba2"]["ssm_breakdown"] = ssm_breakdown(
            dev, HYBRID_ARCH, HYBRID_TRAIN_LAYERS,
            served.get("zamba2", {}).get("first_batch_bucket", 2048))
        log(f"phase train zamba2: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(trained['zamba2'])}")
        log(f"phase train: ok {time.perf_counter() - t_phase:.2f}s")
        log(f"  card memory: {json.dumps(card_memory())}")

    # phase 5: the rest of the training path, beside the plain fused
    # step of the train phase (same call, same card)
    plain = tr["profile_step"] if tr else {}
    if tr:
        log(f"phase plain fused step (train phase): step_ms {tr['step_ms']} "
            f"device_ms {plain['device_ms']} wall_ms {plain['wall_ms']} "
            f"copies_ms {plain['copies_ms']} gemm_ms {plain['gemm_ms']} "
            f"peak_mem_gib {tr['peak_mem_gib']}")
    if "rest" in phases:
        t_phase = t0 = time.perf_counter()
        ov = overlap_phase(fa, ex, trainlib, dev)
        log(f"phase overlap: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(ov)}")
        t0 = time.perf_counter()
        lp = layer_pipeline_phase(fa, trainlib, dev)
        for tag, r in lp.items():
            log(f"  {tag}: step_ms {r['step_ms']} tokens_per_s "
                f"{r['tokens_per_s']:.1f} device_ms "
                f"{r['profile_step']['device_ms']} copies_ms "
                f"{r['profile_step']['copies_ms']} peak_mem_gib "
                f"{r['peak_mem_gib']:.2f} (plain: device_ms "
                f"{plain.get('device_ms')} copies_ms "
                f"{plain.get('copies_ms')} tokens_per_s "
                f"{tr and tr['tokens_per_s']} peak_mem_gib "
                f"{tr and tr['peak_mem_gib']})")
        log(f"phase layer pipeline: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(lp)}")
        t0 = time.perf_counter()
        sv = supervisor_phase(fa, trainlib, dev)
        log(f"  supervisor step_ms {sv['cli_default']['step_ms']} (plain "
            f"loop {tr and tr['step_ms']}); checkpoint round trip "
            f"{json.dumps(sv['checkpoint_round_trip'])}")
        log(f"phase supervisor: ok {time.perf_counter() - t0:.2f}s "
            f"{json.dumps(sv)}")
        log(f"phase rest of the training path: ok "
            f"{time.perf_counter() - t_phase:.2f}s")
        log(f"  card memory: {json.dumps(card_memory())}")

    # phase 6: pod meshes, beside the plain step of the train phase and
    # the 4x2 serving of phase 3 (same call, same card)
    if "pods" in phases:
        t0 = time.perf_counter()
        pods, pod_rows = pod_phase(fa, ex, trainlib, dev, cfg, pcfg)
        pt, ps = pods["train"], pods["serve"]["full_depth_bf16"]
        s4 = served.get("stablelm", {})
        log(f"  pod step (2x4x1, 16384 tokens): step_ms {pt['step_ms']} "
            f"tokens_per_s {pt['tokens_per_s']:.1f} device_ms "
            f"{pt['profile_step']['device_ms']} window_ms "
            f"{pt['profile_step']['wall_ms']} attention_kernels_ms "
            f"{sum(pt['profile_step']['attention_kernels_ms'].values()):.1f}"
            f" peak_mem_gib {pt['peak_mem_gib']:.2f} (plain 4x1 step: "
            f"step_ms {tr and tr['step_ms']} tokens_per_s "
            f"{tr and tr['tokens_per_s']} device_ms {plain.get('device_ms')}"
            f" peak_mem_gib {tr and tr['peak_mem_gib']})")
        log(f"  pod serving (2x2x2, {ps['prefill_impl']} prefill): prefill "
            f"p50 {ps['prefill_ms_p50']:.1f} ms decode_step_ms "
            f"{ps['decode_step_ms']:.1f} tok/s {ps['sustained_tok_s']:.1f} "
            f"(4x2 fcp prefill p50 {s4.get('prefill_ms_p50')} ms "
            f"decode_step_ms {s4.get('decode_step_ms')} tok/s "
            f"{s4.get('sustained_tok_s')})")
        for r in pod_rows:
            r["path"] = "stablelm pods"
        # the pod mesh decodes at the 4x2 mesh's shapes (8 slots x 2 cache
        # shards of 4096): the stablelm decode row, counted on the pod run
        pod_rows += [{**r, "path": "stablelm pods"} for r in rows
                     if r["path"] == "stablelm"
                     and r["name"] == "flash_attention_fwd"
                     and r["phase"] == "serve"]
        for r in pod_rows:
            log(f"phase pods kernels {r['name']} [{r['shape']}]: ok "
                f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']} max_abs_err="
                f"{r['max_abs_err']:.3e}")
            if "library" in r:
                log(f"  library: {r['library']}")
        rows += pod_rows
        log(f"phase pods: ok {time.perf_counter() - t0:.2f}s on {card}")
        log(f"  card memory: {json.dumps(card_memory())}")

    # phase 7: the vision-language and audio families at full width, head
    # dim 16 (internvl2's smoke config), the baseline CP policies
    if "multimodal" in phases:
        t0 = time.perf_counter()
        mm_served, mm_trained = multimodal_phase(fa, trainlib, dev, pcfg,
                                                 scfg)
        served.update(mm_served)
        trained.update(mm_trained)
        for tag in mm_trained:
            t_, s_ = mm_trained[tag], mm_served[tag]
            log(f"  {tag}: serve tok/s {s_['sustained_tok_s']:.1f} prefill "
                f"p50 {s_['prefill_ms_p50']:.1f} ms decode_step_ms "
                f"{s_['decode_step_ms']:.1f} f32 logits err "
                f"{s_['prefill_logits_err']['f32']:.3e}; train step_ms "
                f"{t_['step_ms']} tokens_per_s {t_['tokens_per_s']:.1f} "
                f"device_ms {t_['profile_step']['device_ms']} peak_mem_gib "
                f"{t_['peak_mem_gib']:.2f} breakdown "
                f"{json.dumps(t_['breakdown'])}")
        t1 = time.perf_counter()
        d16 = d16_phase(fa, trainlib, dev)
        log(f"phase d16 ({VLM_ARCH} smoke, head dim 16): ok "
            f"{time.perf_counter() - t1:.2f}s {json.dumps(d16)}")
        t1 = time.perf_counter()
        pol = policies_phase(fa, ex, trainlib, dev, cfg, pcfg)
        for name in ("fcp",) + POLICIES:
            log(f"  policy {name}: attention fwd+bwd device ms "
                f"{pol[name]['attention_fwd_bwd_device_ms']:.3f} (fcp "
                f"{pol['fcp']['attention_fwd_bwd_device_ms']:.3f}) rounds "
                f"{pol[name]['n_rounds']} steps {pol[name]['n_steps']} fwd "
                f"err {pol[name]['fwd_err']:.3e}")
        log(f"phase policies: ok {time.perf_counter() - t1:.2f}s "
            f"{json.dumps(pol)}")
        log(f"phase multimodal: ok {time.perf_counter() - t0:.2f}s on {card}")
        log(f"  card memory: {json.dumps(card_memory())}")

    # phase 8: llama3-70b, the remat policies, the quantized wires
    if "llama" in phases:
        t0 = time.perf_counter()
        served["llama3"], trained["llama3"], extra = llama_phase(
            fa, ex, trainlib, dev, pcfg, scfg, tr and step_summary(tr))
        lt = trained["llama3"]
        for policy in ("dots", "nothing"):
            r = step_summary(lt[policy]) if policy == "dots" else lt[policy]
            log(f"  remat {policy}: llama3 ({LLAMA_TRAIN_LAYERS} layers) "
                f"{json.dumps(r)}; stablelm "
                f"{json.dumps(extra['stablelm_remat'][policy])}")
        log(f"phase llama3: ok {time.perf_counter() - t0:.2f}s on {card}")
        log(f"  card memory: {json.dumps(card_memory())}")

    # phase 9: FCP across processes (two gloo ranks on the card, and a
    # one-rank NCCL group)
    ranked = None
    if "ranks" in phases:
        t0 = time.perf_counter()
        ranked = ranks_phase(fa, trainlib, dev, card)
        log(f"phase ranks: ok {time.perf_counter() - t0:.2f}s on {card} "
            f"{json.dumps(ranked)}")
        log(f"  card memory: {json.dumps(card_memory())}")

    # the serving loop's programs against its eager methods, every served
    # configuration side by side
    pod_served = ([("stablelm pods 2x2x2", pods["serve"]["full_depth_bf16"])]
                  if "pods" in phases else [])
    for tag, r in list(served.items()) + pod_served:
        log(programs_line(tag, r, card))

    log(f"chip_smoke phases {','.join(phases)}: ok "
        f"{time.perf_counter() - t_start:.2f}s")
    if set(phases) != set(PHASES):
        log("chip_smoke: a partial run (--phases) prints no kernels line "
            "and no result line")
        return 0
    pt, ps = pods["train"], pods["serve"]["full_depth_bf16"]

    # launches: each kernel's count over the main path that runs it (the
    # row's phase) of the model whose shapes it was timed at (the row's
    # path): the serve run for the forward kernels at prefill and decode,
    # the fused CLI train run for kernels 3 and 4, the pallas CLI train
    # step for kernel 2 at the training block and kernels 5 and 6
    counts = {(p, "serve"): served[p]["launches"] for p in served}
    counts.update({(p, "train"): trained[p]["launches_steps"]
                   for p in trained})
    counts.update({(p, "pallas"): trained[p]["pallas_step"]["launches"]
                   for p in trained})
    counts.update({("stablelm pods", "train"): pt["launches_steps"],
                   ("stablelm pods", "pallas"):
                       pt["pallas_step_4_layers"]["launches"],
                   ("stablelm pods", "serve"): ps["launches"]})
    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/flash_attention.py:"
    sources = {"fused_flash_fwd": (csrc + "fused_flash_fwd.cu", ref + "463"),
               "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                       ref + "126"),
               "fused_flash_bwd_dq": (csrc + "fused_flash_bwd_dq.cu",
                                      ref + "581"),
               "fused_flash_bwd_dkv": (csrc + "fused_flash_bwd_dkv.cu",
                                       ref + "708"),
               "flash_attention_bwd_dq": (csrc + "flash_attention_bwd.cu",
                                          ref + "264"),
               "flash_attention_bwd_dkv": (csrc + "flash_attention_bwd.cu",
                                           ref + "289")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # one entry per kernel: its first row (stablelm; kernel 2 at decode) at
    # the top, every row (the D = 128 ones too) under "shapes"
    kernels, seen = [], {}
    for r in rows:
        n = counts[r["path"], r["phase"]][r["name"]]
        if n <= 0:
            raise AssertionError(f"{r['name']} never launched on the "
                                 f"{r['path']} {r['phase']} path")
        entry = {"shape": r["shape"], "path": f"{r['path']} {r['phase']}",
                 "launches": n, **{x: r[x] for x in keys}}
        if r["name"] not in seen:
            src, rep = sources[r["name"]]
            seen[r["name"]] = {"name": r["name"], "route": "cuda",
                               "source": src, "replaces": rep, **entry,
                               "shapes": []}
            kernels.append(seen[r["name"]])
        seen[r["name"]]["shapes"].append(entry)
    # the ranked paths' own counts: each rank's launches over each run
    # that runs the kernel (training fused or pallas, the serving runs)
    ranked_runs = {"train " + t: ranked[t]
                   for t in ("fused", RANKS_BOTH, "pallas")}
    ranked_runs.update({"serve " + t: ranked["serve"][t] for t in (
        *SERVE_RANKS, "overlap", "nccl_one_rank_long")})
    ranked_runs.update({"drill " + t: ranked["drills"][t]
                        for t in ("kill", "pod")})
    for k in kernels:
        k["launches_ranks"] = {tag: [x[k["name"]] for x in r["launches"]]
                               for tag, r in ranked_runs.items()
                               if k["name"] in r["launches"][0]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
