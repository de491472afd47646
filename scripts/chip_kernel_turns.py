#!/usr/bin/env python3
"""Time the six CUDA kernels of one checkout at their main-path shapes.

Run on the card, once per checkout, alternating the two trees compared
(parent, change, change, parent) within one machine:

    python3 scripts/chip_kernel_turns.py PATH/TO/CHECKOUT

Each run builds that checkout's kernels and calls this repository's
``chip_smoke.main_path_fused`` and ``chip_smoke.main_path_bwd`` on them
(the same measurement code for both trees: every kernel against its
plain version, then timed: 10 launches between CUDA events, median of
21 windows), and prints one line ``TURN {json}`` with the card, each
kernel's ms and kernel 1's o scale bias against plain.
"""

import importlib.util
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from repro_torch.configs.base import ParallelConfig, get_config  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as servelib  # noqa: E402
from repro_torch.launch import train as trainlib  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
build.LIBRARIES.build()
cfg = get_config("stablelm_1_6b")
pcfg = ParallelConfig(block_size=512, in_dtype_bytes=2)
rows = [cs.main_path_fused(fa, ex, servelib, cfg, pcfg, dev),
        *cs.main_path_bwd(fa, ex, trainlib, cfg, pcfg, dev)]
print("TURN", json.dumps({"tree": sys.argv[1], "card": cs.card_line(),
                          "ms": [[r["name"], r["ms"]] for r in rows],
                          "o_scale_bias": rows[0]["o_scale_bias"]}),
      flush=True)
