"""FCP on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``repro``'s module paths.  The host layer (masks,
blocks, cost model, distributor, planner, schedule, verifier, plan
cache, configs) is a numpy-only copy of the reference, so both packages
plan byte-identical schedules.  The device layer is PyTorch, and the two
attention kernels the serving path runs are hand-written CUDA C++ for
Hopper (``kernels/csrc``).  Nothing here imports JAX or ``repro``.

On one card the N context-parallel workers of a plan are *stacked* on a
leading tensor dimension, and a ppermute becomes an index gather
(``runtime/wire.ship``).

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise instead of running on the CPU (:func:`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default)
    raises when no CUDA device is present, and ``"cuda:N"`` when card N
    is not — the port never falls back to the CPU or another card on
    its own; callers that want the CPU (the tests) say so with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(
            f"no CUDA device {dev} (this machine has "
            f"{torch.cuda.device_count()})")
    return dev
