"""Parameters of the reference package, as numpy arrays, to the port's
tensors — so both packages can run on the same weights."""

from __future__ import annotations

import numpy as np
import torch

# leaves the reference keeps in f32 whatever ``param_dtype`` is: the MoE
# router (a bf16 router would choose other experts) and the Mamba2 decay,
# skip and step-bias parameters
F32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def params_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None,
                      _name: str | None = None):
    """Map a nested dict of numpy arrays (e.g. ``jax.device_get`` of
    ``repro.models.Model.init``) onto tensors with the same keys and
    layout on ``device``; ``dtype`` casts floating leaves, except those
    named in :data:`F32_LEAVES`, which stay f32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # owned, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(torch.float32 if _name in F32_LEAVES else dtype)
    return t.to(device)
