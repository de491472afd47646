"""Sharded, atomic, async checkpointing (port of
``repro.checkpoint.checkpointer`` on PyTorch tensors).

Layout of one checkpoint, the reference's byte for byte:

    <dir>/step_<N>.tmp/            (written first)
        manifest.json              (tree structure, shapes, dtypes)
        arr_<i>.npy                (one file per leaf)
    <dir>/step_<N>/                (atomic rename)
        COMMIT                     (marker written last: crash-safe)

Restore only trusts directories with a COMMIT marker, so a preemption
mid-write can never corrupt resume.  The manifest records a CRC32 per
leaf at save time and ``restore`` re-hashes every array it loads: a
mismatch raises :class:`CheckpointCorruption` (``CheckpointManager``
falls back to the previous committed step).  Manifests without CRCs
restore unchecked.

A tree is nested dicts, lists, tuples and dataclasses (the optimizer's
``AdamWState``) of tensors, numpy arrays or Python scalars.  Leaves are
numbered in the reference's flatten order (dict keys sorted, dataclass
fields in declaration order) and keyed by its key-path strings
(``jax.tree_util.keystr``: ``['params']['layers']['wq']``,
``['opt'].step``), so a checkpoint written by either package restores
in the other.

numpy has no bfloat16 and the card has no ``ml_dtypes``: a bf16 leaf is
written as its 2-byte pattern (``uint16`` on disk, ``"bfloat16"`` in the
manifest) and read back bit for bit; the reference's own bf16 files
(numpy ``V2`` records of the same pattern) read through the same path.
Restored leaves are CPU tensors; the caller moves them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch

BF16 = "bfloat16"


class CheckpointCorruption(RuntimeError):
    """A committed checkpoint failed CRC validation on restore."""


def _children(tree):
    """``[(key-path piece, child), ...]`` of a container in the
    reference's flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [leaf for piece, x in kids for leaf in _flatten(x, prefix + piece)]


def _unflatten(like, leaves):
    """``leaves`` (an iterator in flatten order) into ``like``'s shape."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and the manifest's dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A host copy the file IO can read while training goes on: the
    port's optimizer updates parameters in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        # ours: uint16; the reference's: numpy V2 records
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's C-order bytes (``zlib.crc32(arr.tobytes())``
    without the copy)."""
    return int(zlib.crc32(np.ascontiguousarray(arr).reshape(-1)
                          .view(np.uint8)) & 0xFFFFFFFF)


def save(path: str | pathlib.Path, tree, extra: dict | None = None) -> None:
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = _flatten(tree)
    manifest = {
        "treedef": f"repro_torch tree of {len(leaves)} leaves",
        "n_leaves": len(leaves),
        "extra": extra or {},
        "leaves": [],
    }
    for i, (p, leaf) in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append(
            {"i": i, "path": p, "shape": list(arr.shape), "dtype": dtype,
             "crc32": _crc(arr)})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    for fn in tmp.iterdir():                      # durability before rename
        with open(fn, "rb") as f:
            os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    (path / "COMMIT").touch()


def save_async(path, tree, extra: dict | None = None) -> threading.Thread:
    """Device->host copy happens synchronously, file IO in a background
    thread (overlaps the next train steps)."""
    host_tree = _unflatten(tree, iter([_host_copy(x)
                                       for _, x in _flatten(tree)]))
    th = threading.Thread(target=save, args=(path, host_tree),
                          kwargs={"extra": extra}, daemon=True)
    th.start()
    return th


def is_committed(path: str | pathlib.Path) -> bool:
    return (pathlib.Path(path) / "COMMIT").exists()


def restore(path: str | pathlib.Path, like):
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays; only its structure is read), validating each leaf's CRC32
    when the manifest carries one (raises :class:`CheckpointCorruption`
    on mismatch).  Leaves come back as CPU tensors."""
    path = pathlib.Path(path)
    if not is_committed(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    leaves = []
    for key, _ in _flatten(like):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        rec = by_path[key]
        arr = np.load(path / f"arr_{rec['i']}.npy")
        if "crc32" in rec:
            got = _crc(arr)
            want = int(rec["crc32"])
            if got != want:
                raise CheckpointCorruption(
                    f"leaf {key} of {path} failed CRC32 validation "
                    f"(stored {want:#010x}, read {got:#010x})")
        leaves.append(_from_numpy(arr, rec["dtype"]))
    return _unflatten(like, iter(leaves))


def read_extra(path: str | pathlib.Path) -> dict:
    with open(pathlib.Path(path) / "manifest.json") as f:
        return json.load(f)["extra"]
