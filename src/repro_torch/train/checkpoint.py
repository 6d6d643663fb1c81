"""Checkpointing: atomic, manifest-verified, in the reference package's
on-disk format, so a checkpoint of either package restores in the other.

Layout: ``<dir>/step_<k:08d>/shard_<p>.npz`` (``leaf_<i>`` in flatten
order: dict keys sorted) + ``manifest.json`` written last (the commit
point -- a crashed save never becomes "latest"), holding the leaves'
names (their tree paths), shapes, dtypes and the shard's sha256. Restore
places each leaf as the corresponding leaf of the restoring job's tree
(device and dtype of a tensor). Keeps the newest ``keep`` checkpoints.

A job of ``process_count > 1`` processes (the ranks of a mesh, each with
its own shards) writes ``shard_<p>.npz`` and ``manifest_<p>.json`` per
process; a step is committed when every process's manifest is there.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core.convert import array_to_tensor
from repro_torch.tree import flatten_with_path, unflatten_like


def _host(x) -> np.ndarray:
    """A leaf as a host array; a bfloat16 tensor as its raw 2-byte ``V2``
    form, which is what the reference's ``np.savez`` writes of a bfloat16
    array (``ml_dtypes``), so the file holds the same bytes."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _dtype_name(x: np.ndarray) -> str:
    return "bfloat16" if x.dtype == np.dtype("V2") else str(x.dtype)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _manifest(process_index: int, process_count: int) -> str:
    return ("manifest.json" if process_count == 1
            else f"manifest_{process_index}.json")


def save(ckpt_dir: str, step: int, tree, process_index: int = 0,
         keep: int = 3, process_count: int = 1) -> str:
    """Write one checkpoint (this process's shard of it); returns its
    path. Atomic via manifest-last."""
    flat = flatten_with_path(tree)
    leaves = [_host(x) for _, x in flat]
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=step_dir, suffix=".tmp",
                                     delete=False) as tmp:
        np.savez(tmp, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    shard_path = os.path.join(step_dir, f"shard_{process_index}.npz")
    os.replace(tmp.name, shard_path)
    manifest = {
        "step": step,
        "names": [name for name, _ in flat],
        "shapes": [list(x.shape) for x in leaves],
        "dtypes": [_dtype_name(x) for x in leaves],
        "shards": {str(process_index): {"file": os.path.basename(shard_path),
                                        "sha256": _sha256(shard_path)}},
    }
    mtmp = os.path.join(step_dir, f".manifest_{process_index}.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(                               # commit point
        step_dir, _manifest(process_index, process_count)))
    _gc(ckpt_dir, keep, process_count)
    return step_dir


def _gc(ckpt_dir: str, keep: int, process_count: int = 1):
    steps = sorted(all_steps(ckpt_dir, process_count))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str, process_count: int = 1) -> list:
    """The committed steps: those whose every process's manifest is
    written."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and all(os.path.exists(
                os.path.join(ckpt_dir, name, _manifest(p, process_count)))
                for p in range(process_count)):
            out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str, process_count: int = 1) -> int | None:
    steps = all_steps(ckpt_dir, process_count)
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, step: int | None = None,
            process_index: int = 0, process_count: int = 1):
    """``(step, tree)``: the checkpoint (the latest committed one when
    ``step`` is None) in the structure of ``tree_like``, shapes verified
    against the manifest and the shard against its sha256; a leaf whose
    ``tree_like`` leaf is a tensor comes back as a tensor of its dtype on
    its device, others as numpy arrays."""
    if step is None:
        step = latest_step(ckpt_dir, process_count)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, _manifest(process_index,
                                                process_count))) as f:
        manifest = json.load(f)
    shard_info = manifest["shards"][str(process_index)]
    path = os.path.join(step_dir, shard_info["file"])
    if _sha256(path) != shard_info["sha256"]:
        raise IOError(f"checkpoint corruption: {path}")
    like = [x for _, x in flatten_with_path(tree_like)]
    if len(like) != len(manifest["names"]):
        raise ValueError("checkpoint/model structure mismatch")
    out = []
    with np.load(path) as data:
        for i, ref in enumerate(like):
            arr = data[f"leaf_{i}"]
            want = tuple(ref.shape) if torch.is_tensor(ref) else np.shape(ref)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"shape mismatch for {manifest['names'][i]}: "
                                 f"{arr.shape} vs {tuple(want)}")
            out.append(array_to_tensor(arr).to(device=ref.device, dtype=ref.dtype)
                       if torch.is_tensor(ref) else arr)
    return manifest["step"], unflatten_like(tree_like, out)
