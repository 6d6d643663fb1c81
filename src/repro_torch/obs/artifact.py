"""The ``repro-bench/1`` artifact writer of the port: the copy of
``benchmarks/common.py``'s ``BENCH_SCHEMA`` / ``load_bench`` /
``write_bench`` (that module imports JAX) for schema files only (no
producer of the port writes the reference's pre-schema flat files), with
a ``bench_meta`` that records where the numbers came from on this side:
torch and CUDA versions, the device's name and count.

An artifact is ``{"schema": "repro-bench/1", "meta": {...}, "benchmarks":
{section: payload}}``; :func:`write_bench` merges one section into the file
at ``path`` and keeps the others, so each producer owns its section.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

BENCH_SCHEMA = "repro-bench/1"


def bench_meta(device=None) -> dict:
    """Run metadata stamped on every artifact. ``device`` is where the
    numbers were taken (a ``torch.device`` or its name; default the card
    when one is present, else the CPU)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    on_card = dev.type == "cuda"
    return {
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "numpy_version": np.__version__,
    }


def load_bench(path: str) -> dict:
    """Read a ``repro-bench/1`` artifact (``meta`` and ``benchmarks``
    defaulted to empty); raises ``ValueError`` for any other file."""
    with open(path) as f:
        raw = json.load(f)
    if not (isinstance(raw, dict) and raw.get("schema") == BENCH_SCHEMA):
        raise ValueError(f"{path}: not a {BENCH_SCHEMA} artifact")
    raw.setdefault("meta", {})
    raw.setdefault("benchmarks", {})
    return raw


def write_bench(path: str, section: str, payload: dict,
                device=None) -> dict:
    """Merge one ``section`` into the artifact at ``path`` and rewrite it
    in the shared schema (meta refreshed to this run, for ``device``).
    Sections already present are kept; an unreadable file, or one in
    another format, starts fresh."""
    doc = {"schema": BENCH_SCHEMA, "meta": bench_meta(device),
           "benchmarks": {}}
    if os.path.exists(path):
        try:
            doc["benchmarks"] = load_bench(path)["benchmarks"]
        except (ValueError, OSError):
            pass
    doc["benchmarks"][section] = payload
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc
