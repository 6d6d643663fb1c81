"""Assemble the roofline section and the before/after pairs from the dry
run's records -- the port of ``repro.launch.report``, over the port's
records and mesh tags (``32x8``: one HGX H100 node's 8 cards a model
group, 32 data groups).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report [--dir runs/dryrun_torch] > /tmp/sections.md
"""
from __future__ import annotations

import argparse
import json
import os

from .dryrun import PRODUCTION, mesh_tag
from .roofline import (H100, analyze, collective_s, load_records,
                       markdown_table, what_moves_it)

MESH = mesh_tag(PRODUCTION, False)


def perf_pairs(records: list, baselines_dir: str, mesh: str = MESH,
               peaks: dict = H100) -> str:
    """Before/after rows of the hill-climbed variants on ``mesh``: the
    ``-opt`` archs against their bases, EP-only against EP x FSDP (a
    record tagged ``<mesh>_epONLY``), and archived baselines
    (``baselines_dir``, recorded before a change) as ``<arch>@base``."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in records if r.get("ok")}
    if baselines_dir and os.path.isdir(baselines_dir):
        for f in sorted(os.listdir(baselines_dir)):
            with open(os.path.join(baselines_dir, f)) as fh:
                r = json.load(fh)
            if r.get("ok"):
                by[(r["arch"] + "@base", r["shape"], r["mesh"])] = r

    pairs = [
        ("bfs-rmat rmat_weak: baseline -> opt (iter 1+2)",
         ("bfs-rmat", "rmat_weak", mesh), ("bfs-rmat-opt", "rmat_weak", mesh)),
        ("bfs-rmat rmat_weak: opt -> opt2 (iter 3, static slots)",
         ("bfs-rmat-opt", "rmat_weak", mesh), ("bfs-rmat-opt2", "rmat_weak", mesh)),
        ("kimi train_4k: EP-only -> EPxFSDP",
         ("kimi-k2-1t-a32b", "train_4k", mesh + "_epONLY"), ("kimi-k2-1t-a32b", "train_4k", mesh)),
        ("qwen2-moe prefill_32k: full-logits -> last_only",
         ("qwen2-moe-a2.7b@base", "prefill_32k", mesh), ("qwen2-moe-a2.7b", "prefill_32k", mesh)),
        ("qwen2-moe prefill_32k: last_only -> grouped dispatch",
         ("qwen2-moe-a2.7b", "prefill_32k", mesh), ("qwen2-moe-a2.7b-opt", "prefill_32k", mesh)),
        ("qwen2-moe train_4k: global -> grouped dispatch",
         ("qwen2-moe-a2.7b", "train_4k", mesh), ("qwen2-moe-a2.7b-opt", "train_4k", mesh)),
        ("mace ogb_products: baseline -> opt (pos-only fetch + bf16 msgs)",
         ("mace", "ogb_products", mesh), ("mace-opt", "ogb_products", mesh)),
        ("gemma3 prefill_32k: full-logits -> last_only",
         ("gemma3-1b@base", "prefill_32k", mesh), ("gemma3-1b", "prefill_32k", mesh)),
        ("qwen2.5 prefill_32k: full-logits -> last_only",
         ("qwen2.5-14b@base", "prefill_32k", mesh), ("qwen2.5-14b", "prefill_32k", mesh)),
    ]
    out = ["| transition | FLOPs/dev | HBM bytes/dev | collective bytes/dev | t_coll s | args+temp GB |",
           "|---|---|---|---|---|---|"]

    def row(r):
        m = r.get("memory", {})
        return (r["cost"].get("flops", 0), r["cost"].get("bytes accessed", 0),
                r["collectives"]["total_bytes"], collective_s(r, peaks),
                (m.get("argument_size_in_bytes", 0) + m.get("temp_size_in_bytes", 0)) / 1e9)

    for title, a_key, b_key in pairs:
        a, b = by.get(a_key), by.get(b_key)
        if not a or not b:
            out.append(f"| {title} | (missing: {'A' if not a else 'B'}) | | | | |")
            continue
        ra, rb = row(a), row(b)

        def cell(i, fmt="{:.3e}"):
            va, vb = ra[i], rb[i]
            imp = f" ({va/vb:.1f}x)" if vb and va and va / vb >= 1.05 else (
                f" ({vb/va:.1f}x worse)" if va and vb / max(va, 1e-30) >= 1.05 else "")
            return fmt.format(va) + " -> " + fmt.format(vb) + imp

        out.append(f"| {title} | {cell(0)} | {cell(1)} | {cell(2)} | "
                   f"{cell(3)} | {cell(4, '{:.1f}')} |")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun_torch")
    ap.add_argument("--baselines", default="runs/perf_baselines_torch")
    ap.add_argument("--mesh", default=MESH)
    args = ap.parse_args(argv)
    records = load_records(args.dir)
    rows = []
    for rec in records:
        if rec.get("mesh") != args.mesh or "-opt" in rec["arch"]:
            continue
        r = analyze(rec)
        if r:
            rows.append(r)
    print(f"### Roofline — {args.mesh}, per rank, per step ({H100['name']})\n")
    print(markdown_table(rows))
    print("\nDominant-term guidance:\n")
    for r in rows:
        print(f"* `{r['arch']}/{r['shape']}`: **{r['dominant']}** — {what_moves_it(r)}")
    print("\n### before/after\n")
    print(perf_pairs(records, args.baselines, args.mesh))


if __name__ == "__main__":
    main()
