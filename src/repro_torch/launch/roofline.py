"""Roofline analysis over the dry run's records -- the port of
``repro.launch.roofline``, with an NVIDIA H100's constants.

Per (arch x shape x mesh) cell, from one rank's step (``launch.dryrun``):

    compute term    = sum over dtypes of flops / the dtype's peak
    memory term     = bytes accessed / HBM bandwidth
    collective term = wire bytes of each group / its link:
                      NVLink 4 within one node (the ``model`` axis),
                      InfiniBand NDR across nodes (any other axes)

plus MODEL_FLOPS (analytic useful compute, 6·N·D train / 2·N·D inference,
active parameters for MoE) and the useful-compute ratio. The peaks are
the datasheet's for the NVIDIA H100 SXM5 80GB at 700 W (:data:`H100`),
not measurements: ``chip_smoke.py``'s cells phase measures a matmul and a
copy beside them. The LM's float32 scores run on the CUDA cores with TF32
off, at the float32 peak. A record without dtypes or groups (the
reference's) is read as all its flops at the ``bf16`` peak and all its
collective bytes on one link, as the reference reads it.

``--calib CALIB_device.json`` renders the measured prior table from a
``scripts/torch_profile_sweep.py`` artifact's ``device_calibration``
section.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir runs/dryrun_torch]
       [--mesh 32x8] [--shallow] [--calib CALIB_device.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

#: NVIDIA H100 SXM5 80GB (700 W) datasheet peaks: dense tensor-core
#: bfloat16 / float16, float32 on the CUDA cores (TF32 off), the CIN
#: kernels' 3xTF32 (dense TF32 over three products), HBM3, NVLink 4 a
#: direction a card, InfiniBand NDR a card; "fits": the card's memory
H100 = {"name": "NVIDIA H100 SXM5 80GB, 700 W (datasheet)",
        "flops": {"bf16": 989.4e12, "f16": 989.4e12, "f32": 66.9e12,
                  "f64": 66.9e12, "tf32x3": 494.7e12 / 3},
        "hbm": 3.35e12, "nvlink": 450e9, "ib": 50e9, "fits": 80e9}

#: the mesh axes one node's NVLink joins
NODE_AXES = ("model",)


def model_flops_per_device(arch: str, shape: str, n_chips: int) -> float | None:
    """Analytic useful FLOPs per device for one step (None = N/A)."""
    from repro_torch.configs.base import get_arch
    spec = get_arch(arch)
    if spec.family == "lm":
        cfg = spec.model
        n_active = cfg.num_active_params()
        sh = spec.shapes[shape]
        tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode" else 1)
        mult = 6 if sh["kind"] == "train" else 2
        return mult * n_active * tokens / n_chips
    if spec.family == "recsys":
        cfg = spec.model
        f, d = cfg.n_sparse, cfg.embed_dim
        dense = 0
        fk = f
        for h in cfg.cin_layers:
            dense += h * f * fk * d            # CIN einsum per sample
            fk = h
        dims = [f * d] + list(cfg.mlp_layers) + [1]
        dense += sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        sh = spec.shapes[shape]
        b = sh["batch"]
        if sh["kind"] == "retrieval":
            return 2 * b * sh["n_candidates"] * cfg.d_query / n_chips
        mult = 6 if sh["kind"] == "train" else 2
        return mult * dense * b / n_chips
    if spec.family == "gnn":
        sh = spec.shapes[shape]
        cfg = spec.model(sh) if callable(spec.model) else spec.model
        if sh["kind"] == "dist_full":
            n, e = sh["n_nodes"], sh["n_edges"]
        elif sh["kind"] == "minibatch":
            seeds = sh["batch_nodes"]
            f1, f2 = sh["fanouts"]
            n = seeds * (1 + f1 + f1 * f2)
            e = seeds * (f1 + f1 * f2)
        else:
            n = sh["n_nodes"] * sh["batch"]
            e = sh["n_edges"] * sh["batch"]
        name = spec.name
        if name == "gcn-cora":
            h = cfg.d_hidden
            per = 2 * (n * cfg.d_in * h + e * h + n * h * cfg.n_classes + e * cfg.n_classes)
        elif name in ("meshgraphnet", "graphcast"):
            h = cfg.d_hidden
            din = getattr(cfg, "n_vars", getattr(cfg, "d_node_in", h))
            per = 2 * (n * din * h + cfg.n_layers * (e * (3 * h) * h + e * h * h
                                                     + n * (2 * h) * h + n * h * h))
        else:  # mace: A-basis + correlation products
            c = cfg.d_hidden
            per = 2 * cfg.n_layers * (e * 3 * c * 9 + n * c * c * 9 + n * c * 9 * 9 * 2)
        return 3 * per / n_chips     # fwd+bwd ~ 3x fwd
    return None   # bfs: traversal has no useful tensor-core FLOPs


def load_records(run_dir: str) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def n_chips_of(mesh_tag: str) -> int:
    """Ranks of a mesh tag (``"32x8"``, ``"2x32x8_L2"``; the reference's
    ``"16x16"``)."""
    return math.prod(int(s) for s in mesh_tag.split("_")[0].split("x"))


def compute_s(rec: dict, peaks: dict = H100) -> float:
    by = rec["cost"].get("flops_by_dtype")
    if not by:
        return rec["cost"].get("flops", 0.0) / peaks["flops"]["bf16"]
    return sum(n / peaks["flops"].get(k, peaks["flops"]["f32"])
               for k, n in by.items())


def collective_s(rec: dict, peaks: dict = H100) -> float:
    """Wire bytes of each group over its link (NVLink within a node,
    InfiniBand across); a record without groups: operand bytes over the
    slower link."""
    by = rec["collectives"].get("by_axes")
    if by is None:
        return rec["collectives"]["total_bytes"] / peaks["ib"]
    return sum(v["wire_bytes"] / (peaks["nvlink"] if tuple(k.split("+"))
                                  == NODE_AXES else peaks["ib"])
               for k, v in by.items())


def analyze(rec: dict, peaks: dict = H100) -> dict | None:
    if not rec.get("ok"):
        return None
    n_chips = n_chips_of(rec["mesh"])
    flops = rec["cost"].get("flops", 0.0)
    t_c = compute_s(rec, peaks)
    t_m = rec["cost"].get("bytes accessed", 0.0) / peaks["hbm"]
    t_x = collective_s(rec, peaks)
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])[0]
    mf = model_flops_per_device(rec["arch"], rec["shape"], n_chips)
    ratio = (mf / flops) if (mf and flops) else None
    mem = rec.get("memory", {})
    dev_bytes = mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)
    # roofline fraction: useful compute time over the step's bound
    bound = max(t_c, t_m, t_x)
    frac = (mf / peaks["flops"]["bf16"]) / bound if (mf and bound > 0) else None
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh")},
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": dom, "model_flops_ratio": ratio, "roofline_frac": frac,
        "device_bytes": dev_bytes, "fits": dev_bytes <= peaks["fits"],
        "method": "direct",
        "collective_detail": {k: v["operand_bytes"] for k, v in rec["collectives"].items()
                              if isinstance(v, dict) and "operand_bytes" in v},
    }


def what_moves_it(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        r = row.get("model_flops_ratio") or 0
        if r < 0.4:
            return "compute-dominated with low useful ratio: cut remat/recompute or fuse"
        return "compute-bound: increase arithmetic intensity per chip (larger per-device tiles)"
    if d == "memory":
        return "HBM-bound: fuse ops / lower precision / shrink materialized intermediates"
    return "collective-bound: shrink payloads (bit-packing), overlap, or reshard to cut traffic"


def fmt_s(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.3e}"


def markdown_table(rows: list, peaks: dict = H100) -> str:
    cap = f"{peaks['fits'] / 1e9:.0f}G"
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | dominant "
           f"| useful/HLO flops | roofline frac | bytes/dev | fits {cap} |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt_s(r['t_compute_s'])} "
            f"| {fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | {r['dominant']} "
            f"| {fmt_s(r.get('model_flops_ratio'))} | {fmt_s(r.get('roofline_frac'))} "
            f"| {r['device_bytes']/1e9:.2f}G | {'yes' if r['fits'] else 'NO'} |")
    return hdr + "\n".join(lines) + "\n"


def load_calibration(path: str) -> dict:
    """Read a ``torch_profile_sweep.py`` artifact's ``device_calibration``
    section (``repro-bench/1`` schema; raises KeyError if absent)."""
    with open(path) as f:
        doc = json.load(f)
    return doc["benchmarks"]["device_calibration"]


def calib_table(calib: dict) -> str:
    """Markdown table of measured priors per calibration cell: block p50
    latency, throughput, exact wire volume split, and shard skew."""
    g = calib.get("graph", {})
    hdr = (f"measured device calibration (scale={g.get('scale')} "
           f"p={g.get('p')} d={g.get('d')} requests={calib.get('requests')} "
           f"W={calib.get('n_queries')}):\n"
           "| cell | block p50 s | block p99 s | qps | wire delegate B "
           "| wire nn B | sparse sweeps | frontier skew |\n"
           "|---|---|---|---|---|---|---|---|\n")
    lines = []
    for key in sorted(calib.get("cells", {})):
        c = calib["cells"][key]
        lat = c.get("profile", {}).get("dispatch_latency_s", {})
        blk = lat.get("block") or next(iter(lat.values()), {})
        lines.append(
            f"| {key} | {fmt_s(blk.get('p50'))} | {fmt_s(blk.get('p99'))} "
            f"| {c.get('qps', 0):.1f} | {c.get('wire_delegate_bytes', 0)} "
            f"| {c.get('wire_nn_bytes', 0)} | {c.get('nn_sparse_sweeps', 0)} "
            f"| {c.get('frontier_skew', 0):.3f} |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun_torch")
    ap.add_argument("--mesh", default=None,
                    help="only this mesh tag (e.g. 32x8, 2x32x8)")
    ap.add_argument("--shallow", action="store_true",
                    help="include the --unroll-layers runs (mesh tag _L<n>)")
    ap.add_argument("--calib", default=None,
                    help="CALIB_device.json from scripts/torch_profile_sweep.py: "
                         "print the measured-prior table and exit")
    args = ap.parse_args(argv)
    if args.calib:
        print(calib_table(load_calibration(args.calib)))
        return
    rows = []
    failed = []
    for rec in load_records(args.dir):
        if "_L" in rec.get("mesh", "") and not args.shallow:
            continue  # a shallow run's flops are not the model's
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        row = analyze(rec)
        if row is None:
            failed.append((rec["arch"], rec["shape"], rec["mesh"], rec.get("error")))
        else:
            rows.append(row)
    print(f"peaks: {H100['name']}")
    print(markdown_table(rows))
    for r in rows:
        print(f"# {r['arch']}/{r['shape']}/{r['mesh']}: {what_moves_it(r)}")
    if failed:
        print("\n# FAILED CELLS:")
        for f in failed:
            print("#  ", f)


if __name__ == "__main__":
    main()
