"""The H100 roofline (``launch/{dryrun,roofline,report,synth}.py``) on the
CPU.

* ``model_flops_per_device`` equals the reference's for every cell at 256
  and 512 chips, exactly.
* ``analyze``, ``markdown_table``, ``calib_table`` and ``perf_pairs`` give
  the reference's output on the same records when the reference's TPU
  constants are put in (197 TFLOP/s, 819 GB/s, 50 GB/s a link, 16 GB).
* A smoke dry run on a fake world of 4 (a subprocess: it initialises a
  ``fake`` default process group, which the pytest worker never does)
  counts exactly what the real rank 0 of a gloo world of 4 counts on the
  same cells (``_torch_roofline_world.py``): the wire bytes by the model's
  key and by collective kind and mesh axes, the flops by dtype (and their
  total, ``FlopCounterMode``'s over the real step), the bytes accessed
  (the roofline's memory term) and the arguments' bytes.
* One FULL dry run (qwen2.5-14b ``train_4k`` at ``--unroll-layers 2`` on
  the production mesh (32, 8)) finishes with its record's keys present.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _torch_roofline_world as W
from repro.configs import base as RCB
from repro.launch import cells as RC, report as RREP, roofline as RR
from repro_torch.core import comm as TC
from repro_torch.launch import cells as TCL, report as TREP, roofline as TR

# the reference loads its registry only while it is empty
RCB._load_all()

ROOT = Path(__file__).resolve().parents[1]
#: the reference's constants, in the port's form
TPU = {"flops": {"bf16": RR.PEAK_FLOPS}, "hbm": RR.HBM_BW, "ib": RR.LINK_BW,
       "nvlink": RR.LINK_BW, "fits": 16e9}


def start_dryrun(out: Path, *argv) -> subprocess.Popen:
    """``launch.dryrun`` in a process of its own (it initialises a fake
    default process group), started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                             "--out", str(out), *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish(proc: subprocess.Popen) -> None:
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-6000:]


def record(out: Path, arch: str, shape: str, tag: str) -> dict:
    with open(out / f"{arch}__{shape}__{tag}.json") as f:
        return json.load(f)


# --------------------------------------------------------- model flops
@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_equal_the_references(chips):
    for arch, shape, _ in RC.all_cells(include_skipped=True):
        assert TR.model_flops_per_device(arch, shape, chips) == \
            RR.model_flops_per_device(arch, shape, chips), (arch, shape)


# ----------------------------------------------- the reference's records
def ref_records() -> list:
    """Records in the reference's format, numbers drawn from a seed: every
    runnable cell on both meshes, a failed one, and the EP-only probe."""
    rng = np.random.default_rng(0)
    out = []
    for arch, shape, _ in RC.all_cells():
        for mesh in ("16x16", "2x16x16"):
            coll = {k: {"count": int(rng.integers(0, 50)),
                        "operand_bytes": float(rng.integers(0, 10**10)),
                        "result_bytes": 0.0}
                    for k in ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all", "collective-permute")}
            coll["total_bytes"] = sum(v["operand_bytes"] for v in coll.values())
            out.append({"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
                        "cost": {"flops": float(rng.integers(1, 10**15)),
                                 "bytes accessed": float(rng.integers(1, 10**13))},
                        "collectives": coll,
                        "memory": {"argument_size_in_bytes": int(rng.integers(0, 2 * 10**10)),
                                   "temp_size_in_bytes": int(rng.integers(0, 10**10))}})
    ep = dict(next(r for r in out if r["arch"] == "kimi-k2-1t-a32b"
                   and r["shape"] == "train_4k"), mesh="16x16_epONLY")
    out.append(ep)
    out.append({"arch": "gemma3-1b", "shape": "train_4k", "mesh": "16x16",
                "ok": False, "error": "X"})
    return out


def as_ref(row: dict) -> dict:
    row = dict(row)
    row["fits_16g"] = row.pop("fits")
    return row


def test_analyze_and_table_equal_the_references():
    recs = ref_records()
    got = [TR.analyze(r, TPU) for r in recs]
    want = [RR.analyze(r) for r in recs]
    assert [None if g is None else as_ref(g) for g in got] == want
    ok = [g for g in got if g]
    assert TR.markdown_table(ok, TPU) == RR.markdown_table([w for w in want if w])
    assert [TR.what_moves_it(g) for g in ok] == [RR.what_moves_it(w)
                                                 for w in want if w]


def test_calib_table_equals_the_references(tmp_path):
    calib = {"graph": {"scale": 10, "p": 4, "d": 31}, "requests": 64,
             "n_queries": 32, "cells": {
                 "allgather/dense/1": {"qps": 12.5, "wire_delegate_bytes": 100,
                                       "wire_nn_bytes": 7, "nn_sparse_sweeps": 2,
                                       "frontier_skew": 0.25,
                                       "profile": {"dispatch_latency_s": {
                                           "block": {"p50": 1e-3, "p99": 2e-3}}}},
                 "ring/sparse/4": {"qps": 3.0, "profile": {"dispatch_latency_s": {
                     "sweep": {"p50": 4e-3, "p99": 5e-3}}}}}}
    path = tmp_path / "CALIB_device.json"
    path.write_text(json.dumps({"benchmarks": {"device_calibration": calib}}))
    assert TR.load_calibration(str(path)) == RR.load_calibration(str(path))
    assert TR.calib_table(calib) == RR.calib_table(calib)


def test_perf_pairs_equal_the_references(tmp_path):
    recs = ref_records()
    base = dict(next(r for r in recs if r["arch"] == "gemma3-1b"
                     and r["shape"] == "prefill_32k" and r["mesh"] == "16x16"))
    base["cost"] = dict(base["cost"], flops=base["cost"]["flops"] * 3)
    (tmp_path / "b.json").write_text(json.dumps(base))
    assert TREP.perf_pairs(recs, str(tmp_path), "16x16", TPU) == \
        RREP.perf_pairs(recs, str(tmp_path))


# --------------------------------------------- the dry run against a rank
@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """The dry runs, started together beside the gloo world: the smoke
    cells on a fake world of 4 and qwen2.5-14b ``train_4k`` at FULL widths,
    2 layers, on (32, 8)."""
    smoke, full = (tmp_path_factory.mktemp(n) for n in ("smoke", "full"))
    procs = [start_dryrun(smoke, "--smoke", "--mesh", ",".join(map(str, W.SIZES)),
                          *sum((["--cell", c] for c in W.CELLS), [])),
             start_dryrun(full, "--arch", "qwen2.5-14b", "--shape", "train_4k",
                          "--unroll-layers", "2")]
    real = TC.dist.spawn(W.count_world, W.WORLD, (), timeout=300.0)[0]
    for proc in procs:
        finish(proc)
    return {"smoke": smoke, "full": full, "real": real}


@pytest.fixture(scope="module")
def counted(dry_runs):
    """The smoke dry runs and the gloo world's real rank 0 on the same
    cells."""
    tag = "x".join(map(str, W.SIZES))
    return {c: (record(dry_runs["smoke"], *c.split("/"), tag),
                dry_runs["real"][c]) for c in W.CELLS}


@pytest.mark.parametrize("cell", W.CELLS)
def test_dry_run_counts_the_real_ranks_wire(counted, cell):
    dry, real = counted[cell]
    assert dry["ok"], dry.get("traceback")
    assert dry.get("tally", {}) == real.get("tally", {})
    assert dry["collectives"]["by_axes"] == real["collectives"]["by_axes"]
    for kind, v in real["collectives"].items():
        if isinstance(v, dict) and "wire_bytes" in v:
            assert dry["collectives"][kind]["wire_bytes"] == v["wire_bytes"], kind
            assert dry["collectives"][kind]["operand_bytes"] == \
                v["operand_bytes"], kind
    assert dry["collectives"]["total_wire_bytes"] == sum(
        dry.get("tally", {}).values()) or "tally" not in dry
    assert dry["collectives"]["total_wire_bytes"] > 0


@pytest.mark.parametrize("cell", W.CELLS)
def test_dry_run_counts_the_real_ranks_flops_and_arguments(counted, cell):
    dry, real = counted[cell]
    assert dry["cost"]["flops_by_dtype"] == real["cost"]["flops_by_dtype"]
    assert dry["cost"]["flops"] == real["flop_counter"] > 0
    assert dry["memory"]["argument_size_in_bytes"] == \
        real["argument_size_in_bytes"]
    # the memory term's bytes: each operator's inputs and outputs, counted
    # alike on fake and real tensors (a kernel wrapper given fake tensors
    # counts its bound's traffic, its plain version on real ones more)
    assert not dry["kernels"]
    assert dry["cost"]["bytes accessed"] == real["cost"]["bytes accessed"] > 0
    assert dry["memory"]["peak_size_in_bytes"] >= \
        dry["memory"]["argument_size_in_bytes"]


def test_full_dry_run_on_the_production_mesh(dry_runs):
    rec = record(dry_runs["full"], "qwen2.5-14b", "train_4k", "32x8_L2")
    assert rec["ok"], rec.get("traceback")
    assert rec["world"] == 256
    for key in ("cost", "collectives", "memory", "hlo_collective_lines",
                "tally", "host_reads", "kernels"):
        assert key in rec
    assert set(rec["cost"]["flops_by_dtype"]) == {"bf16", "f32"}
    assert set(rec["collectives"]["by_axes"]) >= {"model", "data"}
    assert rec["collectives"]["total_wire_bytes"] == sum(rec["tally"].values())
    assert 0 < len(rec["hlo_collective_lines"]) <= 500
    row = TR.analyze(rec)
    assert row["fits"] and row["t_compute_s"] > 0 and row["t_memory_s"] > 0
