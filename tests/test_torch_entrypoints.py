"""The port's own entry points on the CPU, against the reference's: the
``bfs-rmat`` configs, the three BFS examples, the calibration sweep, the
``repro-bench/1`` writer and the port's CI workflow.

* ``repro_torch.configs`` registers ``bfs-rmat``, ``bfs-rmat-opt`` and
  ``bfs-rmat-opt2`` with ``BFS_SHAPES``; every ``BFSConfig`` field equals
  the reference's (but the reference's opt-in ``CommConfig.local_fold``,
  which the port does not carry: its fold is always the kernel).
* ``examples/torch_quickstart.py --device cpu --scale 8`` exits 0 with
  every source ``match=OK``.
* ``examples/torch_bfs_serving.py --device cpu --scale 8 --requests 40
  --mixed --refill --overlap --trace --profile`` (in this process): every
  answer and ``ServeStats`` field equals the reference engine's on the same
  stream and configuration, the trace, metrics and calibration files are
  written, and the artifact's exact counters equal the reference engine's.
* ``examples/torch_distributed_bfs.py --device cpu --mesh 1,2 --scale 9``:
  two gloo ranks give the oracle's levels for every source.
* ``scripts/torch_profile_sweep.run_matrix`` (scale 7, one cell) writes a
  ``repro-bench/1`` artifact (read by both packages' ``load_bench``) whose
  exact leaves equal the reference ``run_matrix``'s on the same arguments.
* ``.github/workflows/torch.yml`` parses and runs the port's tests after
  installing torch.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import base as RCB
from repro.configs import bfs_rmat as RBR
from repro_torch.configs import base as TCB, bfs_rmat as TBR
from repro_torch.obs import artifact as TA

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("sweeps", "sweep_blocks", "wire_delegate_bytes", "wire_nn_bytes",
         "nn_sparse_sweeps", "nn_overflow", "frontier_skew", "wire_skew")
EXAMPLE_TIMEOUT = 300


def load_module(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(*args) -> str:
    """Run a script of the repository in a fresh interpreter with the port
    on its path; returns its output (fails on a non-zero exit)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, *map(str, args)], cwd=ROOT, env=env,
                         capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def config_fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["comm"].pop("local_fold", None)
    return out


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("name,var", [("bfs-rmat", "FULL"),
                                      ("bfs-rmat-opt", "OPT"),
                                      ("bfs-rmat-opt2", "OPT2")])
def test_bfs_rmat_registry_matches_reference(name, var):
    mine, theirs = TCB.get_arch(name), RCB.get_arch(name)
    assert mine.family == theirs.family == "bfs"
    assert mine.shapes == theirs.shapes == RCB.BFS_SHAPES
    assert mine.optimizer == theirs.optimizer
    assert mine.model is getattr(TBR, var)
    for cfg, ref in ((mine.model, theirs.model), (mine.smoke, theirs.smoke)):
        assert type(cfg).__module__ == "repro_torch.core.bfs"
        assert config_fields(cfg) == config_fields(ref)
    assert config_fields(TBR.SMOKE) == config_fields(RBR.SMOKE)
    assert name in TCB.all_archs()


# ------------------------------------------------------------------ examples
def test_quickstart_example_matches_oracle():
    out = run_example("examples/torch_quickstart.py", "--device", "cpu",
                      "--scale", "8")
    lines = [ln for ln in out.splitlines() if "match=" in ln]
    assert len(lines) == 3 and all("match=OK" in ln for ln in lines), out
    assert "x edge-list" in out and "(on the CPU" in out


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The serving example in this process (outputs in a temporary
    directory), and the reference engine on the same stream."""
    from repro.core import msbfs as RM
    from repro.core.comm import CommConfig as RComm
    from repro.graphs.rmat import rmat_graph as ref_rmat
    from repro.obs import DispatchProfiler as RProf
    from repro.obs import Observability as RObs
    from repro.obs import skew as ref_skew
    from repro.serve import BFSServeEngine as RServe
    from repro.serve import Query as RQuery, QueryKind as RKind

    out_dir = tmp_path_factory.mktemp("serving")
    ex = load_module("examples/torch_bfs_serving.py", "torch_bfs_serving")
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        got = ex.main(["--device", "cpu", "--scale", "8", "--requests", "40",
                       "--mixed", "--refill", "--overlap", "--trace",
                       "--profile"])
    finally:
        os.chdir(cwd)
    ref = RServe(ref_rmat(8, seed=0), th=64, p_rank=2, p_gpu=2,
                 cache_capacity=512, refill=True, overlap=True,
                 cfg=RM.MSBFSConfig(telemetry=True),
                 comm=RComm(delegate="auto", nn="dense"), obs=RObs(),
                 profile=RProf(sample_rate=1.0), edge_chunk=0)
    ref.warmup(targets=True, payload=True)
    want = ref.submit_many([RQuery(q.source, RKind(q.kind.value),
                                   max_depth=q.max_depth, targets=q.targets)
                            for q in got["queries"]])
    tel = ref.last_telemetry
    return dict(got=got, dir=out_dir, want=want, stats=ref.stats.as_dict(),
                skews=(ref_skew(tel.shard_frontier()),
                       ref_skew(tel.shard_wire_bytes())))


def test_serving_example_answers_and_stats_match_reference(serving):
    got = serving["got"]
    assert len(got["answers"]) == len(serving["want"]) == 40
    for q, a, b in zip(got["queries"], got["answers"], serving["want"]):
        if isinstance(b, (int, np.integer)):
            assert int(a) == int(b), q
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(q))
    assert got["engine"].stats.as_dict() == serving["stats"]
    assert serving["stats"]["nn_overflow"] == 0


def test_serving_example_artifacts_match_reference(serving):
    d = serving["dir"]
    trace = json.loads((d / "serve_trace.json").read_text())
    assert trace["traceEvents"]
    json.loads((d / "serve_metrics.json").read_text())
    doc = TA.load_bench(str(d / "CALIB_device.json"))
    assert doc["schema"] == TA.BENCH_SCHEMA
    assert doc["meta"]["backend"] == "cpu"
    cell = doc["benchmarks"]["device_calibration"]["cells"]["serving"]
    st = serving["stats"]
    for k in EXACT[:-2]:
        assert cell[k] == st[k], k
    assert (cell["frontier_skew"], cell["wire_skew"]) == pytest.approx(
        serving["skews"], rel=1e-12)
    assert cell["profile"]["sampled"] > 0


def test_distributed_example_matches_oracle():
    out = run_example("examples/torch_distributed_bfs.py", "--device", "cpu",
                      "--mesh", "1,2", "--scale", "9")
    lines = [ln for ln in out.splitlines() if "match=" in ln]
    assert len(lines) == 3 and all("match=OK" in ln for ln in lines), out
    assert all("overflow=0" in ln for ln in lines)
    assert "gloo" in out and "all sources validated" in out


# --------------------------------------------------------- calibration sweep
def test_profile_sweep_artifact_matches_reference(tmp_path):
    from benchmarks.common import BENCH_SCHEMA, load_bench as ref_load_bench

    kw = dict(scale=7, requests=6, n_queries=4, delegates=("auto",),
              nn_formats=("dense",), sweep_blocks=(4,))
    mine = load_module("scripts/torch_profile_sweep.py", "torch_profile_sweep")
    ref = load_module("scripts/profile_sweep.py", "profile_sweep")
    out = str(tmp_path / "CALIB_device.json")
    payload = mine.run_matrix(**kw, device="cpu", out=out)
    want = ref.run_matrix(**kw)
    for doc in (TA.load_bench(out), ref_load_bench(out)):
        assert doc["schema"] == TA.BENCH_SCHEMA == BENCH_SCHEMA
        sec = doc["benchmarks"]["device_calibration"]
        assert sec["graph"] == want["graph"] and sec["graph"]["p"] == 4
        for k in ("requests", "n_queries", "sample_rate"):
            assert sec[k] == want[k]
        (key,) = sec["cells"]
        assert key == "delegate=auto,nn=dense,block=4"
        cell, wcell = sec["cells"][key], want["cells"][key]
        for k in EXACT:
            assert cell[k] == wcell[k], k
        assert cell["sweeps"] > 0 and cell["wire_delegate_bytes"] > 0
        assert cell["profile"]["sampled"] > 0
        assert "block" in cell["profile"]["dispatch_latency_s"]
    assert payload["cells"][key]["sweeps"] == want["cells"][key]["sweeps"]


def test_bench_writer_merges_sections(tmp_path):
    path = str(tmp_path / "a.json")
    TA.write_bench(path, "one", {"x": 1}, device="cpu")
    doc = TA.write_bench(path, "two", {"y": 2}, device="cpu")
    assert doc["benchmarks"] == {"one": {"x": 1}, "two": {"y": 2}}
    assert TA.load_bench(path) == doc
    assert set(doc["meta"]) >= {"backend", "device_kind", "device_count",
                                "torch_version", "cuda_version"}
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"strategies": {"auto": 1}}))
    with pytest.raises(ValueError, match="repro-bench/1"):
        TA.load_bench(str(other))
    doc = TA.write_bench(str(other), "one", {"x": 1}, device="cpu")
    assert doc["benchmarks"] == {"one": {"x": 1}}


NO_CARD_PROBE = r"""
import importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.cuda.is_available = lambda: False
mods = {}
for rel in ("examples/torch_quickstart.py", "examples/torch_bfs_serving.py",
            "examples/torch_distributed_bfs.py",
            "scripts/torch_profile_sweep.py"):
    spec = importlib.util.spec_from_file_location(rel.split("/")[1][:-3], rel)
    mods[rel] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[rel])
for rel, argv in (("examples/torch_quickstart.py", ["--scale", "6"]),
                  ("examples/torch_distributed_bfs.py", ["--scale", "6"])):
    sys.argv = [rel, *argv]
    try:
        mods[rel].main()
    except RuntimeError as e:
        assert "cpu" in str(e), e
    else:
        raise AssertionError(f"{rel} ran without a card")
for call in (lambda: mods["examples/torch_bfs_serving.py"].main(
                 ["--scale", "6", "--requests", "4"]),
             lambda: mods["scripts/torch_profile_sweep.py"].run_matrix(
                 scale=6, requests=2, delegates=("auto",),
                 nn_formats=("dense",), sweep_blocks=(4,))):
    try:
        call()
    except RuntimeError as e:
        assert "cpu" in str(e), e
    else:
        raise AssertionError("ran without a card")
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
                or m == "benchmarks" or m.startswith("benchmarks."))
assert not leaked, leaked
print("ok")
"""


def test_entry_points_import_no_jax_and_refuse_without_a_card():
    """The four entry points import neither JAX nor the reference nor
    ``benchmarks/``, and with the default ``--device cuda`` and no card
    they raise (naming the CPU option) instead of running on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", NO_CARD_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


# ------------------------------------------------------------------------ CI
def test_port_workflow_installs_torch_and_runs_the_port_tests():
    yaml = pytest.importorskip("yaml")
    doc = yaml.safe_load((ROOT / ".github/workflows/torch.yml").read_text())
    assert doc.get("on", doc.get(True)) is not None     # YAML 1.1: on -> True
    (job,) = doc["jobs"].values()
    runs = "\n".join(s.get("run", "") for s in job["steps"])
    assert "requirements-dev.txt" in runs
    assert "pip install torch" in runs and "whl/cpu" in runs
    assert "tests/test_torch_" in runs
    assert "examples/torch_quickstart.py --device cpu" in runs
