"""The port's runtime import rule: ``repro_torch`` imports neither JAX nor
any module of the reference package ``repro``; its entry points default
to the card and raise without one."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert sys.modules["jax"] is None
recsys = ["repro_torch.configs.xdeepfm", "repro_torch.models.recsys",
          "repro_torch.data.recsys_data", "repro_torch.kernels.cin_fused",
          "repro_torch.kernels.segment_bag",
          "repro_torch.kernels.ell_pull_payload"]
lm = ["repro_torch.models.lm", "repro_torch.models.attention",
      "repro_torch.models.moe", "repro_torch.data.tokens",
      "repro_torch.launch.train", "repro_torch.configs.gemma3_1b",
      "repro_torch.configs.granite_34b", "repro_torch.configs.kimi_k2_1t_a32b",
      "repro_torch.configs.qwen2_5_14b", "repro_torch.configs.qwen2_moe_a2_7b"]
missing = [m for m in recsys + lm if m not in sys.modules]
assert not missing, missing
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 30      # every module was imported


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    from repro_torch.core import msbfs as TM
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.serve import BFSServeEngine

    g = rmat_graph(6, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BFSServeEngine(g)
    pg = partition_graph(g, th=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_multi_state(pg, [0], TM.MSBFSConfig())
    eng = BFSServeEngine(g, device="cpu")
    assert eng.query_one(int(np.nonzero(g.out_degrees())[0][0])).shape == (g.n,)


def test_recsys_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    from repro_torch.configs.xdeepfm import SMOKE
    from repro_torch.models.recsys import XDeepFM

    with pytest.raises(RuntimeError, match="device='cpu'"):
        XDeepFM(SMOKE)
    hot = np.zeros((2, SMOKE.n_sparse), np.int32)
    logits = XDeepFM(SMOKE, device="cpu")(
        torch.from_numpy(hot), torch.from_numpy(hot - 1))
    assert logits.shape == (2,)


def test_lm_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    from repro_torch.configs.gemma3_1b import SMOKE
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm as TL
    from repro_torch.models.common import materialize

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init_cache(SMOKE, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(TL.lm_param_specs(SMOKE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.run(["--arch", "gemma3-1b", "--smoke", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    params = materialize(TL.lm_param_specs(SMOKE), 0, "cpu")
    logits, cache = TL.prefill(SMOKE, params, torch.zeros((1, 4), dtype=torch.int64), 8)
    assert logits.shape == (1, 4, SMOKE.vocab) and cache[0]["k"].device.type == "cpu"


def test_cell_arguments_raise_without_a_card(monkeypatch):
    """The cells' argument makers and ``sharding.draw_tree`` take the card
    by default: without one they raise; ``device="cpu"`` draws."""
    import types

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import cells, sharding
    from repro_torch.models import lm as TL

    mesh = types.SimpleNamespace(axes=("data", "model"), sizes=(1, 1),
                                 coords=(0, 0), rank=0, p=1,
                                 size=lambda axes=None: 1,
                                 index=lambda axes=None: 0)
    spec = get_arch("gemma3-1b")
    rules = sharding.rules_for(mesh, spec.rules_override)
    cell = cells.lm_serve_cell({"kind": "decode", "global_batch": 2,
                                "seq_len": 16}, spec.smoke, rules, mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cell.args(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.draw_tree(TL.lm_param_specs(spec.smoke), 0, rules,
                           mesh.axes, mesh.sizes)
    params, cache, token, pos = cell.args(0, "cpu")
    assert token.shape == (2,) and pos == 15
    assert cache[0]["k"].shape == (2, 8, 1, 16)
