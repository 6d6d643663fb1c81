"""xDeepFM (CIN + deep MLP + linear) with degree-separated embedding tables.

The port of ``repro.models.recsys``: the paper's technique mapped onto
recsys. Embedding rows are the vertices of the access graph and access
frequency is the degree; rows hotter than a threshold are **delegates**
(``*_hot``, replicated), the rest are **normal** rows (``*_cold``). The
data pipeline splits each sample's indices into ``(hot_idx, cold_idx)``
pairs on the host (:class:`HotColdMap`), so every shape is static.

Parameters keep the reference's names and layouts, so a parameter dict
carries across by name alone (:func:`repro_torch.core.convert.
xdeepfm_params_from_numpy`): ``mlp_w{i}`` is ``[in, out]`` and is applied
as ``x @ W``; ``cin_w{i}`` is ``[H, F0 * Fk]``.

Each CIN layer is one launch of the ``cin_fused`` kernel
(``kernels.ops.cin_fused``); the sum-pool over the embedding dimension
stays outside the kernel, as in the reference. This is the serving
slice: the forward, candidate retrieval and the host data utilities. The
loss and every gradient wait for the training slice, so the parameters
do not require grad and the CUDA kernel refuses inputs that do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.core.bfs import resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_layers: tuple = (400, 400)
    n_hot: int = 1 << 14        # delegate rows (replicated)
    n_cold: int = 1 << 22       # normal rows (sharded in the reference)
    d_query: int = 64           # retrieval-tower output dim
    dtype: torch.dtype = torch.float32


def xdeepfm_param_specs(cfg: XDeepFMConfig) -> dict:
    """``{name: (shape, init)}`` with the reference's names, shapes and
    init kinds (``"normal"``, ``"scaled"``, ``"zeros"``)."""
    d, f = cfg.embed_dim, cfg.n_sparse
    specs = {
        "emb_hot": ((cfg.n_hot, d), "normal"),
        "emb_cold": ((cfg.n_cold, d), "normal"),
        "lin_hot": ((cfg.n_hot, 1), "normal"),
        "lin_cold": ((cfg.n_cold, 1), "normal"),
        "bias": ((1,), "zeros"),
    }
    fk = f
    for i, h in enumerate(cfg.cin_layers):
        specs[f"cin_w{i}"] = ((h, f * fk), "scaled")
        fk = h
    specs["cin_out"] = ((sum(cfg.cin_layers), 1), "scaled")
    dims = [f * d] + list(cfg.mlp_layers) + [1]
    for i in range(len(dims) - 1):
        specs[f"mlp_w{i}"] = ((dims[i], dims[i + 1]), "scaled")
        specs[f"mlp_b{i}"] = ((dims[i + 1],), "zeros")
    # retrieval tower: user fields -> query vector
    specs["q_w0"] = ((f * d, 256), "scaled")
    specs["q_b0"] = ((256,), "zeros")
    specs["q_w1"] = ((256, cfg.d_query), "scaled")
    return specs


def init_params(cfg: XDeepFMConfig, seed: int, device) -> dict:
    """Random parameters as ``repro.models.common.materialize`` draws them:
    ``"normal"`` is N(0, 1) x 0.02, ``"scaled"`` is N(0, 1) / sqrt(shape[-2])
    (for ``cin_w{i}`` that is H, as in the reference), ``"zeros"`` zeros.
    One ``torch.Generator`` on ``device``, seeded with ``seed``, draws the
    leaves in sorted-name order; the bits differ from JAX's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, init) in sorted(xdeepfm_param_specs(cfg).items()):
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=cfg.dtype, device=device)
            continue
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        if init == "scaled":
            x /= float(np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))
        else:
            x *= 0.02
        out[name] = x.to(cfg.dtype)
    return out


def embed_lookup(params: dict, hot_idx: torch.Tensor, cold_idx: torch.Tensor,
                 table: str = "emb") -> torch.Tensor:
    """Two-class lookup: hot rows from the replica, cold rows from the
    normal table. ``hot_idx`` / ``cold_idx`` are ``[B, F]`` with -1 where
    the other class owns the field value -> ``[B, F, D]``. Every index
    must be in range (a CUDA gather faults where ``jnp.take`` fills)."""
    hot_ok = (hot_idx >= 0)[..., None]
    cold_ok = (cold_idx >= 0)[..., None]
    h = params[f"{table}_hot"][hot_idx.clamp(min=0).long()]
    c = params[f"{table}_cold"][cold_idx.clamp(min=0).long()]
    return torch.where(hot_ok, h, 0) + torch.where(cold_ok, c, 0)


def cin_apply(cfg: XDeepFMConfig, params: dict, x0: torch.Tensor,
              cin_op: Callable | None = None) -> torch.Tensor:
    """Compressed Interaction Network: ``[B, 1]`` logit contribution. One
    ``cin_op`` call per layer (default ``ops.cin_fused``)."""
    cin = cin_op or ops.cin_fused
    pooled = []
    xk = x0
    for i in range(len(cfg.cin_layers)):
        xk = cin(x0, xk, params[f"cin_w{i}"])       # [B, H, D]
        pooled.append(xk.sum(-1))                   # sum-pool over embed dim
    feat = torch.cat(pooled, dim=-1)                # [B, sum(H)]
    return feat @ params["cin_out"]


def xdeepfm_logits(cfg: XDeepFMConfig, params: dict, hot_idx: torch.Tensor,
                   cold_idx: torch.Tensor,
                   cin_op: Callable | None = None) -> torch.Tensor:
    """``hot_idx`` / ``cold_idx`` ``[B, F]`` -> logits ``[B]``; ``cin_op``
    as in :func:`cin_apply`. The reference's ``shard`` argument (a sharding
    constraint on ``x0``) has no meaning on one card and is dropped."""
    x0 = embed_lookup(params, hot_idx, cold_idx, "emb")            # [B, F, D]
    b = x0.shape[0]
    lin = embed_lookup(params, hot_idx, cold_idx, "lin")
    logit = lin.sum(dim=(1, 2)) + params["bias"][0]
    logit = logit + cin_apply(cfg, params, x0, cin_op)[:, 0]
    h = x0.reshape(b, -1)
    n_mlp = len(cfg.mlp_layers) + 1
    for i in range(n_mlp):
        h = h @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"]
        if i < n_mlp - 1:
            h = torch.relu(h)
    return logit + h[:, 0]


class XDeepFM(nn.Module):
    """The xDeepFM scoring model on one device.

    ``XDeepFM(cfg, device="cuda", seed=0)`` draws its parameters with
    :func:`init_params`; ``params=`` (a ``{name: tensor}`` dict with the
    reference's names and shapes) takes them as given instead. The device
    defaults to the card and raises without one unless ``device="cpu"``.
    """

    def __init__(self, cfg: XDeepFMConfig, device="cuda", seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        specs = xdeepfm_param_specs(cfg)
        if params is None:
            params = init_params(cfg, seed, dev)
        if sorted(params) != sorted(specs):
            raise ValueError(f"XDeepFM: parameter names {sorted(params)} != "
                             f"{sorted(specs)}")
        for name, (shape, _) in specs.items():
            t = torch.as_tensor(params[name])
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"XDeepFM: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            self.register_parameter(name, nn.Parameter(
                t.to(device=dev, dtype=cfg.dtype).contiguous(),
                requires_grad=False))

    def params(self) -> dict:
        """``{name: tensor}`` under the reference's names."""
        return dict(self.named_parameters())

    def forward(self, hot_idx: torch.Tensor,
                cold_idx: torch.Tensor) -> torch.Tensor:
        return xdeepfm_logits(self.cfg, self.params(), hot_idx, cold_idx)


def retrieval_scores(model: XDeepFM, hot_idx: torch.Tensor,
                     cold_idx: torch.Tensor, candidates: torch.Tensor,
                     top_k: int = 100):
    """Queries ``[B, F]`` against a candidate matrix ``[n_cand, d_query]``;
    returns ``torch.topk``'s (values, indices), each ``[B, top_k]``,
    scores in descending order. Batched dot, not a loop."""
    p = model.params()
    x0 = embed_lookup(p, hot_idx, cold_idx, "emb")
    q = x0.reshape(x0.shape[0], -1)
    q = torch.relu(q @ p["q_w0"] + p["q_b0"]) @ p["q_w1"]          # [B, dq]
    scores = q @ candidates.T                                      # [B, n_cand]
    return torch.topk(scores, top_k)


# ----------------------------------------------------------- data utilities
def make_vocab_sizes(n_fields: int = 39, total: int = 4_000_000,
                     seed: int = 0) -> np.ndarray:
    """Deterministic Criteo-like per-field vocabulary sizes (power law)."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(0.7, n_fields) + 1
    sizes = np.maximum((raw / raw.sum() * total).astype(np.int64), 4)
    return sizes


@dataclass
class HotColdMap:
    """Host-side frequency-delegate split of the concatenated table space."""
    field_offsets: np.ndarray   # [F+1]
    hot_of: np.ndarray          # [V_total] -> hot row id or -1
    cold_of: np.ndarray         # [V_total] -> cold row id or -1
    n_hot: int
    n_cold: int

    @staticmethod
    def build(vocab_sizes: np.ndarray, frequencies: np.ndarray,
              hot_threshold: float):
        """Rows with access frequency > threshold become delegates."""
        offsets = np.concatenate([[0], np.cumsum(vocab_sizes)])
        v = int(offsets[-1])
        hot = frequencies > hot_threshold
        hot_of = np.full(v, -1, np.int64)
        cold_of = np.full(v, -1, np.int64)
        hot_of[hot] = np.arange(hot.sum())
        cold_of[~hot] = np.arange((~hot).sum())
        return HotColdMap(offsets, hot_of, cold_of, int(hot.sum()),
                          int((~hot).sum()))

    def split(self, raw_idx: np.ndarray) -> tuple:
        """Raw per-field indices ``[B, F]`` -> ``(hot_idx, cold_idx)``,
        both ``[B, F]`` int32."""
        flat = raw_idx + self.field_offsets[:-1][None, :]
        return (self.hot_of[flat].astype(np.int32),
                self.cold_of[flat].astype(np.int32))
