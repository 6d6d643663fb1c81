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
stays outside the kernel, as in the reference. Under autograd each layer's
backward is one launch of each of its two backward kernels
(``ops.cin_fused_bwd_w``, ``ops.cin_fused_bwd_x``). :class:`XDeepFM` is
the serving model (its parameters do not require grad);
:func:`xdeepfm_loss` over a parameter dict is what training differentiates
(:mod:`repro_torch.train.recsys`).

Over a mesh the normal rows are row-sharded ``mod q`` over the ``q``
ranks of the axes the ``table_rows`` rule names (:func:`table_axes`;
:data:`COLD_LEAVES`: cold row ``i`` on shard ``i % q`` at local row ``i
// q``; :func:`repro_torch.core.convert.xdeepfm_shard_params`) and looked
up point-to-point (:func:`route_cold`, :func:`cold_rows`), while the hot
rows and the dense leaves stay replicated -- the paper's communication
model, as the reference lays it out by GSPMD (its ``table_rows`` axis).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.core.bfs import resolve_device
from repro_torch.core.comm import dist as D
from repro_torch.kernels import ops


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_layers: tuple = (400, 400)
    n_hot: int = 1 << 14        # delegate rows (replicated)
    n_cold: int = 1 << 22       # normal rows (mod-p sharded over ranks)
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


#: the normal (cold) rows' leaves: row-sharded ``mod p`` over the ranks of
#: a mesh (the reference's ``table_rows`` axis); every other leaf is
#: replicated
COLD_LEAVES = ("emb_cold", "lin_cold")


def cold_shard_rows(n_cold: int, rank: int, p: int) -> int:
    """Rows of rank ``rank``'s cold shard: cold row ``i`` lives on rank ``i
    % p`` at local row ``i // p`` (ragged where ``p`` does not divide
    ``n_cold``)."""
    return (n_cold - rank + p - 1) // p


def xdeepfm_table_bytes(cfg: XDeepFMConfig, rank: int = 0, p: int = 1
                        ) -> dict:
    """Parameter bytes rank ``rank`` of ``p`` holds: its cold shard
    (``emb_cold`` and ``lin_cold`` rows), the replicated hot tables and
    the replicated dense leaves."""
    item = torch.empty((), dtype=cfg.dtype).element_size()
    d = cfg.embed_dim
    dense = sum(int(np.prod(shape)) for name, (shape, _) in
                xdeepfm_param_specs(cfg).items()
                if name not in COLD_LEAVES + ("emb_hot", "lin_hot"))
    return {"cold": cold_shard_rows(cfg.n_cold, rank, p) * (d + 1) * item,
            "hot": cfg.n_hot * (d + 1) * item, "dense": dense * item}


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
    must be in range (a CUDA gather faults where ``jnp.take`` fills).
    The rows are gathered by ``index_select``, whose backward is one
    ``index_add`` into the table's gradient (advanced indexing's backward
    sorts the indices first: 1.0 s of a 1.66 s train step at B = 65,536
    on an H100)."""
    return _two_class(hot_idx, cold_idx,
                      _rows(params[f"{table}_hot"], hot_idx),
                      _rows(params[f"{table}_cold"], cold_idx))


def _two_class(hot_idx: torch.Tensor, cold_idx: torch.Tensor,
               hot: torch.Tensor, cold: torch.Tensor) -> torch.Tensor:
    """The hot rows where ``hot_idx`` is set plus the cold rows where
    ``cold_idx`` is (-1: the other class owns the field)."""
    return (torch.where((hot_idx >= 0)[..., None], hot, 0)
            + torch.where((cold_idx >= 0)[..., None], cold, 0))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t``'s rows at ``idx [B, F]`` (-1 clamped to row 0)."""
    flat = idx.clamp(min=0).reshape(-1).long()
    return t.index_select(0, flat).reshape(*idx.shape, t.shape[-1])


def table_axes(mesh, rules: dict | None = None) -> tuple:
    """The axes of ``mesh`` the cold rows are sharded over: the rule
    override's ``"table_rows"`` (an :class:`~repro_torch.configs.base.
    ArchSpec`'s ``rules_override``; ``"data"`` stands for ``("pod",
    "data")`` on a mesh with a ``"pod"`` axis, as in the reference), by
    default every axis of the mesh (the reference's default rule). Given
    in the mesh's order; a rule naming an axis the mesh lacks is
    refused. The ranks that differ only on the other axes hold the same
    shard (replicas of it)."""
    want = (rules or {}).get("table_rows", mesh.axes)
    want = (want,) if isinstance(want, str) else tuple(want or ())
    if "pod" in mesh.axes:
        want = sum((("pod", "data") if a == "data" else (a,) for a in want),
                   ())
    missing = [a for a in want if a not in mesh.axes]
    if not want or missing:
        raise ValueError(f"table_rows rule {want} must name axes of the "
                         f"mesh {mesh.axes} (lacks {missing})")
    return tuple(a for a in mesh.axes if a in want)


@dataclass
class ColdRoute:
    """One batch's cold lookups routed to their owners over ``mesh``
    (:func:`route_cold`): this rank's valid lookups in owner order, the
    world's per-owner counts, and the local row ids the ranks of this
    rank's shard group (the ranks over the table axes ``axes``) asked
    this rank for. :func:`cold_rows` moves the rows and, under autograd,
    their gradients along it."""

    mesh: object
    #: the mesh axes the cold rows are sharded over (:func:`table_axes`)
    axes: tuple
    #: [n_sent] int64: positions, in this rank's flat ``[B_r * F]``
    #: lookups, of its valid cold ids sorted by owner (stable)
    order: torch.Tensor
    #: [p, q + 1] int64 (host): row ``i`` holds world rank ``i``'s lookup
    #: counts per owner (its shard group's member ``0 .. q - 1``), then
    #: its batch rows
    counts: np.ndarray
    #: [sum(recv)] int64: the local rows the group's ranks ask of this
    #: rank's shard, member ``j``'s block ``j``
    recv_ids: torch.Tensor
    n_lookups: int
    #: bytes the exchanges put on the wire (this rank's sends):
    #: ``"ids"``, ``"rows"``, ``"grads"`` (the backward), ``"counts"``
    sent: dict = field(default_factory=dict)

    @property
    def q(self) -> int:
        """Shards of the cold tables (ranks of a shard group)."""
        return self.mesh.size(self.axes)

    @property
    def shard(self) -> int:
        """This rank's shard: its position in its shard group."""
        return self.mesh.index(self.axes)

    @property
    def send(self) -> list:
        return [int(c) for c in self.counts[self.mesh.rank, :-1]]

    @property
    def recv(self) -> list:
        return [int(c) for c in
                self.counts[self.mesh.members(self.axes), self.shard]]

    @property
    def global_batch(self) -> int:
        return int(self.counts[:, -1].sum())

    def wire_bytes(self, row_bytes: int) -> dict:
        """The exact bytes this rank puts on the wire for the batch, from
        the counts: the ids it asks of the other members of its shard
        group (int32), the rows it returns them and the row gradients it
        returns in the backward (``row_bytes`` each: ``(D + 1) * 4`` in
        float32), the counts it shares with the world; ``"*_padded"``:
        the same exchanges in equal splits padded to the world's largest
        count (what a fixed-shape all-to-all would carry)."""
        p, q, s = self.mesh.p, self.q, self.shard
        out_ids = sum(self.send) - self.send[s]
        in_ids = sum(self.recv) - self.recv[s]
        cap = int(self.counts[:, :-1].max()) if q > 1 else 0
        return {"ids": 4 * out_ids, "rows": row_bytes * in_ids,
                "grads": row_bytes * out_ids,
                "counts": 8 * (q + 1) * (p - 1),
                "ids_padded": 4 * cap * (q - 1),
                "rows_padded": row_bytes * cap * (q - 1),
                "grads_padded": row_bytes * cap * (q - 1)}


def route_cold(mesh, cold_idx: torch.Tensor, axes: tuple | None = None
               ) -> ColdRoute:
    """Route this rank's cold lookups ``cold_idx [B_r, F]`` (global cold
    row ids, -1 where the hot table owns the field) to their owners over
    ``mesh`` (a :class:`~repro_torch.core.comm.dist.PartitionMesh`) whose
    cold tables are sharded over ``axes`` (:func:`table_axes`; None:
    every axis) in ``q`` shards: bin the valid ids by owner ``id % q``,
    the member of this rank's shard group that holds shard ``id % q``;
    share the per-owner counts (and the rank's batch rows) with one
    all-gather of ``q + 1`` int64 a rank over the world, read on the host
    (the step's one host read); send each owner the local row ids ``id //
    q`` it must gather (a variable all-to-all over the group, exact: no
    lookup is dropped or padded)."""
    axes = mesh.axes if axes is None else tuple(axes)
    q = mesh.size(axes)
    flat = cold_idx.reshape(-1)
    owner = torch.where(flat >= 0, torch.remainder(flat, q), q).long()
    mine = torch.cat([torch.bincount(owner, minlength=q + 1)[:q],
                      owner.new_tensor([cold_idx.shape[0]])])
    counts = D.all_gather(mesh, mine).cpu().numpy()
    route = ColdRoute(mesh, axes, None, counts, None, flat.numel(),
                      {"counts": 8 * (q + 1) * (mesh.p - 1)})
    route.order = torch.argsort(owner, stable=True)[:sum(route.send)]
    ids = torch.div(flat.index_select(0, route.order), q,
                    rounding_mode="floor").to(torch.int32)
    route.recv_ids = D.all_to_all_v(mesh, ids, route.send, route.recv,
                                    tally=route.sent, key="ids",
                                    axes=axes).long()
    return route


def cold_rows(params: dict, route: ColdRoute) -> torch.Tensor:
    """The rows of this rank's cold lookups, ``[B_r * F, D + 1]`` (``emb``
    then ``lin``; zeros where the lookup is -1), from the owners' shards
    (``params`` holds this rank's ``emb_cold`` / ``lin_cold`` shard): each
    owner gathers the asked rows of both tables as one block with
    ``index_select`` and returns them by the reverse variable all-to-all.
    Differentiable: the row gradients go back to their owners by the same
    exchange reversed and are summed into the shard's gradient by the
    gather's backward (one ``index_add``)."""
    emb, lin = params["emb_cold"], params["lin_cold"]
    block = torch.cat([emb.index_select(0, route.recv_ids),
                       lin.index_select(0, route.recv_ids)], -1)
    back = D.AllToAllV.apply(block, route.mesh, route.recv, route.send,
                             route.sent, ("rows", "grads"), route.axes)
    return back.new_zeros((route.n_lookups, block.shape[-1])).index_copy(
        0, route.order, back)


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
                   cold_idx: torch.Tensor, cin_op: Callable | None = None,
                   route: ColdRoute | None = None) -> torch.Tensor:
    """``hot_idx`` / ``cold_idx`` ``[B, F]`` -> logits ``[B]``; ``cin_op``
    as in :func:`cin_apply`. With ``route`` (:func:`route_cold` of
    ``cold_idx``) the model is sharded: ``params`` holds this rank's cold
    shards and the cold rows come from their owners (:func:`cold_rows`);
    everything after the lookup is the rank's own batch rows. The
    reference's ``shard`` argument (a sharding constraint on ``x0``,
    GSPMD's) is what ``route`` spells out."""
    d = cfg.embed_dim
    if route is None:
        cold = [_rows(params[f"{t}_cold"], cold_idx) for t in ("emb", "lin")]
    else:
        c = cold_rows(params, route).reshape(*cold_idx.shape, d + 1)
        cold = [c[..., :d], c[..., d:]]
    x0, lin = (_two_class(hot_idx, cold_idx, _rows(params[f"{t}_hot"],
                                                   hot_idx), rows)
               for t, rows in zip(("emb", "lin"), cold))
    b = x0.shape[0]
    logit = lin.sum(dim=(1, 2)) + params["bias"][0]
    logit = logit + cin_apply(cfg, params, x0, cin_op)[:, 0]
    h = x0.reshape(b, -1)
    n_mlp = len(cfg.mlp_layers) + 1
    for i in range(n_mlp):
        h = h @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"]
        if i < n_mlp - 1:
            h = torch.relu(h)
    return logit + h[:, 0]


def xdeepfm_loss(cfg: XDeepFMConfig, params: dict, batch: dict,
                 cin_op: Callable | None = None,
                 route: ColdRoute | None = None) -> torch.Tensor:
    """Mean binary cross-entropy with logits of ``batch`` (``hot_idx``,
    ``cold_idx`` ``[B, F]``, ``labels`` ``[B]`` 0/1), in the reference's
    numerically stable form ``max(z, 0) - z y + log1p(exp(-|z|))``. With
    ``route`` (sharded, ``batch`` this rank's rows): the rank's share of
    the global mean, its rows' sum over the world's batch size (the ranks'
    shares sum to the mean)."""
    z = xdeepfm_logits(cfg, params, batch["hot_idx"], batch["cold_idx"],
                       cin_op, route).float()
    y = batch["labels"].float()
    loss = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if route is None:
        return loss.mean()
    return loss.sum() / route.global_batch


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
    q = query_vectors(model.cfg, model.params(), hot_idx, cold_idx)
    scores = q @ candidates.T                                      # [B, n_cand]
    return torch.topk(scores, top_k)


def query_vectors(cfg: XDeepFMConfig, params: dict, hot_idx: torch.Tensor,
                  cold_idx: torch.Tensor, route: ColdRoute | None = None
                  ) -> torch.Tensor:
    """The retrieval tower's query vectors ``[B, d_query]`` of ``[B, F]``
    lookups; with ``route`` the cold rows come from their owners, as in
    :func:`xdeepfm_logits`."""
    d = cfg.embed_dim
    if route is None:
        x0 = embed_lookup(params, hot_idx, cold_idx, "emb")
    else:
        cold = cold_rows(params, route).reshape(*cold_idx.shape, d + 1)
        x0 = _two_class(hot_idx, cold_idx, _rows(params["emb_hot"], hot_idx),
                        cold[..., :d])
    q = x0.reshape(x0.shape[0], -1)
    return torch.relu(q @ params["q_w0"] + params["q_b0"]) @ params["q_w1"]


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
