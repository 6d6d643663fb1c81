"""E(3)-equivariant message passing (MACE, l_max=2, correlation order 3).

The port of ``repro.models.equivariant``. Irrep features are dicts ``{l:
[N, C, 2l+1]}`` over real spherical harmonics. The Gaunt coefficients of
the real basis (the integral of a product of three harmonics) are computed
once, exactly, with a Gauss-Legendre x uniform-phi quadrature (products of
three l <= 2 harmonics have polynomial degree <= 6, so 8 x 16 nodes
integrate them exactly), in float64 and kept in float32 as the reference
keeps them.

The contraction at l_max = 2 is small and dense: ``einsum``s and
``torch.matmul`` on the card, as the reference's are on the MXU. The
aggregation of edge messages is one ``index_add`` a layer and l (the
reference's ``segment_sum``). Parameters keep the reference's nested names
and layouts, so a parameter tree carries across by name
(:func:`repro_torch.core.convert.tree_from_numpy`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .common import ParamSpec

L_MAX = 2
IRREP_DIMS = {0: 1, 1: 3, 2: 5}


# ------------------------------------------------- real spherical harmonics
def real_sph_harm(xyz) -> dict:
    """Orthonormal real SH for unit vectors ``xyz [..., 3]`` (a tensor, or
    a numpy array for the quadrature), l = 0, 1, 2."""
    if isinstance(xyz, np.ndarray):
        stack, ones_like = np.stack, np.ones_like
    else:
        stack, ones_like = torch.stack, torch.ones_like
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    c0 = 0.28209479177387814          # 1 / (2 sqrt(pi))
    c1 = 0.4886025119029199           # sqrt(3 / 4pi)
    c2a = 1.0925484305920792          # sqrt(15 / 4pi)
    c2b = 0.31539156525252005         # sqrt(5 / 16pi)
    c2c = 0.5462742152960396          # sqrt(15 / 16pi)
    one = ones_like(x)
    y0 = stack([c0 * one], -1)
    y1 = stack([c1 * y, c1 * z, c1 * x], -1)
    y2 = stack([
        c2a * x * y,
        c2a * y * z,
        c2b * (3 * z * z - 1.0),
        c2a * x * z,
        c2c * (x * x - y * y),
    ], -1)
    return {0: y0, 1: y1, 2: y2}


@functools.lru_cache(maxsize=1)
def gaunt_tables() -> dict:
    """``G[(l1, l2, l3)] [2l1+1, 2l2+1, 2l3+1]`` float32 numpy: exact
    triple-product integrals, the non-zero paths in ``(l1, l2, l3)`` loop
    order (the order :func:`tensor_product` sums them in)."""
    k, m = 8, 16
    xg, wg = np.polynomial.legendre.leggauss(k)      # cos(theta) nodes
    phi = 2 * np.pi * np.arange(m) / m
    ct = np.repeat(xg, m)
    st = np.sqrt(1 - ct**2)
    ph = np.tile(phi, k)
    pts = np.stack([st * np.cos(ph), st * np.sin(ph), ct], axis=-1)
    w = np.repeat(wg, m) * (2 * np.pi / m)
    ys = real_sph_harm(pts)
    tables = {}
    for l1 in range(L_MAX + 1):
        for l2 in range(L_MAX + 1):
            for l3 in range(L_MAX + 1):
                g = np.einsum("p,pi,pj,pk->ijk", w, ys[l1], ys[l2], ys[l3])
                g[np.abs(g) < 1e-12] = 0.0
                if np.abs(g).max() > 0:
                    tables[(l1, l2, l3)] = g.astype(np.float32)
    return tables


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device, dtype: torch.dtype) -> dict:
    """:func:`gaunt_tables` as tensors on ``device``, made once per device
    and dtype."""
    return {k: torch.from_numpy(g).to(device=device, dtype=dtype)
            for k, g in gaunt_tables().items()}


def tensor_product(a: dict, b: dict, path_weights: dict | None = None) -> dict:
    """CG/Gaunt product of two irrep dicts -> irrep dict (l <= L_MAX),
    summed over the paths in :func:`gaunt_tables`' order.

    ``path_weights`` optionally holds ``[C]`` per-path channel scales keyed
    ``"l1_l2_l3"`` (the learnable mixing of the correlation expansion)."""
    ref = next(iter(a.values()))
    out: Dict[int, torch.Tensor] = {}
    for (l1, l2, l3), g in _tables_on(ref.device, ref.dtype).items():
        if l1 not in a or l2 not in b or l3 > L_MAX:
            continue
        term = torch.einsum("...ci,...cj,ijk->...ck", a[l1], b[l2], g)
        if path_weights is not None:
            key = f"{l1}_{l2}_{l3}"
            if key in path_weights:
                term = term * path_weights[key][:, None]
        out[l3] = out[l3] + term if l3 in out else term
    return out


# ----------------------------------------------------------------- MACE arch
@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128        # channels per irrep
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    n_species: int = 10
    r_cut: float = 5.0
    dtype: Any = torch.float32
    # distributed-path knobs: fetch only the 3-dim positions for remote nn
    # endpoints (messages read the destination's position only), and carry
    # messages and partials in bfloat16
    dist_fetch_pos_only: bool = False
    dist_msg_dtype: Any = torch.float32


def _paths():
    return [f"{l1}_{l2}_{l3}" for (l1, l2, l3) in gaunt_tables().keys()]


def mace_param_specs(cfg: MACEConfig) -> dict:
    c, dt = cfg.d_hidden, cfg.dtype
    layers = {}
    for i in range(cfg.n_layers):
        lp = {
            # radial MLP: rbf -> per-(edge-SH l, channel) weights
            "rad_w0": ParamSpec((cfg.n_rbf, 64), dt, ("", ""), "scaled"),
            "rad_b0": ParamSpec((64,), dt, ("",), "zeros"),
            "rad_w1": ParamSpec((64, (L_MAX + 1) * c), dt, ("", ""), "scaled"),
            # channel mixing per l for messages and update
            **{f"{w}{l}": ParamSpec((c, c), dt, ("", ""), "scaled")
               for w in ("w_msg", "w_self", "w_b2_", "w_b3_")
               for l in IRREP_DIMS},
            # per-path weights of the correlation products
            "pw2": {k: ParamSpec((c,), dt, ("",), "ones") for k in _paths()},
            "pw3": {k: ParamSpec((c,), dt, ("",), "ones") for k in _paths()},
            # invariant readout
            "ro_w0": ParamSpec((c, 16), dt, ("", ""), "scaled"),
            "ro_b0": ParamSpec((16,), dt, ("",), "zeros"),
            "ro_w1": ParamSpec((16, 1), dt, ("", ""), "scaled"),
        }
        layers[f"layer{i}"] = lp
    return {
        "species_embed": ParamSpec((cfg.n_species, c), dt, ("", ""), "normal"),
        "layers": layers,
    }


def bessel_rbf(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    """``sin(k pi r / rc) / r`` radial basis ``[E, n]`` with a smooth
    polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=r.device)
    basis = (math.sqrt(2.0 / r_cut)
             * torch.sin(k[None, :] * np.pi * r[:, None] / r_cut) / r[:, None])
    u = torch.clamp(r / r_cut, 0, 1)
    envelope = 1 - 10 * u**3 + 15 * u**4 - 6 * u**5     # polynomial cutoff
    return basis * envelope[:, None]


def species_features(cfg: MACEConfig, params: dict,
                     species: torch.Tensor) -> dict:
    """The layer-0 irreps of atoms of ``species [..., N]``: the species
    embedding as the scalars (ids clamped into the table, as the
    reference's ``jnp.take(mode="clip")``), zeros for l > 0."""
    emb = params["species_embed"]
    idx = species.long().clamp(0, emb.shape[0] - 1)
    h = {0: emb.index_select(0, idx.reshape(-1)).reshape(
        *species.shape, -1)[..., None]}
    for l in range(1, L_MAX + 1):
        h[l] = emb.new_zeros(tuple(species.shape) + (cfg.d_hidden,
                                                     IRREP_DIMS[l]))
    return h


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Channel mixing of irreps ``x [..., C, m]`` by ``w [C, C']``."""
    return (x.transpose(-1, -2) @ w).transpose(-1, -2)


def edge_messages(cfg: MACEConfig, lp: dict, layer: int, h_src: dict,
                  ys: dict, rbf: torch.Tensor) -> dict:
    """Per-edge A-basis messages ``{l: [..., E, C, 2l+1]}`` of one layer:
    the radial weights times the mixed sender scalars times ``Y_l``, plus
    (after layer 0) the mixed sender features of the same l."""
    c = cfg.d_hidden
    rad = F.silu(rbf @ lp["rad_w0"] + lp["rad_b0"]) @ lp["rad_w1"]
    rad = rad.reshape(*rad.shape[:-1], L_MAX + 1, c)         # [E, L+1, C]
    out = {}
    for l in range(L_MAX + 1):
        h_s = h_src[0][..., 0] @ lp[f"w_msg{l}"]              # [E, C]
        m = rad[..., l, :][..., None] * h_s[..., None] * ys[l][..., None, :]
        if layer > 0:
            m = m + rad[..., l, :][..., None] * _mix(h_src[l], lp[f"w_msg{l}"])
        out[l] = m
    return out


def node_update(lp: dict, h: dict, a: dict) -> tuple:
    """One layer's update from the aggregated A-basis ``a``: correlation
    orders 2 and 3 by iterated Gaunt products, channel mixing, residual;
    returns ``(new_h, node energies [..., N] float32)``."""
    b2 = tensor_product(a, a, lp["pw2"])
    b3 = tensor_product(b2, a, lp["pw3"])
    new_h = {}
    for l in range(L_MAX + 1):
        upd = _mix(h[l], lp[f"w_self{l}"]) + a[l]
        if l in b2:
            upd = upd + _mix(b2[l], lp[f"w_b2_{l}"])
        if l in b3:
            upd = upd + _mix(b3[l], lp[f"w_b3_{l}"])
        new_h[l] = upd
    inv = new_h[0][..., 0]
    e_i = F.silu(inv @ lp["ro_w0"] + lp["ro_b0"]) @ lp["ro_w1"]
    return new_h, e_i[..., 0].float()


def edge_geometry(cfg: MACEConfig, vec: torch.Tensor, valid: torch.Tensor
                  ) -> tuple:
    """``(Y_l dict, rbf [..., E, n_rbf])`` of edge vectors ``vec [..., E,
    3]``; padding edges (``valid`` False) get a zero radial basis."""
    dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)
    unit = vec / dist[..., None]
    ys = real_sph_harm(unit)
    rbf = bessel_rbf(dist.reshape(-1), cfg.n_rbf, cfg.r_cut).reshape(
        *dist.shape, cfg.n_rbf)
    return ys, rbf * valid[..., None]


def mace_forward(cfg: MACEConfig, params: dict, positions, species, senders,
                 receivers) -> torch.Tensor:
    """Per-node invariant energies ``[N]``. Padding edges (sender ``N``)
    are clamped into range and contribute nothing."""
    n = positions.shape[0]
    h = species_features(cfg, params, species)
    valid = senders < n
    s = torch.clamp(senders, max=n - 1).long()
    r = torch.clamp(receivers, max=n - 1).long()
    vec = positions.index_select(0, s) - positions.index_select(0, r)
    ys, rbf = edge_geometry(cfg, vec, valid)
    energy = torch.zeros((n,), dtype=torch.float32, device=positions.device)
    for i in range(cfg.n_layers):
        lp = params["layers"][f"layer{i}"]
        h_src = {l: x.index_select(0, s) for l, x in h.items()}
        msgs = edge_messages(cfg, lp, i, h_src, ys, rbf)
        a = {}
        for l, m in msgs.items():
            m = m * valid[:, None, None]
            a[l] = m.new_zeros((n,) + tuple(m.shape[1:])).index_add(0, r, m)
        h, e_i = node_update(lp, h, a)
        energy = energy + e_i
    return energy


def mace_energy(cfg: MACEConfig, params: dict, g) -> torch.Tensor:
    """Total energy per graph of a :class:`~repro_torch.models.gnn.
    GraphBatch` of tensors: ``[n_graphs]``."""
    e_node = mace_forward(cfg, params, g.positions, g.species, g.senders,
                          g.receivers)
    if g.node_mask is not None:
        e_node = e_node * g.node_mask.to(e_node.dtype)
    if g.graph_ids is None:
        return e_node.sum()[None]
    return e_node.new_zeros((g.n_graphs,)).index_add(
        0, g.graph_ids.long(), e_node)


def mace_loss(cfg: MACEConfig, params: dict, g, target_energy) -> torch.Tensor:
    pred = mace_energy(cfg, params, g)
    return torch.mean((pred - target_energy) ** 2)
