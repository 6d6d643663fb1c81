"""Dispatching wrappers for the port's kernels.

A wrapper launches its CUDA kernel for CUDA tensors and takes the kernel's
plain PyTorch version for CPU tensors -- chosen only by where the tensors
lie. There is no fallback: a CUDA launch that fails raises, and tensors on
any other device raise.

``LAUNCHES`` counts kernel launches per kernel (a plain integer each,
incremented exactly where a wrapper launches), so a run can show that its
main path went through the kernels; ``REPLAYED`` counts the launches that
CUDA graph replays of captured wrapper calls make.
"""
from __future__ import annotations

import torch

from .cin_fused import (CinFused, cin_fused_bwd_w_cuda,
                        cin_fused_bwd_w_plain, cin_fused_bwd_x_cuda,
                        cin_fused_bwd_x_plain, cin_fused_cuda,
                        cin_fused_plain)
from .ell_pull import (ell_pull_bits_cuda, ell_pull_bits_plain,
                       ell_pull_bits_sweep_cuda)
from .ell_pull_multi import (ell_as_csr, ell_pull_chunked_cuda,
                             ell_pull_chunked_plain,
                             ell_pull_chunked_sweep_cuda)
from .ell_pull_payload import ell_pull_payload_cuda, ell_pull_payload_plain
from .mask_reduce import (group_fold_cuda, group_fold_plain,
                          mask_reduce_apply_cuda, mask_reduce_apply_plain,
                          mask_reduce_cuda, mask_reduce_plain,
                          payload_min_fold_apply_cuda,
                          payload_min_fold_apply_plain, payload_min_fold_cuda,
                          payload_min_fold_plain)
from .segment_bag import segment_bag_cuda, segment_bag_plain

LAUNCHES = {"ell_pull_multi": 0, "mask_reduce": 0, "ell_pull": 0,
            "payload_min_fold": 0, "cin_fused": 0, "segment_bag": 0,
            "ell_pull_payload": 0, "cin_fused_bwd_w": 0, "cin_fused_bwd_x": 0}
#: launches made by replaying CUDA graphs, per kernel: a captured wrapper
#: call counts here once per replay (its capture counts nowhere)
REPLAYED = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = REPLAYED[k] = 0


def count_replay(per_replay: dict) -> None:
    """One replay of a graph that captured ``per_replay`` launches."""
    for k, n in per_replay.items():
        REPLAYED[k] += n


#: the dry run's hook (``launch.dryrun.StepCounter.kernel``): a wrapper
#: given fake tensors (shapes without data) calls it with the kernel's name,
#: inputs and outputs instead of launching or taking the plain version,
#: whose data-dependent shapes a fake tensor cannot carry
FAKE_HOOK = None


def _fake_launch(name: str, ins: list, outs: list, flops: dict | None = None):
    """Outputs of a kernel ``name`` on fake inputs (``outs``: fake tensors
    of the kernel's output shapes), reported to :data:`FAKE_HOOK` with the
    kernel's flops by the arithmetic that does them."""
    if FAKE_HOOK is None:
        raise RuntimeError(f"{name} given fake tensors outside the dry run")
    FAKE_HOOK(name, ins, outs, flops or {})
    return outs


def _cin_flops(x0, xk, h: int) -> dict:
    """A CIN product's flops, 2 B H F0 Fk D, on 3xTF32 (three TF32
    tensor-core products a float32 product)."""
    b, f0, d = x0.shape
    return {"tf32x3": 2 * b * h * f0 * xk.shape[1] * d}


def _is_fake(*ts: torch.Tensor) -> bool:
    """True where any of ``ts`` is a fake tensor (the dry run's)."""
    if all(type(t) is torch.Tensor for t in ts):   # the launch path
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in ts)


def _pull_outputs(offsets: torch.Tensor) -> list:
    """``(found, work)`` of a single-bit pull, ``[p, R]`` int32 each."""
    p, r = offsets.shape[0], offsets.shape[1] - 1
    return [offsets.new_zeros((p, r)), offsets.new_zeros((p, r))]


def _on_cuda(first: torch.Tensor, *rest: torch.Tensor) -> bool:
    """True where the first tensor lies on a card: the CUDA wrapper then
    checks every tensor's device itself, in its one pass. CPU tensors must
    all be on the CPU."""
    if first.is_cuda:
        return True
    kind = first.device.type
    for t in rest:
        if t.device.type != kind:
            kind = None
            break
    if kind != "cpu":
        raise ValueError(
            f"kernel inputs on {sorted({t.device.type for t in (first, *rest)})}"
            ": CUDA tensors launch the kernel, CPU tensors take its plain "
            "version")
    return False


def ell_pull_chunked(offsets, cols, frontier, need, chunk: int, sched=None):
    """Main-path pull of one subgraph for every stacked partition:
    ``(found [p, R, nw], work [p, R])`` (see
    :mod:`repro_torch.kernels.ell_pull_multi`); ``sched`` is the CSR's row
    schedule (built on the fly where None)."""
    if _on_cuda(offsets, cols, frontier, need):
        out = ell_pull_chunked_cuda(offsets, cols, frontier, need, chunk,
                                    sched)
        LAUNCHES["ell_pull_multi"] += 1
        return out
    return ell_pull_chunked_plain(offsets, cols, frontier, need, chunk)


def ell_pull_chunked_sweep(pulls, chunk: int):
    """The three pulls of an msBFS sweep in one launch: ``pulls`` holds
    ``(csr, frontier [p, N, nw], need [p, R, nw])`` per subgraph (``csr`` a
    device CSR: offsets, cols and its schedule ``sched``) -> a list of
    ``(found, work)``, as :func:`ell_pull_chunked` gives each."""
    if _on_cuda(*(t for c, f, n in pulls for t in (c.offsets, c.cols, f, n))):
        out = ell_pull_chunked_sweep_cuda(
            [(c.offsets, c.cols, c.sched, f, n) for c, f, n in pulls], chunk)
        LAUNCHES["ell_pull_multi"] += 1
        return out
    return [ell_pull_chunked_plain(c.offsets, c.cols, f, n, chunk)
            for c, f, n in pulls]


def ell_pull_multi(parents, frontier_words, active_words):
    """The reference kernel's ELL contract: ``parents [R, K]`` int32 (-1
    padded), ``frontier_words [N, NW]``, ``active_words [R, NW]`` ->
    ``(OR of valid parents' words) & active`` ``[R, NW]``."""
    offsets, cols, chunk, sched = ell_as_csr(parents)
    found, _ = ell_pull_chunked(offsets, cols, frontier_words[None],
                                active_words[None], chunk, sched)
    return found[0]


def ell_pull_bits(offsets, cols, mask, active, chunk: int, sched=None):
    """Main-path single-bit pull of one subgraph for every stacked
    partition: ``(found [p, R], work [p, R])`` int32 (see
    :mod:`repro_torch.kernels.ell_pull`); ``sched`` is the CSR's row
    schedule (built on the fly where None)."""
    if _is_fake(offsets, cols, mask, active):
        return tuple(_fake_launch("ell_pull", [offsets, cols, mask, active],
                                  _pull_outputs(offsets)))
    if _on_cuda(offsets, cols, mask, active):
        out = ell_pull_bits_cuda(offsets, cols, mask, active, chunk, sched)
        LAUNCHES["ell_pull"] += 1
        return out
    return ell_pull_bits_plain(offsets, cols, mask, active, chunk)


def ell_pull_bits_sweep(pulls, chunk: int):
    """The three pulls of a single-source sweep in one launch: ``pulls``
    holds ``(csr, mask [p, ceil(N/32)], active [p, R])`` per subgraph
    (``csr`` a device CSR: offsets, cols and its schedule ``sched``) -> a
    list of ``(found, work)``, as :func:`ell_pull_bits` gives each."""
    if _is_fake(*(t for c, m, a in pulls for t in (c.offsets, c.cols, m, a))):
        return [tuple(_fake_launch("ell_pull", [c.offsets, c.cols, m, a],
                                   _pull_outputs(c.offsets)))
                for c, m, a in pulls]
    if _on_cuda(*(t for c, m, a in pulls for t in (c.offsets, c.cols, m, a))):
        out = ell_pull_bits_sweep_cuda(
            [(c.offsets, c.cols, c.sched, m, a) for c, m, a in pulls], chunk)
        LAUNCHES["ell_pull"] += 1
        return out
    return [ell_pull_bits_plain(c.offsets, c.cols, m, a, chunk)
            for c, m, a in pulls]


def ell_pull(parents, frontier_mask, active):
    """The reference kernel's ELL contract: ``parents [R, W]`` int32 (-1
    padded), ``frontier_mask [ceil(N/32)]`` int32 bit patterns, ``active
    [R]`` int32 (1 = row active) -> ``found [R]`` int32 0/1."""
    offsets, cols, chunk, sched = ell_as_csr(parents)
    found, _ = ell_pull_bits(offsets, cols, frontier_mask[None],
                             active[None], chunk, sched)
    return found[0]


def mask_reduce(partials, prev, *, with_count: bool = True):
    """K-way OR of ``partials [K, NW]`` into ``prev [NW]`` -> ``(or_mask,
    new_bits_per_word or None)``."""
    if _on_cuda(partials, prev):
        out = mask_reduce_cuda(partials, prev, with_count)
        LAUNCHES["mask_reduce"] += 1
        return out
    return mask_reduce_plain(partials, prev, with_count)


def payload_min_fold(partials, prev, *, with_count: bool = True):
    """K-way int32 elementwise min of ``partials [K, NW]`` into ``prev
    [NW]`` -> ``(combined, improved 0/1 or None)``."""
    if _on_cuda(partials, prev):
        out = payload_min_fold_cuda(partials, prev, with_count)
        LAUNCHES["payload_min_fold"] += 1
        return out
    return payload_min_fold_plain(partials, prev, with_count)


def group_fold(rows, op: str, k: int, k_stride: int = 1, groups: int = 1,
               g_stride: int = 0):
    """The OR (``op="or"``) or int32 min (``"min"``) of ``k`` int32 rows
    without ``prev``, one output row a group: ``out[g] = fold over i < k
    of rows[g * g_stride + i * k_stride]`` -> ``[groups, n]``. Counts
    under ``mask_reduce`` (OR) or ``payload_min_fold`` (min): it is that
    kernel's fold body."""
    if _on_cuda(rows):
        out = group_fold_cuda(rows, op, k, k_stride, groups, g_stride)
        LAUNCHES["mask_reduce" if op == "or" else "payload_min_fold"] += 1
        return out
    return group_fold_plain(rows, op, k, k_stride, groups, g_stride)


def mask_reduce_apply(gathered, level, it, target=None):
    """One sweep's delegate update of the lane-word step from the gathered
    words ``[K, d * nw]``: the OR fold, the new ``level [p, d, W]`` (int32
    levels, or bool visited with the frontier plane) and the lane flags ->
    :class:`~repro_torch.kernels.mask_reduce.DelegateApply`. Counts under
    ``mask_reduce``: it is the fold kernel of the path."""
    tensors = (gathered, level, it) + (() if target is None else (target,))
    if _on_cuda(*tensors):
        out = mask_reduce_apply_cuda(gathered, level, it, target)
        LAUNCHES["mask_reduce"] += 1
        return out
    return mask_reduce_apply_plain(gathered, level, it, target)


def payload_min_fold_apply(gathered, prev):
    """The int32 min of ``gathered [K, d]`` folded into every row of
    ``prev [p, d]`` -> ``(combined [p, d], improved [p] bool)``. Counts
    under ``payload_min_fold``: it is the fold kernel of the path."""
    if _on_cuda(gathered, prev):
        out = payload_min_fold_apply_cuda(gathered, prev)
        LAUNCHES["payload_min_fold"] += 1
        return out
    return payload_min_fold_apply_plain(gathered, prev)


def cin_fused(x0, xk, w):
    """One CIN step: ``x0 [B, F0, D]``, ``xk [B, Fk, D]``, ``w [H, F0*Fk]``
    float32 -> ``[B, H, D]`` (see :mod:`repro_torch.kernels.cin_fused`).
    Under autograd it goes through :class:`CinFused`, whose backward is
    :func:`cin_fused_bwd_w` and :func:`cin_fused_bwd_x`."""
    if torch.is_grad_enabled() and (x0.requires_grad or xk.requires_grad
                                    or w.requires_grad):
        return CinFused.apply(x0, xk, w)
    return cin_fused_forward(x0, xk, w)


def cin_fused_forward(x0, xk, w):
    """The forward of :func:`cin_fused` alone (no autograd record)."""
    if _is_fake(x0, xk, w):
        out = x0.new_empty((x0.shape[0], w.shape[0], x0.shape[2]))
        return _fake_launch("cin_fused", [x0, xk, w], [out],
                            _cin_flops(x0, xk, w.shape[0]))[0]
    if _on_cuda(x0, xk, w):
        out = cin_fused_cuda(x0, xk, w)
        LAUNCHES["cin_fused"] += 1
        return out
    return cin_fused_plain(x0, xk, w)


def cin_fused_bwd_w(x0, xk, g):
    """Weight gradient of a CIN step for ``g = dOut [B, H, D]`` -> ``dW [H,
    F0*Fk]``."""
    if _is_fake(x0, xk, g):
        out = x0.new_empty((g.shape[1], x0.shape[1] * xk.shape[1]))
        return _fake_launch("cin_fused_bwd_w", [x0, xk, g], [out],
                            _cin_flops(x0, xk, g.shape[1]))[0]
    if _on_cuda(x0, xk, g):
        out = cin_fused_bwd_w_cuda(x0, xk, g)
        LAUNCHES["cin_fused_bwd_w"] += 1
        return out
    return cin_fused_bwd_w_plain(x0, xk, g)


def cin_fused_bwd_x(x0, xk, w, g):
    """Input gradients of a CIN step for ``g = dOut [B, H, D]`` -> ``(dx0,
    dxk)``."""
    if _is_fake(x0, xk, w, g):
        return tuple(_fake_launch("cin_fused_bwd_x", [x0, xk, w, g],
                                  [torch.empty_like(x0), torch.empty_like(xk)],
                                  _cin_flops(x0, xk, w.shape[0])))
    if _on_cuda(x0, xk, w, g):
        out = cin_fused_bwd_x_cuda(x0, xk, w, g)
        LAUNCHES["cin_fused_bwd_x"] += 1
        return out
    return cin_fused_bwd_x_plain(x0, xk, w, g)


def segment_bag(table, indices, weights=None):
    """EmbeddingBag: ``table [V, D]`` float32 or bfloat16, ``indices [B, L]``
    int32 (-1 padded), ``weights [B, L]`` or None (ones) -> ``[B, D]`` in
    the table's dtype (see :mod:`repro_torch.kernels.segment_bag`)."""
    tensors = (table, indices) if weights is None else (table, indices, weights)
    if _on_cuda(*tensors):
        out = segment_bag_cuda(table, indices, weights)
        LAUNCHES["segment_bag"] += 1
        return out
    return segment_bag_plain(table, indices, weights)


def ell_pull_payload(parents, payload, weights, active):
    """Min-plus pull: ``parents [R, K]`` int32 (-1 padded), ``payload
    [N, W]``, ``weights [R, K]``, ``active [R, W]`` int32 -> ``[R, W]``
    (see :mod:`repro_torch.kernels.ell_pull_payload`)."""
    if _on_cuda(parents, payload, weights, active):
        out = ell_pull_payload_cuda(parents, payload, weights, active)
        LAUNCHES["ell_pull_payload"] += 1
        return out
    return ell_pull_payload_plain(parents, payload, weights, active)
