"""Differentiable gather and scatter message-passing primitives.

Counterpart of euler_tpu/ops/mp_ops.py (reference: tf_euler/python/
euler_ops/mp_ops.py:27-79). Autograd gives the reference's gradient rules
for gather (a scatter-add) and scatter_add (a gather); ``scatter_max`` is
a ``torch.autograd.Function`` whose backward splits the gradient evenly
among the updates that tie for a segment's maximum (mp_ops.py:52-62).

``indices`` may be int32 or int64. The scatters need int64 and convert
an int32 index tensor on every call, so a caller that reuses one (a
whole-graph block's ``edge_index``) passes it as int64 once; ``Block``
caches that conversion. Scatter indices must lie in [0, size).

The sums take ``fixed_order``: ``index_add_`` adds with atomics on the
card, in no fixed order, so a replayed step may leave its eager step in
the last bits, and a loop of them drifts. With ``fixed_order`` the card
sums with ``index_put_(accumulate=True)``, which sorts the indices and
adds each segment's rows one after another, the same on every run; the
CPU keeps ``index_add_``, which adds in the indices' order (there
``index_put_`` is the one in no fixed order).
"""
from __future__ import annotations

from typing import Optional

import torch


def _long(indices: torch.Tensor) -> torch.Tensor:
    return indices if indices.dtype == torch.int64 else indices.long()


def _fill_value(dtype: torch.dtype):
    """What jnp.take's default fill mode writes for an index past the
    end: NaN for floats, the most negative value for signed integers."""
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


def gather(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """params[indices] along axis 0. Negative indices read row 0 (callers
    mask padded ids themselves, as the reference's default_node + weight 0
    convention does); indices >= N give ``jnp.take``'s fill (NaN rows for
    floats)."""
    idx = _long(indices).clamp_min(0)
    n = params.shape[0]
    out = params[idx.clamp_max(max(n - 1, 0))]
    past = (idx >= n).reshape((-1,) + (1,) * (params.dim() - 1))
    return torch.where(past, params.new_full((), _fill_value(params.dtype)),
                       out)


def scatter_add(updates: torch.Tensor, indices: torch.Tensor,
                size: int, fixed_order: bool = False) -> torch.Tensor:
    """Segment sum of ``updates`` [E, ...] into ``size`` rows; the
    gradient is a gather."""
    out = updates.new_zeros((size,) + tuple(updates.shape[1:]))
    if fixed_order and updates.is_cuda:
        return out.index_put((_long(indices),), updates, accumulate=True)
    return out.index_add(0, _long(indices), updates)


def _segment_max(updates: torch.Tensor, idx: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Segment max, 0 in empty segments, no gradient."""
    full = idx.reshape((-1,) + (1,) * (updates.dim() - 1)).expand_as(updates)
    out = updates.new_zeros((size,) + tuple(updates.shape[1:]))
    return out.scatter_reduce(0, full, updates, "amax", include_self=False)


class _ScatterMax(torch.autograd.Function):
    """Segment max whose backward gives each update that equals its
    segment's result an equal share of that segment's gradient: the
    reference's custom VJP (mp_ops.py:49-59), which is also how XLA
    differentiates a raw segment max. With ``finite`` (the reference's
    ``scatter_max``) a non-finite maximum gives 0; an empty segment gives
    0 either way (the reference's raw segment max gives -inf there, which
    every caller of the raw form resets to 0)."""

    @staticmethod
    def forward(ctx, updates, idx, size, finite):
        out = _segment_max(updates, idx, size)
        if finite and out.dtype.is_floating_point:
            out = torch.where(torch.isfinite(out), out, 0.0)
        ctx.save_for_backward(updates, idx, out)
        ctx.size = size
        return out

    @staticmethod
    def backward(ctx, g):
        updates, idx, out = ctx.saved_tensors
        ind = (updates == out[idx]).to(updates.dtype)
        num = scatter_add(ind, idx, ctx.size)
        ind = ind / num[idx].clamp_min(1.0)
        return ind * g[idx], None, None, None


def scatter_max(updates: torch.Tensor, indices: torch.Tensor,
                size: int) -> torch.Tensor:
    """Segment max with empty segments = 0 and the tie-splitting
    gradient (reference mp_ops.py:41-46)."""
    return _ScatterMax.apply(updates, _long(indices), size, True)


def _masked_max(updates: torch.Tensor, idx: torch.Tensor, size: int,
                mask: torch.Tensor, neg: float) -> torch.Tensor:
    """The reference's raw segment max over ``where(mask > 0, updates,
    neg)``, reset to 0 where it is <= neg / 2 (no valid update)."""
    out = _ScatterMax.apply(torch.where(mask > 0, updates, neg), idx, size,
                            False)
    return torch.where(out <= neg * 0.5, 0.0, out)


def scatter_mean(updates: torch.Tensor, indices: torch.Tensor,
                 size: int, fixed_order: bool = False) -> torch.Tensor:
    """reference mp_ops.py:65-69: divides by the segment's count + 1e-7."""
    out = scatter_add(updates, indices, size, fixed_order)
    ones = updates.new_ones((updates.shape[0], 1))
    count = scatter_add(ones, indices, size, fixed_order) + 1e-7
    return out / count


def scatter_softmax(updates: torch.Tensor, indices: torch.Tensor,
                    size: int, fixed_order: bool = False) -> torch.Tensor:
    """Max-shifted segment softmax (reference mp_ops.py:76-79)."""
    idx = _long(indices)
    shifted = updates - gather(scatter_max(updates, idx, size), idx)
    e = torch.exp(shifted)
    denom = gather(scatter_add(e, idx, size, fixed_order), idx)
    return e / denom.clamp_min(1e-16)


def scatter_(op: str, updates: torch.Tensor, indices: torch.Tensor,
             size: int, fixed_order: bool = False) -> torch.Tensor:
    """Dispatch by aggregator name ('add' | 'mean' | 'max'), reference
    mp_ops.py:72-73 ('max' sums nothing, so it ignores ``fixed_order``)."""
    if op == "max":
        return scatter_max(updates, indices, size)
    return {"add": scatter_add, "mean": scatter_mean}[op](
        updates, indices, size, fixed_order)


def _as_mask(mask: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (updates.dim() - 1)).to(updates.dtype)


def masked_scatter_(op: str, updates: torch.Tensor, indices: torch.Tensor,
                    size: int, mask: Optional[torch.Tensor] = None,
                    fixed_order: bool = False) -> torch.Tensor:
    """Aggregation that ignores padded edges (mask == 0): 'mean' divides
    by the valid count (at least 1e-7), 'max' ignores masked rows and
    gives 0 where a segment has none."""
    if mask is None:
        return scatter_(op, updates, indices, size, fixed_order)
    mask = _as_mask(mask, updates)
    if op == "add":
        return scatter_add(updates * mask, indices, size, fixed_order)
    if op == "mean":
        tot = scatter_add(updates * mask, indices, size, fixed_order)
        cnt = scatter_add(mask.expand(updates.shape[0], 1), indices, size,
                          fixed_order)
        return tot / cnt.clamp_min(1e-7)
    if op == "max":
        return _masked_max(updates, _long(indices), size, mask,
                           torch.finfo(updates.dtype).min)
    raise ValueError(op)


def masked_scatter_softmax(updates: torch.Tensor, indices: torch.Tensor,
                           size: int, mask: Optional[torch.Tensor] = None,
                           fixed_order: bool = False) -> torch.Tensor:
    """Segment softmax over unmasked edges (reference mp_ops.py:115-126):
    masked edges get 0, and a segment whose edges are all masked gives 0
    on every edge (its max reset to 0, the denominator clamped at
    1e-16)."""
    if mask is None:
        return scatter_softmax(updates, indices, size, fixed_order)
    idx = _long(indices)
    mask = _as_mask(mask, updates)
    neg = -1e30
    mx = _masked_max(updates, idx, size, mask, neg)
    z = torch.where(mask > 0, updates - gather(mx, idx), neg)
    e = torch.exp(z)
    denom = gather(scatter_add(e, idx, size, fixed_order), idx)
    return e / denom.clamp_min(1e-16)
