"""Feature encoders: node ids + graph features -> input vectors.

Counterpart of euler_tpu/models/encoders.py ``ShallowEncoder`` on its
dense path (reference: tf_euler/python/utils/encoders.py:32-120), and
``Embed``, flax's ``nn.Embed`` as the KG tables and ``EmbedOnly`` use it.
The id and sparse-id embeddings of ``ShallowEncoder`` wait for the slices
whose models use them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops.gather_rows import gather_rows


class ShallowEncoder(nn.Module):
    """Concat of the named dense node features; rows of ids < 0 are 0
    (and rows of ids >= N NaN, as in the reference).

    The reference gathers each feature, concatenates and zeroes the rows
    of ids < 0 (encoders.py:49-67). Here, when the features share a
    dtype, one ``[M, sum of dims]`` output is allocated and each feature
    is gathered straight into its column range by ``gather_rows``, which
    writes the zero rows itself: one pass over the output. Features of
    mixed dtypes are gathered one by one and concatenated with the
    reference's type promotion.
    """

    def __init__(self, dense_names: Sequence[str] = ()):
        super().__init__()
        if not dense_names:
            raise ValueError("ShallowEncoder configured with no inputs")
        self.dense_names = tuple(dense_names)

    def forward(self, g: GraphTensors, n_id: torch.Tensor) -> torch.Tensor:
        tables = [g.dense_nf[n] for n in self.dense_names]
        flat = n_id.reshape(-1).to(torch.int32).contiguous()
        dtypes = {t.dtype for t in tables}
        if len(dtypes) == 1:
            out = torch.empty((flat.shape[0], sum(t.shape[1] for t in tables)),
                              dtype=tables[0].dtype, device=flat.device)
            off = 0
            for t in tables:
                gather_rows(t, flat, out, off)
                off += t.shape[1]
        else:
            out = torch.cat([gather_rows(t, flat) for t in tables], dim=-1)
        return out.reshape(tuple(n_id.shape) + (out.shape[1],))


class _Lookup(torch.autograd.Function):
    """Rows ``weight[ids]``; the backward adds each row's cotangent into a
    zero table with ``index_add_``. On the card that sums repeated ids
    with atomics, in no fixed order, and never waits for the card (the
    dense backward of ``F.embedding`` sorts the ids and spends host time
    waiting), so a step through it can be captured in a CUDA graph."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.shape = weight.shape
        return weight.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (weight.shape[1],))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = g.new_zeros(ctx.shape)
        grad.index_add_(0, ids.reshape(-1), g.reshape(-1, ctx.shape[1]))
        return grad, None


class Embed(nn.Module):
    """flax's ``nn.Embed``: a [num, features] table looked up by id.

    flax looks up with ``jnp.take``, whose default mode fills the row of
    an id past the table with NaN, where ``nn.Embedding`` would raise.
    Here ids clamp to the last row and those rows become NaN with a
    ``where``, so the clamped row takes no gradient from them. Callers
    clamp ids below 0, as the reference's do. The gradient of the table
    is an ``index_add_`` of the rows' cotangents (``_Lookup``): on the
    card its sums over repeated ids run in no fixed order. The table
    starts as flax's ``default_embed_init``: normal with variance
    1 / features, drawn from ``generator``, a CPU generator.
    """

    def __init__(self, num: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            (num, features), generator=generator) / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        ids = ids.long()
        out = _Lookup.apply(self.weight, ids.clamp_max(n - 1))
        return torch.where((ids < n)[..., None], out, float("nan"))
