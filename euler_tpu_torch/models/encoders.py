"""Feature encoders: node ids + graph features -> input vectors.

Counterpart of euler_tpu/models/encoders.py ``ShallowEncoder`` on its
dense path (reference: tf_euler/python/utils/encoders.py:32-120). The id
and sparse-id embeddings wait for the slices whose models use them.
"""
from __future__ import annotations

from typing import Sequence

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
