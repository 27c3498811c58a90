"""Graph-level pooling (readout) layers: segment reductions over each
node's graph index.

Counterpart of euler_tpu/models/pooling.py (reference:
tf_euler/python/graph_pool/base_pool.py:21, attention_pool.py:22,
set2set_pool.py:22), over ``mp_ops.masked_scatter_``,
``masked_scatter_softmax`` and ``scatter_add`` with one difference:
every sum takes ``fixed_order``, so that a replayed step equals its
eager step bit for bit (with atomic sums a set2set loop left its eager
steps by 1e-4 to 1e-1 within 10 steps on the card). ``num_graphs`` is
the static segment count (the batch's graphs); ``graph_index`` [M]
holds each node's graph and ``mask`` [M] which nodes are real.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.layers import LSTMCell
from euler_tpu_torch.ops import mp_ops


class SegmentPool(nn.Module):
    """sum, mean or max readout by graph index (base_pool.py); the mean
    divides by the valid count (at least 1e-7), the max of a graph with
    no valid node is 0. No parameters: ``in_dim`` is accepted for a
    common signature and its output is ``in_dim`` wide."""

    def __init__(self, in_dim: int, num_graphs: int, aggr: str = "sum"):
        super().__init__()
        self.op = {"sum": "add", "add": "add", "mean": "mean",
                   "max": "max"}[aggr]
        self.num_graphs, self.out_dim = num_graphs, in_dim

    def forward(self, x, graph_index, mask=None):
        return mp_ops.masked_scatter_(self.op, x, graph_index,
                                      self.num_graphs, mask,
                                      fixed_order=True)


class AttentionPool(nn.Module):
    """Gated attention readout (attention_pool.py): the per-graph softmax
    of ``gate(x)`` (a bias-free Dense to 1, flax's ``Dense_0``) weighting
    x, summed over valid nodes."""

    def __init__(self, in_dim: int, num_graphs: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_graphs, self.out_dim = num_graphs, in_dim
        self.gate = dense(in_dim, 1, bias=False, generator=generator)

    def forward(self, x, graph_index, mask=None):
        alpha = mp_ops.masked_scatter_softmax(
            self.gate(x), graph_index, self.num_graphs, mask,
            fixed_order=True)
        msg = x * alpha
        if mask is not None:
            msg = msg * mask[:, None]
        return mp_ops.scatter_add(msg, graph_index, self.num_graphs,
                                  fixed_order=True)


class Set2SetPool(nn.Module):
    """Set2Set readout (set2set_pool.py): ``proj`` (a bias-free Dense to
    ``dim``, flax's ``Dense_0``), then ``processing_steps`` rounds of the
    LSTM cell (``OptimizedLSTMCell_0``) from a zero carry on q* and an
    attention over each graph's nodes; output [G, 2 * dim]."""

    def __init__(self, in_dim: int, num_graphs: int, dim: int,
                 processing_steps: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_graphs, self.dim = num_graphs, dim
        self.steps, self.out_dim = processing_steps, 2 * dim
        self.proj = dense(in_dim, dim, bias=False, generator=generator)
        self.lstm = LSTMCell(2 * dim, dim, generator)

    def forward(self, x, graph_index, mask=None):
        G = self.num_graphs
        proj = self.proj(x)
        q_star = proj.new_zeros((G, 2 * self.dim))
        carry = self.lstm.zero_carry(G, proj)
        for _ in range(self.steps):
            carry, q = self.lstm(carry, q_star)
            e = (proj * mp_ops.gather(q, graph_index)).sum(-1, keepdim=True)
            a = mp_ops.masked_scatter_softmax(e, graph_index, G, mask,
                                              fixed_order=True)
            msg = proj * a
            if mask is not None:
                msg = msg * mask[:, None]
            r = mp_ops.scatter_add(msg, graph_index, G, fixed_order=True)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


def get_pool_class(name: str):
    """reference: pooling.py get_pool_class."""
    return {"sum": SegmentPool, "mean": SegmentPool, "max": SegmentPool,
            "attention": AttentionPool, "set2set": Set2SetPool}[name]
