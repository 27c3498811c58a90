"""Dense-batch helpers: to_dense_batch and to_dense_adj.

Counterpart of euler_tpu/utils/dense.py (reference:
tf_euler/python/utils/to_dense_adj.py, to_dense_batch.py): the nodes and
edges of a batch of graphs, grouped by graph, into per-graph dense node
rows [G, maxN, D] and adjacency [G, maxN, maxN]. Indices past the end
clamp, as XLA's gathers do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _slots(gi: torch.Tensor, n_graphs: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(graph or ``n_graphs`` for dropped nodes, position of each node
    within its graph in node order), both int64 [n]."""
    g_safe = torch.where(gi >= 0, gi, n_graphs).long()
    onehot = g_safe[:, None] == torch.arange(n_graphs + 1,
                                             device=gi.device)[None, :]
    pos = torch.cumsum(onehot.to(torch.int32), dim=0)[
        torch.arange(gi.shape[0], device=gi.device), g_safe] - 1
    return g_safe, pos.long()


def to_dense_batch(x: torch.Tensor, graph_idx: torch.Tensor, n_graphs: int,
                   max_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-node rows into [n_graphs, max_nodes, ...] and a bool
    mask [n_graphs, max_nodes].

    graph_idx[i] = graph of node i (-1 = drop). Nodes beyond
    ``max_nodes`` within a graph are dropped.
    """
    gi = graph_idx.to(torch.int32)
    g_safe, pos = _slots(gi, n_graphs)
    keep = (gi >= 0) & (pos < max_nodes)
    dump = n_graphs * max_nodes
    flat = torch.where(keep, g_safe * max_nodes + pos, dump)
    tail = tuple(x.shape[1:])
    rows = torch.where(keep.reshape((-1,) + (1,) * len(tail)), x, 0)
    out = x.new_zeros((dump + 1,) + tail).index_put_((flat,), rows)
    mask = torch.zeros(dump + 1, dtype=torch.bool,
                       device=x.device).index_put_((flat,), keep)
    return (out[:-1].reshape((n_graphs, max_nodes) + tail),
            mask[:-1].reshape(n_graphs, max_nodes))


def to_dense_adj(edge_index: torch.Tensor, graph_idx: torch.Tensor,
                 n_graphs: int, max_nodes: int,
                 edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-graph dense adjacency [n_graphs, max_nodes, max_nodes], f32,
    the weights of repeated edges summed.

    edge_index [2, E] in *global* node numbering; graph_idx maps global
    node -> graph. Node slots follow the same within-graph ordering as
    ``to_dense_batch``; edges across graphs, of dropped nodes or of
    negative ids are left out.
    """
    gi = graph_idx.to(torch.int32)
    n = gi.shape[0]
    _, pos = _slots(gi, n_graphs)
    src, dst = edge_index[0].long(), edge_index[1].long()
    s_i, d_i = src.clamp(0, n - 1), dst.clamp(0, n - 1)
    e_ok = (src >= 0) & (dst >= 0)
    sg = torch.where(e_ok, gi[s_i], -1).long()
    dg = torch.where(e_ok, gi[d_i], -1).long()
    sp, dp = pos[s_i], pos[d_i]
    e_ok = e_ok & (sg == dg) & (sg >= 0) & (sp < max_nodes) \
        & (dp < max_nodes)
    dump = n_graphs * max_nodes * max_nodes
    flat = torch.where(e_ok, (sg.clamp_min(0) * max_nodes + sp) * max_nodes
                       + dp, dump)
    w = (torch.ones(src.shape, dtype=torch.float32, device=src.device)
         if edge_weight is None else edge_weight.to(torch.float32))
    adj = torch.zeros(dump + 1, dtype=torch.float32, device=src.device)
    adj.index_add_(0, flat, torch.where(e_ok, w, 0.0))
    return adj[:-1].reshape(n_graphs, max_nodes, max_nodes)
