"""The yardstick's arithmetic of the ``gat`` configuration: the
operations a training step of multi-head GAT needs and the compulsory
bytes of each call of its three ELL attention kernels, from the
configuration's shapes alone, never from the program (``arith``'s rules).

Operations count the model's mathematics as the paper writes it (z = W x,
the per-head dot products with a_l and a_r, the weighted sum), not the
program's refolding of it; the softmax's elementwise work, O(E H), is left
out beside the sums' O(E D). Bytes: each array read once, the output
written once; the neighbour rows are not counted a cell (an L2 that
serves repeated rows would make such a count read over 100%): the table
[N, D], one id an edge, one f32 weight an edge and self loop a head, the
output [N, D] (the SDDMM's: a second table read, and one f32 gradient an
edge and self loop a head written).
"""
from __future__ import annotations

from typing import Sequence

from benchmark.harness.arith import _head_flops, linear_flops


def gat_step_flops(n_nodes: int, n_edges: int, layers: int, in_dim: int,
                   dims: Sequence[int], classes: int,
                   roots: int) -> int:
    """A whole-graph GAT training step over every node: per layer of width
    D from D_in, the forward z = x W^T (2 N D_in D), el and er (2 N D
    each) and the weighted sum over every edge and self loop (2 (E + N)
    D); the backward W's gradient (2 N D_in D), the input's where the
    layer is not the first (2 N D_in D), the sum's transpose and the
    weights' per-edge dot products (2 (E + N) D each) and el's and er's
    gradients to z and to a (4 N D each); then the head over the
    ``roots`` rows as ``arith.gcn_step_flops`` counts it."""
    widths = [in_dim] + list(dims)
    total = 0
    for layer in range(layers):
        d_in, d = widths[layer], widths[layer + 1]
        lin = linear_flops(n_nodes, d_in, d)
        agg = 2 * (n_edges + n_nodes) * d
        scores = 4 * n_nodes * d
        total += lin + scores + agg                      # forward
        total += lin + 2 * agg + 2 * scores              # backward
        if layer > 0:
            total += lin
    return total + _head_flops(roots, dims[-1], classes)


def call_bytes(n_nodes: int, n_edges: int, width: int, heads: int,
               elt: int) -> int:
    """Compulsory bytes of one call of any of the three kernels: two
    tables [N, D] moved once (the forward and the transpose read one and
    write one, the SDDMM reads the cotangent and the rows), an id (4 B) an
    edge read, and one f32 a head an edge and self loop (the weights read,
    or the SDDMM's gradients written)."""
    return (2 * n_nodes * width * elt + 4 * n_edges
            + 4 * heads * (n_edges + n_nodes))


def cfg_flops(cfg: dict, n_edges: int) -> int:
    """``gat_step_flops`` of a ``gat`` configuration file over
    ``n_edges`` stored edges."""
    m, d = cfg["model"], cfg["data"]
    return gat_step_flops(cfg["graph"]["nodes"], n_edges, m["layers"],
                          d["feature_dim"], m["dims"], d["classes"],
                          cfg["train"]["batch"])
