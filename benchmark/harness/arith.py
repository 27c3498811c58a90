"""The yardstick's arithmetic: the peaks of the card, the operations a
training step needs and the bytes a layer's call needs, each from the
configuration's shapes or the call's inputs, never from the program.

Bytes follow the roofline rule: each input byte read once and each
output byte written once, whatever an implementation reads again; where
the work depends on the data, what these inputs need.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "float32_flops": 67e12,
         "tf32_flops": 495e12, "bfloat16_flops": 989e12}


def linear_flops(rows: int, k: int, n: int) -> int:
    return 2 * rows * k * n


def _head_flops(rows: int, dim: int, classes: int) -> int:
    """``out_fc`` [dim -> dim, with bias] then the label projection
    [dim -> classes]: forward, and in the backward both weight gradients,
    the bias gradient and both input gradients."""
    lin = linear_flops(rows, dim, dim) + linear_flops(rows, dim, classes)
    return 3 * lin + 2 * rows * dim


def sage_step_flops(batch: int, fanouts: Sequence[int], in_dim: int,
                    dims: Sequence[int], classes: int) -> int:
    """A sampled SAGE training step: forward, the weight gradients of
    every layer and the input gradients that are needed (none into the
    features, which are inputs).

    Layer l (deepest first) has t_l targets, each with f_l draws and a
    self loop: its mean adds (f_l + 1) rows of width D_in and divides
    once, and its two linears map t_l rows D_in -> D_out. The head is
    ``out_fc`` (with bias) then the label projection."""
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * (1 + f))
    widths = [in_dim] + list(dims)
    fwd = wgrad = igrad = 0
    for layer, f in enumerate(reversed(list(fanouts))):
        t = sizes[len(fanouts) - 1 - layer]
        d_in, d_out = widths[layer], widths[layer + 1]
        agg = t * (f + 1) * d_in + t * d_in
        lin = 2 * linear_flops(t, d_in, d_out)
        fwd += agg + lin
        wgrad += lin
        if layer > 0:            # gradient into this layer's inputs
            igrad += lin + agg
    return fwd + wgrad + igrad + _head_flops(batch, dims[-1], classes)


def gcn_step_flops(n_nodes: int, n_edges: int, layers: int, in_dim: int,
                   dims: Sequence[int], classes: int,
                   roots: Optional[int] = None) -> int:
    """A whole-graph GCN training step: per layer the normalised sum over
    every edge and self loop (a multiply and an add a value) and one
    linear over all nodes; the head as in ``sage_step_flops`` over the
    ``roots`` rows (all nodes by default), which are picked before it; no
    gradient into the features."""
    widths = [in_dim] + list(dims)
    fwd = wgrad = igrad = 0
    for layer in range(layers):
        d_in, d_out = widths[layer], widths[layer + 1]
        agg = 2 * (n_edges + n_nodes) * d_in
        lin = linear_flops(n_nodes, d_in, d_out)
        fwd += agg + lin
        wgrad += lin
        if layer > 0:
            igrad += lin + agg
    return fwd + wgrad + igrad + _head_flops(
        n_nodes if roots is None else roots, dims[-1], classes)


def draw_bytes(nodes: torch.Tensor, u1: torch.Tensor,
               out_deg: torch.Tensor) -> int:
    """Bytes a weighted neighbor draw of ``u1.shape`` [B, C] needs: the
    nodes (4 B) and two uniforms a draw (4 B each) read once, an id
    (4 B) and a valid flag (1 B) a draw written once, and from the graph
    each distinct live row's degree and weight sum (8 B) and each
    distinct (row, slot) cell a draw picks, slot = floor(u1 * degree),
    its probability and id (8 B)."""
    B, C = u1.shape
    live = nodes >= 0
    rows = nodes[live].long()
    deg = out_deg[rows][:, None]
    slot = torch.minimum((u1[live] * deg.float()).long(),
                         (deg - 1).clamp_min(0))
    ok = (deg > 0).expand(slot.shape)
    cells = (rows[:, None] * (1 << 20) + slot)[ok]
    return (B * C * (4 + 4 + 4 + 1) + B * 4
            + 8 * int(torch.unique(rows).numel())
            + 8 * int(torch.unique(cells).numel()))


def gather_bytes(n_rows: int, row_bytes: int, ids: torch.Tensor) -> int:
    """Bytes a row gather needs: each distinct in-range row read once,
    the output written once, the ids read once."""
    ok = ids[(ids >= 0) & (ids < n_rows)]
    distinct = int(torch.unique(ok).numel())
    return distinct * row_bytes + ids.numel() * row_bytes + 4 * ids.numel()


def aggregate_bytes(n_nodes: int, n_edges: int, width: int,
                    elt: int) -> int:
    """Bytes a whole-graph weighted sum needs: the table [N, D] read
    once, a source id (4 B) for every edge and a weight (4 B) for every
    edge and self loop read once, the output [N, D] written once."""
    return (2 * n_nodes * width * elt + 4 * n_edges
            + 4 * (n_edges + n_nodes))
