"""The yardstick's arithmetic of the ``rgcn`` configuration: the
operations an R-GCN training step needs and the compulsory bytes of each
call of the typed mean kernel and of its transpose, from the
configuration's shapes alone, never from the program (``arith``'s rules).

Operations count the model's mathematics as eq. 2 of the paper writes it:
W_r h_j once for each node j and relation r whose neighbours are of j's
type (a relation reads one node type), W_root h_i once a node, and the
means' sums over every edge; the head over the roots as
``arith._head_flops`` counts it. Bytes: each array moved once (a row
read once however many edges read it: an L2 that serves repeated rows
would make a count a cell read over 100%).
"""
from __future__ import annotations

from typing import Dict, List

from benchmark.harness.arith import _head_flops, linear_flops


def _shape(cfg: dict) -> dict:
    """Node types' sizes, each relation's (target, neighbour) types, the
    edges, the widths."""
    g, m, d = cfg["graph"], cfg["model"], cfg["data"]
    sizes = dict(g["node_types"])
    rels: List[tuple] = []
    edges = 0
    for et in g["edge_types"]:
        rels.append((et["target"], et["source"]))
        if not et.get("symmetric"):
            rels.append((et["source"], et["target"]))
        edges += 2 * et["edges"]
    return dict(sizes=sizes, rels=rels, edges=edges, nodes=sum(
        sizes.values()), widths=[d["feature_dim"]] + list(m["dims"]),
        feature_type=d["feature_type"])


def rgcn_step_flops(cfg: dict) -> int:
    """A whole-graph R-GCN training step over every node: per layer from
    D_in to F, the forward's messages (2 n_j D_in F for each relation over
    its neighbours' type's n_j nodes), roots (2 N D_in F) and sums (2 E
    F); the backward's weight gradients (as the forward's products), the
    input gradients that are needed (every type's past the first layer,
    the tables' types' in the first: their messages' and root's products
    again) and the transposed sums (2 E F); then the head over the roots,
    as ``arith.gcn_step_flops`` counts it."""
    s = _shape(cfg)
    sizes, N, E = s["sizes"], s["nodes"], s["edges"]
    total = 0
    for layer, (d_in, f) in enumerate(zip(s["widths"][:-1], s["widths"][1:])):
        rows: Dict[str, int] = {t: 1 for t in sizes}        # the roots
        for _, nbr in s["rels"]:
            rows[nbr] += 1
        fwd = sum(linear_flops(sizes[t] * k, d_in, f) for t, k in rows.items())
        sums = 2 * E * f
        dx = sum(linear_flops(sizes[t] * k, d_in, f) for t, k in rows.items()
                 if layer > 0 or t != s["feature_type"])
        total += fwd + sums + fwd + dx + sums
    return total + _head_flops(cfg["train"]["batch"], s["widths"][-1],
                               cfg["data"]["classes"])


def call_bytes(cfg: dict, transpose: bool, elt: int) -> int:
    """Compulsory bytes of one call of the typed mean kernel at the
    configuration's shapes (every layer's messages are F wide): the
    forward reads the message rows once (a row a relation and neighbour,
    ``elt`` bytes an element), the roots once (f32), an id (4 B) an edge
    and the segment pointers (4 B a node and relation), and writes the
    [N, F] f32 output once; the transpose reads the cotangent [N, F]
    once (``elt`` bytes), an id an edge and the pointers, and writes the
    messages' f32 gradient rows once."""
    s = _shape(cfg)
    f, N, E = s["widths"][-1], s["nodes"], s["edges"]
    msg_rows = sum(s["sizes"][nbr] for _, nbr in s["rels"])
    ptrs = 4 * (N * len(s["rels"]) + 1)
    if transpose:
        return N * f * elt + 4 * E + ptrs + msg_rows * f * 4
    return msg_rows * f * elt + N * f * 4 + 4 * E + ptrs + N * f * 4
