"""Attribute predicates, prebuilt attribute indexes and conditional
sampling.

Counterpart of euler_tpu/ops/index.py (reference: euler/core/index/ —
the Hash/RangeSampleIndex and the DNF composition of
common_index_result.cc, read by the conditional ``sampleN(t).has(...)``
of sample_node_op.cc:65-103) on one device. A predicate is a compare
over an attribute column, giving a mask; a DNF (``[[p1, p2], [p3]]`` is
``(p1 AND p2) OR p3``) is elementwise and/or of masks; a conditional
weighted draw is one running sum of the masked weights and a search, or,
for one predicate over an attribute indexed with ``build_attr_index``,
two searches in that index.

Predicates: ``Pred(name, op, value, idx=0)``; ``name`` a dense feature
(column ``idx``), ``'node_type'``, ``'weight'`` or a binary node feature
(compared through ``store.string_hash32``); on edges a dense edge
feature, ``'edge_type'`` or ``'weight'``, in original edge-row order.
``op`` is one of ``eq ne gt ge lt le in not_in``.

Each random verb is split in two, as every verb of ops/sampling.py is: a
draw of its uniforms from a torch.Generator (``draw_indexed_uniforms``:
the reference's ``kr, kd = split(key)``, two [count] uniforms;
``draw_masked_uniforms``: one) and a deterministic select from given
uniforms (``select_indexed``, ``select_masked``, and
``select_node_with_condition``/``select_edge_with_condition``, which take
the uniforms of the branch ``draw_condition_uniforms`` names). Running
sums at draw time add in XLA's CPU order (``sampling.row_cdf`` on a
[1, L] view, on the device), never with torch.cumsum; the index's own
prefix sums are taken once on the host in float64, as the reference's.

Handed a ``parallel.sharded.ShardView``, the conditional node draw and
``query_index_ids`` route to their sharded counterparts, as the
reference's do (index.py:350, :371).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from euler_tpu_torch.graph.store import GraphTensors, string_hash32
from euler_tpu_torch.ops.dispatch import is_shard_view as _is_shard_view
from euler_tpu_torch.ops.sampling import row_cdf

_OPS = ("eq", "ne", "gt", "ge", "lt", "le", "in", "not_in")


@dataclasses.dataclass
class AttrIndex:
    """A prebuilt sorted index over one attribute column (the device
    counterpart of the reference's load-time Hash/RangeSampleIndex,
    hash_sample_index.h:41-68, range_sample_index.h): the population
    sorted by value and the prefix sums of its weights in that order, so
    that a conditional weighted draw is two searches in ``vals`` for the
    ranges and one in ``wcum`` per draw."""

    order: torch.Tensor   # int32 [M] ids sorted by value (stable)
    vals: torch.Tensor    # [M] the values, ascending
    wcum: torch.Tensor    # f32 [M+1] prefix sums of the weights, in order

    def to(self, device) -> "AttrIndex":
        return AttrIndex(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class Pred:
    name: str
    op: str
    value: Union[float, int, str, tuple]
    idx: int = 0  # column within a multi-column dense feature

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}")


def _values(p: Pred) -> tuple:
    return tuple(p.value) if isinstance(p.value, (tuple, list)) \
        else (p.value,)


def _column(g: GraphTensors, p: Pred):
    """A node attribute column [N] and the comparison values in its
    space (type names as ids, strings as hashes)."""
    vals, dev = _values(p), g.device
    if p.name == "node_type":
        ids = [g.meta.node_type_id(v) for v in vals]
        return g.node_type, torch.tensor(ids, dtype=torch.int32, device=dev)
    if p.name == "weight":
        return g.node_w, torch.tensor(vals, dtype=torch.float32, device=dev)
    if p.name in g.dense_nf:
        return (g.dense_nf[p.name][:, p.idx],
                torch.tensor(vals, dtype=torch.float32, device=dev))
    if p.name in g.binary_hash_nf:
        hashed = [string_hash32(str(v)) for v in vals]
        return (g.binary_hash_nf[p.name],
                torch.tensor(hashed, dtype=torch.int32, device=dev))
    raise KeyError(f"no indexable attribute {p.name!r}")


def index_key(name: str, idx: int = 0) -> str:
    return f"{name}:{idx}"


def build_attr_index(graph, names, target: str = "node") -> GraphTensors:
    """Index the named attributes on the host; returns the GraphTensors
    with ``node_index`` (``target="node"``) or ``edge_index_`` filled, and
    sets it on ``graph`` where that is a ``Graph``.

    ``names``: attribute names or ``(name, idx)`` pairs. Node attributes:
    dense feature columns, 'weight', 'node_type', binary features
    (hashed). Edge attributes: dense edge-feature columns, 'weight',
    'edge_type', in edge-row order. Weights are summed in float64, then
    stored as f32 (euler_tpu/ops/index.py:87-129).
    """
    g = graph.tensors if hasattr(graph, "tensors") else graph
    field = "node_index" if target == "node" else "edge_index_"
    out = dict(getattr(g, field))
    for spec in names:
        name, idx = spec if isinstance(spec, tuple) else (spec, 0)
        if target == "node":
            col, _ = _column(g, Pred(name, "eq", 0, idx))
            w = g.node_w.cpu().numpy().astype(np.float64)
        else:
            col = _edge_column(g, Pred(name, "eq", 0, idx))
            # edge-row weights, as the columns are in edge-row order
            w = g.adj_w[g.eid_slot.long()].cpu().numpy().astype(np.float64)
        col = col.cpu()
        order = np.argsort(col.numpy(), kind="stable")
        wcum = np.concatenate([[0.0], np.cumsum(w[order])])
        out[index_key(name, idx)] = AttrIndex(
            order=torch.from_numpy(order.astype(np.int32)),
            vals=col[torch.from_numpy(order)],
            wcum=torch.from_numpy(wcum.astype(np.float32))).to(g.device)
    t = dataclasses.replace(g, **{field: out})
    if hasattr(graph, "tensors"):
        graph.tensors = t
    return t


def _norm_vals(g: GraphTensors, p: Pred, target: str) -> tuple:
    """The comparison values in the indexed column's space (type names as
    ids, binary strings as hashes)."""
    vals = _values(p)
    if target == "node" and p.name == "node_type":
        return tuple(g.meta.node_type_id(v) if isinstance(v, str) else v
                     for v in vals)
    if target == "edge" and p.name == "edge_type":
        return tuple(g.meta.edge_type_id(v) if isinstance(v, str) else v
                     for v in vals)
    if target == "node" and p.name in g.binary_hash_nf:
        return tuple(string_hash32(str(v)) for v in vals)
    return vals


def _index_ranges(ai: AttrIndex, p: Pred, vals):
    """The sorted-position ranges of ``ai`` that match ``p``: (lo, hi),
    each int32 [R]."""
    M, dev = ai.vals.shape[0], ai.vals.device
    v = torch.tensor(vals, dtype=ai.vals.dtype, device=dev)

    def search(x, right=False):
        return torch.searchsorted(ai.vals, x, right=right).to(torch.int32)

    left, right = search(v), search(v, right=True)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    end = torch.full((1,), M, dtype=torch.int32, device=dev)
    if p.op == "eq":
        return left[:1], right[:1]
    if p.op == "in":
        return left, right
    if p.op == "ge":
        return left[:1], end
    if p.op == "gt":
        return right[:1], end
    if p.op == "le":
        return zero, right[:1]
    if p.op == "lt":
        return zero, left[:1]
    if p.op == "ne":
        return torch.cat([zero, right[:1]]), torch.cat([left[:1], end])
    if p.op == "not_in":
        vs = torch.sort(v)[0]
        return (torch.cat([zero, search(vs, right=True)]),
                torch.cat([search(vs), end]))
    raise AssertionError(p.op)


def draw_indexed_uniforms(generator: Optional[torch.Generator], count: int,
                          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_range, u_draw), each f32 [count] in [0, 1): the range pick and
    the draw inside it of ``select_indexed`` (the reference's ``kr, kd``)."""
    return tuple(torch.rand((count,), generator=generator, device=device)
                 for _ in range(2))


def select_indexed(g: GraphTensors, p: Pred, uniforms,
                   target: str = "node") -> torch.Tensor:
    """Conditional weighted draws through the prebuilt ``AttrIndex`` of
    ``p``'s attribute, from the uniforms ``draw_indexed_uniforms`` gives
    (reference: index.py:185-207): a range in proportion to its weight,
    then a position inside it by its prefix sums. Returns int32 [count]
    ids (edge rows for ``target="edge"``), -1 where the matching set
    weighs 0."""
    tab = g.node_index if target == "node" else g.edge_index_
    ai = tab[index_key(p.name, p.idx)]
    u_range, u_draw = uniforms
    lo, hi = _index_ranges(ai, p, _norm_vals(g, p, target))
    hi = torch.maximum(hi, lo)
    mass = ai.wcum[hi.long()] - ai.wcum[lo.long()]               # [R]
    cdf = row_cdf(mass[None])[0]
    total = cdf[-1]
    ridx = torch.searchsorted(cdf, u_range * total, right=True)
    ridx = ridx.clamp_max(lo.shape[0] - 1)
    rlo, rhi = lo[ridx], hi[ridx]
    base = ai.wcum[rlo.long()]
    tgt = base + u_draw * (ai.wcum[rhi.long()] - base)
    pos = torch.searchsorted(ai.wcum, tgt, right=True).to(torch.int32) - 1
    pos = torch.minimum(torch.maximum(pos, rlo),
                        torch.maximum(rhi - 1, rlo))
    return torch.where(total > 0, _rows(ai.order, pos), -1)


def indexed_sample(g: GraphTensors, count: int, p: Pred,
                   target: str = "node",
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``count`` conditional weighted draws through the index of ``p``'s
    attribute; see ``select_indexed``."""
    return select_indexed(g, p, draw_indexed_uniforms(generator, count,
                                                      g.device), target)


def _edge_column(g: GraphTensors, p: Pred) -> torch.Tensor:
    """An edge attribute column [E] in original edge-row order."""
    if p.name == "edge_type":
        return g.eid_type
    if p.name == "weight":
        return g.adj_w[g.eid_slot.long()]
    if p.name in g.dense_ef:
        return g.dense_ef[p.name][:, p.idx]
    raise KeyError(f"no indexable edge attribute {p.name!r}")


def _cmp(col: torch.Tensor, v: torch.Tensor, op: str) -> torch.Tensor:
    if op == "eq":
        return col == v[0]
    if op == "ne":
        return col != v[0]
    if op == "gt":
        return col > v[0]
    if op == "ge":
        return col >= v[0]
    if op == "lt":
        return col < v[0]
    if op == "le":
        return col <= v[0]
    if op == "in":
        return torch.isin(col, v)
    if op == "not_in":
        return ~torch.isin(col, v)
    raise AssertionError(op)


def _rows(col: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``col`` at ``ids`` with ids < 0 read as 0 and ids past the end
    clamped, as the reference's ``col[jnp.maximum(ids, 0)]`` reads."""
    return col[ids.long().clamp(0, col.shape[0] - 1)]


def edge_pred_mask(g: GraphTensors, p: Pred, eids: torch.Tensor
                   ) -> torch.Tensor:
    """``p`` over the edges ``eids`` (edge rows), false for eids < 0: a
    gather of the column at the given rows (reference: index.py:248-258)."""
    vals = _values(p)
    if p.name == "edge_type" and isinstance(vals[0], str):
        vals = tuple(g.meta.edge_type_id(v) for v in vals)
    rows = _rows(_edge_column(g, p), eids)
    v = torch.tensor(vals, dtype=rows.dtype, device=rows.device)
    return _cmp(rows, v, p.op) & (eids >= 0)


def edge_dnf_mask(g: GraphTensors, dnf, eids: torch.Tensor) -> torch.Tensor:
    """The DNF over the edges ``eids``."""
    out = torch.zeros(eids.shape, dtype=torch.bool, device=eids.device)
    for clause in dnf:
        m = eids >= 0
        for p in clause:
            m = m & edge_pred_mask(g, p, eids)
        out = out | m
    return out


def dnf_mask_at(g: GraphTensors, dnf, ids: torch.Tensor) -> torch.Tensor:
    """The DNF over the nodes ``ids`` only: gathers of the attribute
    columns at the given ids, false for ids < 0."""
    out = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for clause in dnf:
        m = ids >= 0
        for p in clause:
            col, v = _column(g, p)
            m = m & _cmp(_rows(col, ids), v, p.op)
        out = out | m
    return out


def _indexed_pred(g: GraphTensors, dnf, type_, target: str
                  ) -> Optional[Pred]:
    """The one predicate of ``dnf`` where a conditional draw goes through a
    prebuilt index (a single predicate, no type, its attribute indexed),
    else None."""
    tab = g.node_index if target == "node" else g.edge_index_
    if len(dnf) == 1 and len(dnf[0]) == 1 and type_ == -1 and \
            index_key(dnf[0][0].name, dnf[0][0].idx) in tab:
        return dnf[0][0]
    return None


def _edge_type_id(g: GraphTensors, edge_type):
    return g.meta.edge_type_id(edge_type) if isinstance(edge_type, str) \
        else edge_type


def draw_condition_uniforms(g: GraphTensors, count: int, dnf, type_=-1,
                            target: str = "node",
                            generator: Optional[torch.Generator] = None):
    """The uniforms of ``count`` conditional draws over nodes or edges:
    ``draw_indexed_uniforms``'s pair where the draw goes through a
    prebuilt index, else ``draw_masked_uniforms``'s tensor. Over a
    ShardView (nodes): (u_shard, u), member 0's shard choice and this
    shard's masked draw."""
    if _is_shard_view(g) and target == "node":
        return (draw_masked_uniforms(generator, count, g.device),
                draw_masked_uniforms(generator, count, g.device))
    if target == "edge":
        type_ = _edge_type_id(g, type_)
    if _indexed_pred(g, dnf, type_, target) is not None:
        return draw_indexed_uniforms(generator, count, g.device)
    return draw_masked_uniforms(generator, count, g.device)


def select_edge_with_condition(g: GraphTensors, dnf, edge_type, uniforms):
    """Weighted edge draws restricted to the DNF-matching edges, from the
    uniforms ``draw_condition_uniforms(..., target="edge")`` gives
    (reference: index.py:286-317): through a prebuilt edge index for a
    single predicate, else the masked running sum over every edge row.
    Returns (src, dst, type, eid), each int32 [count], -1 where nothing
    matches."""
    edge_type = _edge_type_id(g, edge_type)
    p = _indexed_pred(g, dnf, edge_type, "edge")
    if p is not None:
        eids = select_indexed(g, p, uniforms, target="edge")
    else:
        w = g.adj_w[g.eid_slot.long()]                        # edge rows
        E = w.shape[0]
        mask = edge_dnf_mask(g, dnf, torch.arange(E, dtype=torch.int32,
                                                  device=w.device))
        if edge_type != -1:
            mask = mask & (g.eid_type == edge_type)
        eids = select_masked(w * mask, uniforms)
    ok = eids >= 0
    slot = _rows(g.eid_slot, eids).long()
    return tuple(torch.where(ok, f[slot], -1)
                 for f in (g.adj_src, g.adj_dst, g.adj_type)) + (eids,)


def sample_edge_with_condition(g: GraphTensors, count: int, dnf,
                               edge_type=-1,
                               generator: Optional[torch.Generator] = None):
    """Weighted edge sampling restricted to the DNF-matching edge set; see
    ``select_edge_with_condition``."""
    return select_edge_with_condition(
        g, dnf, edge_type, draw_condition_uniforms(
            g, count, dnf, edge_type, "edge", generator))


def pred_mask(g: GraphTensors, p: Pred) -> torch.Tensor:
    """``p`` over every node: bool [N]."""
    col, v = _column(g, p)
    return _cmp(col, v, p.op)


def dnf_mask(g: GraphTensors, dnf: Sequence[Sequence[Pred]]) -> torch.Tensor:
    """OR of AND-clauses over every node: bool [N]
    (common_index_result's union and intersection)."""
    n, dev = g.node_type.shape[0], g.device
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    for clause in dnf:
        m = torch.ones(n, dtype=torch.bool, device=dev)
        for p in clause:
            m = m & pred_mask(g, p)
        out = out | m
    return out


def draw_masked_uniforms(generator: Optional[torch.Generator], count: int,
                         device) -> torch.Tensor:
    """f32 [count] uniforms in [0, 1) of ``select_masked``."""
    return torch.rand((count,), generator=generator, device=device)


def select_masked(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Draws with replacement in proportion to ``weights`` [L] from the
    uniforms ``u`` [count] (reference: index.py:334-342): ``u`` times the
    total searched to the right in the running sum, clamped to L - 1;
    int32, -1 everywhere when the total is 0. The running sum adds in
    XLA's CPU order (``row_cdf``)."""
    cdf = row_cdf(weights[None])[0]
    total = cdf[-1]
    idx = torch.searchsorted(cdf, u * total, right=True).to(torch.int32)
    idx = idx.clamp_max(weights.shape[0] - 1)
    return torch.where(total > 0, idx, -1)


def masked_weighted_sample(weights: torch.Tensor, count: int,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """``count`` draws with replacement in proportion to ``weights``; see
    ``select_masked``."""
    return select_masked(weights, draw_masked_uniforms(generator, count,
                                                       weights.device))


def select_node_with_condition(g: GraphTensors, dnf, node_type, uniforms
                               ) -> torch.Tensor:
    """Weighted node draws restricted to the DNF-matching set, from the
    uniforms ``draw_condition_uniforms`` gives (reference:
    index.py:345-367): through a prebuilt index for a single predicate
    over an indexed attribute and no node type, else the masked running
    sum over every node. int32 [count], -1 where nothing matches. Over a
    ShardView, a shard chosen in proportion to the shards' matching
    weight, then its masked draw (index.py:350)."""
    if _is_shard_view(g):
        from euler_tpu_torch.parallel import sharded
        return sharded.select_node_with_condition_sharded(g, dnf, node_type,
                                                          *uniforms)
    p = _indexed_pred(g, dnf, node_type, "node")
    if p is not None:
        return select_indexed(g, p, uniforms, target="node")
    mask = dnf_mask(g, dnf)
    if node_type != -1:
        if isinstance(node_type, str):
            node_type = g.meta.node_type_id(node_type)
        mask = mask & (g.node_type == node_type)
    return select_masked(g.node_w * mask, uniforms)


def sample_node_with_condition(g: GraphTensors, count: int,
                               dnf: Sequence[Sequence[Pred]], node_type=-1,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Weighted node sampling restricted to the DNF-matching set
    (reference: sample_node_op.cc:65-103); see
    ``select_node_with_condition``."""
    return select_node_with_condition(
        g, dnf, node_type, draw_condition_uniforms(g, count, dnf, node_type,
                                                   "node", generator))


def query_index_ids(g: GraphTensors, dnf, cap: int):
    """The matching node ids in id order, padded to ``cap`` with -1, and
    their mask (the reference's QueryIndex kernel,
    core/kernels/common.cc:79); over a ShardView, gathered from every
    shard (index.py:371)."""
    if _is_shard_view(g):
        from euler_tpu_torch.parallel import sharded
        return sharded.query_index_ids_sharded(g, dnf, cap)
    mask = dnf_mask(g, dnf)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    ids = torch.where(mask[order], order, -1)[:cap].to(torch.int32)
    return ids, ids >= 0
