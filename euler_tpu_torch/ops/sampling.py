"""Root and neighbor sampling: the weighted node and edge draws, the
fan-row neighbor draw and the reservoir redraw.

Counterparts of euler_tpu/ops/sampling.py's ``sample_node`` (:46-72),
``sample_edge`` (:94-123),
``sample_neighbor_fast`` (:223-376: its K=1, union-row and per-type K>1
branches, with ``return_types``) and ``refresh_fan_rows``/
``refresh_fan_pack`` with ``over_rows`` (:379-461), and the full
neighborhood ``get_full_neighbor`` (:464-528). The reference derives
its uniforms from a jax PRNG key inside each verb; here each verb is
split in two so that both packages can be fed the same numbers: a step
that draws the uniforms from a torch.Generator (``draw_node_uniforms``,
``draw_edge_uniforms``, ``draw_fan_uniforms``, ``draw_typed_uniforms``,
``draw_alias_uniforms``, and ``draw_neighbor_uniforms`` for a hop), and
a deterministic select from given uniforms (``select_nodes``,
``select_edges``, ``select_fan_neighbors``, ``select_typed_neighbors``,
``select_neighbors`` for a hop, ``refresh_fan_rows``).
Matches Node::SampleNeighbor's weighted-with-replacement distribution
(reference: euler/core/graph/node.h:82) exactly for groups of degree
<= FAN_D; larger groups draw from an exact-marginal reservoir.

A hop over one edge type reads ``fan_pack``; a hop over every edge type
of the graph reads the union rows ``fanu_pack`` when the graph has them;
any other multi-type hop reads one fan row per type (plain torch, as the
reference does it in XLA). Where the reference falls back to the payload
verb ``sample_neighbor`` (the graph lacks the pack a hop needs), the port
raises ``NotImplementedError``: that verb is not ported.

Conventions: node ids are int32 local ids, ``-1`` marks "no node", and
missing neighbors get ``default_id``. An index past the end of a table
clamps to its last row, as XLA clamps a gather index (torch would raise).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from euler_tpu_torch.graph.store import AliasTables, GraphTensors
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FAN_PROB_OFF, alias_select,
                                       draw_alias_uniforms)
from euler_tpu_torch.ops.fan_draw import fan_draw


def as_etypes(g: GraphTensors, edge_types) -> Tuple[int, ...]:
    if isinstance(edge_types, (int, str)):
        edge_types = (edge_types,)
    return tuple(g.meta.edge_type_id(t) for t in edge_types)


@functools.lru_cache(maxsize=64)
def etype_tensor(ets: Tuple[int, ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The edge-type ids ``ets`` as a tensor on ``device``, built once per
    (ets, dtype, device) and shared: never write to it. A step that a
    CUDA graph captures may not copy a Python list to the card, so the
    copy happens at the first, eager call."""
    return torch.tensor(ets, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# global node and edge sampling (alias tables)
# ---------------------------------------------------------------------------

def draw_node_uniforms(generator: Optional[torch.Generator], count: int,
                       device) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(u_type, u1, u2), each f32 [count] in [0, 1): the type pick of
    ``node_type=-1`` and the alias draw's two uniforms."""
    u_type = torch.rand((count,), generator=generator, device=device)
    return (u_type,) + draw_alias_uniforms(generator, (count,), device)


#: (u_type, u1, u2) of ``count`` edge draws, as for nodes
draw_edge_uniforms = draw_node_uniforms


def _select_typed(at: AliasTables, t: int, u_type: torch.Tensor,
                  u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Members of ``at`` drawn from given uniforms; int32, -1 where the
    drawn type is empty.

    ``t=-1`` picks a type per draw in proportion to the per-type weight
    sums (``u_type * cdf[-1]`` searched to the right in ``cdf``, clamped
    to the last type), then draws from its table; ``u_type`` is read
    only then.
    """
    if t == -1:
        r = u_type * at.cdf[-1]
        t = torch.searchsorted(at.cdf, r, right=True)
        t = t.clamp_max(at.w_sum.shape[0] - 1)
    lo = at.type_ptr[t]
    size = at.type_ptr[t + 1] - lo
    pos = alias_select(at.prob, at.alias, lo, size, u1, u2)
    return torch.where(pos >= 0, at.ids[pos.clamp_min(0).long()], -1)


def select_nodes(g: GraphTensors, node_type, u_type: torch.Tensor,
                 u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Deterministic weighted node draws from given uniforms; int32
    [count] node ids, -1 where the drawn type has no node.
    ``node_type`` is a type id, a name, or -1 for a draw over every type
    in proportion to the per-type weight sums."""
    if isinstance(node_type, str):
        node_type = g.meta.node_type_id(node_type)
    return _select_typed(g.node_alias, node_type, u_type, u1, u2)


def sample_node(g: GraphTensors, count: int, node_type=-1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weighted global node sampling (reference: API_SAMPLE_NODE via
    per-type alias tables); int32 [count]."""
    return select_nodes(g, node_type,
                        *draw_node_uniforms(generator, count, g.device))


def select_edges(g: GraphTensors, edge_type, u_type: torch.Tensor,
                 u1: torch.Tensor, u2: torch.Tensor):
    """Deterministic weighted edge draws from given uniforms over the
    per-edge-type alias tables of the CSR slots (``g.edge_alias``).
    ``edge_type`` is a type id, a name, or -1 for a draw over every type.
    Returns (src, dst, etype, eid), each int32 [count], -1 where the
    drawn type has no edge."""
    if isinstance(edge_type, str):
        edge_type = g.meta.edge_type_id(edge_type)
    slot = _select_typed(g.edge_alias, edge_type, u_type, u1, u2)
    ok = slot >= 0
    s = slot.clamp_min(0).long()
    return tuple(torch.where(ok, f[s], -1)
                 for f in (g.adj_src, g.adj_dst, g.adj_type, g.adj_eid))


def sample_edge(g: GraphTensors, count: int, edge_type=-1,
                generator: Optional[torch.Generator] = None):
    """Weighted global edge sampling (reference: API_SAMPLE_EDGE);
    (src, dst, etype, eid), each int32 [count]."""
    return select_edges(g, edge_type,
                        *draw_edge_uniforms(generator, count, g.device))


# ---------------------------------------------------------------------------
# neighbor sampling over the fan rows
# ---------------------------------------------------------------------------

def draw_fan_uniforms(generator: Optional[torch.Generator], B: int,
                      count: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(u1, u2), each f32 [B, count] in [0, 1): the slot pick and the
    keep-vs-alias test of ``count`` draws for each of B nodes."""
    u1 = torch.rand((B, count), generator=generator, device=device)
    u2 = torch.rand((B, count), generator=generator, device=device)
    return u1, u2


def uses_union(g: GraphTensors, ets: Tuple[int, ...]) -> bool:
    """True where a hop over ``ets`` reads the union rows: more than one
    type, every type of the graph, and the ``fanu`` pack built."""
    return (g.fanu_pack is not None and len(ets) > 1
            and sorted(ets) == list(range(g.meta.num_edge_types)))


def _need_fan_pack(g: GraphTensors, ets: Tuple[int, ...]) -> None:
    if g.fan_pack is None:
        raise NotImplementedError(
            f"a hop over edge types {ets} reads the 'fan' pack (or 'fanu' "
            f"for a hop over every type), which the graph was built "
            f"without; the reference's fallback, the payload verb "
            f"sample_neighbor, is not ported")


def select_fan_neighbors(g: GraphTensors, nodes: torch.Tensor, edge_types,
                         u1: torch.Tensor, u2: torch.Tensor,
                         default_id: int = -1, return_types: bool = False):
    """Deterministic weighted draws from given uniforms through the
    ``fan_draw`` kernel: over ``fan_pack`` for one edge type, over the
    union rows for a hop over every type (``uses_union``). Returns (ids
    int32 [B, C], valid bool [B, C]) and, with ``return_types``, each
    draw's edge type (int32, -1 where invalid)."""
    ets = as_etypes(g, edge_types)
    nodes = nodes.to(torch.int32).contiguous()
    if uses_union(g, ets):
        return fan_draw(g.fanu_pack, nodes, 0, 1, u1.contiguous(),
                        u2.contiguous(), default_id, union=True,
                        return_types=return_types)
    if len(ets) != 1:
        raise ValueError(f"select_fan_neighbors draws one edge type or the "
                         f"union rows, not {ets}: see select_neighbors")
    _need_fan_pack(g, ets)
    return fan_draw(g.fan_pack, nodes, ets[0], g.meta.num_edge_types,
                    u1.contiguous(), u2.contiguous(), default_id,
                    return_types=return_types)


def draw_typed_uniforms(generator: Optional[torch.Generator], B: int,
                        count: int, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]:
    """(ut, u1, u2), each f32 [B, count] in [0, 1): the type pick of a
    multi-type draw, then the slot pick and the keep-vs-alias test (the
    reference's ``kt, kd = split(key); k1, k2 = split(kd)``)."""
    ut = torch.rand((B, count), generator=generator, device=device)
    return (ut,) + draw_fan_uniforms(generator, B, count, device)


def select_typed_neighbors(g: GraphTensors, nodes: torch.Tensor, edge_types,
                           ut: torch.Tensor, u1: torch.Tensor,
                           u2: torch.Tensor, default_id: int = -1,
                           return_types: bool = False):
    """Deterministic multi-type draws over one fan row per (node, type):
    the K>1 branch of the reference (sampling.py:344-376), plain torch.

    Each draw picks a type in proportion to the node's per-type weight
    sums (``r = ut * total`` against their running sum, added left to
    right as XLA's cumsum does: torch.cumsum associates otherwise), then
    draws in that type's row. Out-of-range row indices clamp, as XLA's
    gather does. Returns what ``select_fan_neighbors`` returns.
    """
    ets = as_etypes(g, edge_types)
    _need_fan_pack(g, ets)
    K, ET = len(ets), g.meta.num_edge_types
    G = g.fan_pack.shape[0]
    et = etype_tensor(ets, torch.int64, nodes.device)
    rows = nodes.to(torch.int64).clamp_min(0)
    packs = g.fan_pack[(rows[:, None] * ET + et[None, :]).clamp_max(G - 1)]
    deg = packs[..., 0]                                        # [B, K]
    wsum = packs[..., 1].contiguous().view(torch.float32)      # [B, K]
    run = [wsum[:, 0]]
    for k in range(1, K):
        run.append(run[-1] + wsum[:, k])
    cdf = torch.stack(run, 1)                                  # [B, K]
    total = cdf[:, -1]
    r = ut * total[:, None]
    kidx = (r[:, :, None] >= cdf[:, None, :]).sum(-1).clamp_max(K - 1)
    deg_c = torch.gather(deg, 1, kidx)
    slot = torch.minimum((u1 * deg_c.to(torch.float32)).to(torch.int32),
                         (deg_c - 1).clamp_min(0))
    # lane (kidx, off + slot) of the node's K gathered rows
    lane = kidx * packs.shape[-1] + slot.clamp(0, FAN_D - 1).long()
    flat = packs.reshape(packs.shape[0], -1)                   # [B, K*128]

    def pick(off):
        return torch.gather(flat, 1, off + lane)

    prob = pick(FAN_PROB_OFF).view(torch.float32)
    draw = torch.where(u2 < prob, pick(FAN_KEPT_OFF), pick(FAN_ALIAS_OFF))
    valid = (nodes >= 0)[:, None] & (deg_c > 0) & (total > 0)[:, None]
    ids = torch.where(valid, draw, default_id)
    if not return_types:
        return ids, valid
    return ids, valid, torch.where(valid, et.to(torch.int32)[kidx], -1)


def draw_neighbor_uniforms(g: GraphTensors, edge_types,
                           generator: Optional[torch.Generator], B: int,
                           count: int, device) -> Tuple[torch.Tensor, ...]:
    """The uniforms one hop over ``edge_types`` reads: (u1, u2) for one
    type and for the union rows, (ut, u1, u2) for a per-type multi-type
    hop. Raises NotImplementedError where the graph lacks the pack."""
    ets = as_etypes(g, edge_types)
    union = uses_union(g, ets)
    if not union:
        _need_fan_pack(g, ets)
    if union or len(ets) == 1:
        return draw_fan_uniforms(generator, B, count, device)
    return draw_typed_uniforms(generator, B, count, device)


def select_neighbors(g: GraphTensors, nodes: torch.Tensor, edge_types,
                     uniforms: Sequence[torch.Tensor], default_id: int = -1,
                     return_types: bool = False):
    """One hop of ``sample_neighbor_fast`` from the uniforms that
    ``draw_neighbor_uniforms`` gives for it."""
    ets = as_etypes(g, edge_types)
    want = 2 if len(ets) == 1 or uses_union(g, ets) else 3
    if len(uniforms) != want:
        raise ValueError(f"a hop over edge types {ets} reads {want} uniform "
                         f"tensors, got {len(uniforms)}")
    fn = select_fan_neighbors if want == 2 else select_typed_neighbors
    return fn(g, nodes, ets, *uniforms, default_id=default_id,
              return_types=return_types)


# ---------------------------------------------------------------------------
# reservoir redraw of the fan rows
# ---------------------------------------------------------------------------

def refresh_fan_rows(group_ptr: torch.Tensor, adj_dst: torch.Tensor,
                     adj_prob: torch.Tensor, adj_alias: torch.Tensor,
                     fan_pack: torch.Tensor, over_rows: torch.Tensor,
                     u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Redraw the reservoir rows ``over_rows`` (int32 [K], the groups of
    degree > FAN_D) of ``fan_pack`` from uniforms u1, u2 (f32 [K, FAN_D]).

    Each of the FAN_D draws of a row is an exact alias draw from the
    group's CSR segment, written to both the kept and the alias lane of
    its slot. Unlike the reference, which returns a new pack, the pack is
    rewritten in place (it is 102 MB at bench size) and returned. Nothing
    else of the pack changes.
    """
    K = over_rows.shape[0]
    if K == 0:
        return fan_pack
    E = adj_dst.shape[0]
    rows = over_rows.long()
    lo = group_ptr[rows][:, None]
    deg = (group_ptr[rows + 1] - group_ptr[rows])[:, None]
    slot = torch.minimum(
        (u1 * deg.clamp_min(1).to(torch.float32)).to(torch.int32),
        (deg - 1).clamp_min(0))
    idx = (lo + slot).long().clamp(0, E - 1)
    keep = u2 < adj_prob[idx]
    alias_idx = (lo + adj_alias[idx]).long().clamp(0, E - 1)
    draw = torch.where(keep, adj_dst[idx], adj_dst[alias_idx])
    fan_pack[rows, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D] = draw
    fan_pack[rows, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D] = draw
    return fan_pack


def refresh_fan_pack(g: GraphTensors,
                     generator: Optional[torch.Generator] = None
                     ) -> GraphTensors:
    """Redraw the reservoir rows of ``g.fan_pack`` and of the union rows
    ``g.fanu_pack`` in place, each from a uniform pair of its own.

    Groups with degree > FAN_D hold FAN_D precomputed i.i.d. draws;
    calling this every ``RunConfig.reservoir_refresh`` steps re-randomizes
    them so long runs see the full neighborhood of high-degree nodes.
    """
    for pack, over, csr in (
            (g.fan_pack, g.fan_over_rows,
             (g.group_ptr, g.adj_dst, g.adj_prob, g.adj_alias)),
            (g.fanu_pack, g.fanu_over_rows,
             (g.fanu_ptr, g.fanu_dst, g.fanu_prob, g.fanu_alias))):
        if pack is not None:
            u1, u2 = draw_alias_uniforms(generator, (over.shape[0], FAN_D),
                                         g.device)
            refresh_fan_rows(*csr, pack, over, u1, u2)
    return g


# ---------------------------------------------------------------------------
# full neighborhoods
# ---------------------------------------------------------------------------

def _group_bounds(g: GraphTensors, rows: torch.Tensor, etype: torch.Tensor):
    """(lo, hi) CSR slot bounds of group (row, etype); rows and etype
    broadcast. Group indices past the graph clamp."""
    gidx = rows.long() * g.meta.num_edge_types + etype.long()
    last = g.group_ptr.shape[0] - 1
    return (g.group_ptr[gidx.clamp(0, last)],
            g.group_ptr[(gidx + 1).clamp(0, last)])


def _fetch_slots(g: GraphTensors, s: torch.Tensor, ok: torch.Tensor,
                 default_id: int):
    """(nbr, w, type, eid) of CSR slots ``s`` (in range), masked by
    ``ok``: default_id, 0, -1 and -1 where not ok."""
    nbr = torch.where(ok, g.adj_dst[s], default_id)
    w = torch.where(ok, g.adj_w[s], 0.0)
    ty = torch.where(ok, g.adj_type[s], -1)
    eid = torch.where(ok, g.adj_eid[s], -1)
    return nbr, w, ty, eid


def get_full_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                      cap: int, default_id: int = -1,
                      sorted_by_id: bool = False, offset: int = 0):
    """Padded full neighborhood over the union of edge-type groups, in
    CSR slot order (types in the order given).

    reference: euler_tpu/ops/sampling.py ``get_full_neighbor``
    (:482-528; API_GET_NB_NODE GetFullNeighbor / GetSortedFullNeighbor).
    Returns (nbr int32, w f32, type int32, eid int32, ok bool), each
    [B, cap]: positions ``offset .. offset + cap`` of the concatenated
    neighborhood; past its end (and for nodes < 0) ``ok`` is false and
    the values are default_id, 0, -1, -1. ``sorted_by_id`` orders each
    row by neighbor id, invalid cells last (a stable sort).
    """
    ets = as_etypes(g, edge_types)
    nodes = nodes.to(torch.int32)
    dev = nodes.device
    B, K = nodes.shape[0], len(ets)
    rows = nodes.clamp_min(0)
    et = etype_tensor(ets, torch.int32, dev)
    lo, hi = _group_bounds(g, rows[:, None], et[None, :])        # [B, K]
    deg = (hi - lo).long()
    offs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(deg, dim=1)], dim=1)          # [B, K+1]
    total = offs[:, -1]
    j = offset + torch.arange(cap, dtype=torch.int64, device=dev)  # [cap]
    # group k holds positions [offs[k], offs[k+1])
    k_idx = (j[None, :, None] >= offs[:, None, 1:]).sum(dim=-1)
    k_idx = k_idx.clamp_max(K - 1)
    base = torch.gather(lo.long(), 1, k_idx)
    off_k = torch.gather(offs[:, :-1], 1, k_idx)
    slot = base + (j[None, :] - off_k)
    ok = (j[None, :] < total[:, None]) & (nodes >= 0)[:, None]
    s = slot.clamp(0, g.adj_dst.shape[0] - 1)
    nbr, w, ty, eid = _fetch_slots(g, s, ok, default_id)
    if sorted_by_id:
        key = torch.where(ok, nbr, torch.iinfo(torch.int32).max)
        order = torch.argsort(key, dim=1, stable=True)
        nbr, w, ty, eid, ok = (torch.gather(x, 1, order)
                               for x in (nbr, w, ty, eid, ok))
    return nbr, w, ty, eid, ok
