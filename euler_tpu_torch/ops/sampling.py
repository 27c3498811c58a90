"""Root and neighbor sampling: the weighted node draw, the fan-row
neighbor draw and the reservoir redraw.

Counterparts of euler_tpu/ops/sampling.py's ``sample_node`` (:46-72),
the K=1 branch of ``sample_neighbor_fast`` (one edge type per hop, the
GraphSAGE flows) and ``refresh_fan_rows``/``refresh_fan_pack`` with
``over_rows`` (:379-461). The reference derives its uniforms from a jax
PRNG key inside each verb; here each verb is split in two so that both
packages can be fed the same numbers: a step that draws the uniforms
from a torch.Generator (``draw_node_uniforms``, ``draw_fan_uniforms``,
``draw_alias_uniforms``), and a deterministic select from given uniforms
(``select_nodes``, ``select_fan_neighbors``, ``refresh_fan_rows``). The
union-row and multi-type (K>1) branches are not ported.
Matches Node::SampleNeighbor's weighted-with-replacement distribution
(reference: euler/core/graph/node.h:82) exactly for groups of degree
<= FAN_D; larger groups draw from an exact-marginal reservoir.

Conventions: node ids are int32 local ids, ``-1`` marks "no node", and
missing neighbors get ``default_id``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       alias_select, draw_alias_uniforms)
from euler_tpu_torch.ops.fan_draw import fan_draw


def as_etypes(g: GraphTensors, edge_types) -> Tuple[int, ...]:
    if isinstance(edge_types, (int, str)):
        edge_types = (edge_types,)
    return tuple(g.meta.edge_type_id(t) for t in edge_types)


# ---------------------------------------------------------------------------
# global node sampling (alias tables)
# ---------------------------------------------------------------------------

def draw_node_uniforms(generator: Optional[torch.Generator], count: int,
                       device) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(u_type, u1, u2), each f32 [count] in [0, 1): the type pick of
    ``node_type=-1`` and the alias draw's two uniforms."""
    u_type = torch.rand((count,), generator=generator, device=device)
    return (u_type,) + draw_alias_uniforms(generator, (count,), device)


def select_nodes(g: GraphTensors, node_type, u_type: torch.Tensor,
                 u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Deterministic weighted node draws from given uniforms; int32
    [count] node ids, -1 where the drawn type has no node.

    ``node_type=-1`` picks a type per draw in proportion to the per-type
    weight sums (``u_type * cumsum(w_sum)[-1]``, searchsorted to the
    right, clamped to the last type), then draws from its table.
    """
    na = g.node_alias
    if isinstance(node_type, str):
        node_type = g.meta.node_type_id(node_type)
    if node_type == -1:
        cdf = torch.cumsum(na.w_sum, 0)
        r = u_type * cdf[-1]
        t = torch.searchsorted(cdf, r, right=True)
        t = t.clamp_max(na.w_sum.shape[0] - 1)
        lo = na.type_ptr[t]
        size = na.type_ptr[t + 1] - lo
    else:
        lo = na.type_ptr[node_type]
        size = na.type_ptr[node_type + 1] - lo
    pos = alias_select(na.prob, na.alias, lo, size, u1, u2)
    return torch.where(pos >= 0, na.ids[pos.clamp_min(0).long()], -1)


def sample_node(g: GraphTensors, count: int, node_type=-1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weighted global node sampling (reference: API_SAMPLE_NODE via
    per-type alias tables); int32 [count]."""
    return select_nodes(g, node_type,
                        *draw_node_uniforms(generator, count, g.device))


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


def select_fan_neighbors(g: GraphTensors, nodes: torch.Tensor, et: int,
                         u1: torch.Tensor, u2: torch.Tensor,
                         default_id: int = -1):
    """Deterministic weighted draws of edge type ``et`` from given
    uniforms; returns (ids int32 [B, C], valid bool [B, C])."""
    if g.fan_pack is None:
        raise ValueError("the graph was built without the 'fan' pack")
    return fan_draw(g.fan_pack, nodes.to(torch.int32).contiguous(), et,
                    g.meta.num_edge_types, u1.contiguous(), u2.contiguous(),
                    default_id)



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
    """Redraw the reservoir rows of ``g.fan_pack`` in place.

    Groups with degree > FAN_D hold FAN_D precomputed i.i.d. draws;
    calling this every ``RunConfig.reservoir_refresh`` steps re-randomizes
    them so long runs see the full neighborhood of high-degree nodes.
    """
    if g.fan_pack is not None:
        K = g.fan_over_rows.shape[0]
        u1, u2 = draw_alias_uniforms(generator, (K, FAN_D), g.device)
        refresh_fan_rows(g.group_ptr, g.adj_dst, g.adj_prob, g.adj_alias,
                         g.fan_pack, g.fan_over_rows, u1, u2)
    return g
