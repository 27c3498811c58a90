"""The sampling verbs: the weighted node and edge draws, neighbor
draws over the fan rows, the sample pack and the alias tables, full and
top-k neighborhoods (out and in), fanouts, the layer draw, adjacency,
graph labels and node types, and the reservoir redraw.

Counterparts of every single-device verb of euler_tpu/ops/sampling.py:
``sample_node`` (:46-72), ``sample_node_with_src`` (:75-91),
``sample_edge`` (:94-123), ``sample_neighbor`` (:165-220, its
``sample_pack`` branch and its per-group alias branch),
``sample_neighbor_fast`` (:223-376: its K=1, union-row and per-type K>1
branches, with ``return_types``), ``refresh_fan_rows``/
``refresh_fan_pack`` with ``over_rows`` (:379-461), ``get_full_neighbor``
(:482-528), ``get_top_k_neighbor`` (:531-544), the in-neighbor verbs
over the in-CSR (:551-657), ``sample_fanout`` and
``get_multi_hop_neighbor`` (:660-700), ``sample_layer`` (:703-726),
``sparse_get_adj`` (:729-772), ``sample_graph_label`` and
``get_graph_by_label`` (:775-809) and ``get_node_type`` (:812-818).
Handed a ``parallel.sharded.ShardView`` in place of a ``GraphTensors``,
each verb routes to its sharded implementation where the reference's
does (:53, :80, :98, :178, :250-262, :498, :582, :613, :741, :814), and
each draw step gives the uniforms of the owner's answer (see
``neighbor_rows`` and ``draw_node_uniforms``). The
reference derives its uniforms from a jax PRNG key inside each verb;
here each random verb is split in two so that both packages can be fed
the same numbers: a step that draws the uniforms from a torch.Generator
(``draw_node_uniforms``, ``draw_edge_uniforms``, ``draw_fan_uniforms``,
``draw_typed_uniforms``, ``draw_sample_uniforms``,
``draw_alias_uniforms``, ``draw_fanout_uniforms``,
``draw_layer_uniforms``, and ``draw_neighbor_uniforms`` for a hop), and
a deterministic select from given uniforms (``select_nodes``,
``select_edges``, ``select_fan_neighbors``, ``select_typed_neighbors``,
``select_sampled_neighbors``, ``select_nodes_with_src``,
``select_in_neighbors``, ``select_fanout``, ``select_layer`` over
``layer_keys``,
``select_neighbors`` for a hop, ``refresh_fan_rows``).
Matches Node::SampleNeighbor's weighted-with-replacement distribution
(reference: euler/core/graph/node.h:82) exactly; the fan rows do so for
groups of degree <= FAN_D, larger groups draw from an exact-marginal
reservoir.

A hop of the sampled flows over one edge type reads ``fan_pack``; a hop
over every edge type of the graph reads the union rows ``fanu_pack``
when the graph has them; any other multi-type hop reads one fan row per
type. A hop that finds neither the ``fan`` pack nor, over every type,
the ``fanu`` pack draws through ``select_sampled_neighbors``, as the
reference's ``sample_neighbor_fast`` falls back to ``sample_neighbor``
(:265-268); ``hop_kind`` names the branch a hop takes.

Conventions: node ids are int32 local ids, ``-1`` marks "no node", and
missing neighbors get ``default_id``. An index past the end of a table
clamps to its last row, as XLA clamps a gather index (torch would raise).
A per-row running sum over edge types is added in XLA's order
(``row_cdf``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from euler_tpu_torch.graph.store import (XLA_CUMSUM_BLOCK, AliasTables,
                                         GraphTensors)
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FAN_PROB_OFF, alias_select,
                                       draw_alias_uniforms)
from euler_tpu_torch.ops.dispatch import is_shard_view as _is_shard_view
from euler_tpu_torch.ops.fan_draw import fan_draw


def _sharded():
    from euler_tpu_torch.parallel import sharded
    return sharded


def neighbor_rows(g, B: int, spread: bool = False) -> int:
    """The leading dim of a neighbor draw's uniforms over B query rows:
    B on one device; over a ShardView the rows the owner answers
    (``sharded.sampler_rows``), or S*B for a verb that always spreads
    (``spread``: the in-neighbor draw and the same-type negatives)."""
    if not _is_shard_view(g):
        return B
    if spread:
        return g.num_shards * B
    return _sharded().sampler_rows(g, B)


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


def row_cdf(w: torch.Tensor) -> torch.Tensor:
    """Each row's f32 running sum of ``w`` [B, K], in the order XLA adds
    ``jnp.cumsum(w, axis=1)`` on the CPU: left to right for up to 16
    columns; past that, left to right inside blocks of 16, each block
    offset by the running sum of the earlier blocks' totals, taken the
    same way (the per-row form of ``graph.store.xla_cumsum``).
    torch.cumsum associates otherwise. Runs on ``w``'s device with no
    copy from the host, so a captured step can use it."""
    B, K = w.shape
    block = XLA_CUMSUM_BLOCK
    if K <= block:
        run = [w[:, 0]]
        for k in range(1, K):
            run.append(run[-1] + w[:, k])
        return torch.stack(run, 1)
    m = -(-K // block)
    x = torch.nn.functional.pad(w, (0, m * block - K)).reshape(B, m, block)
    run = [x[:, :, 0]]
    for k in range(1, block):
        run.append(run[-1] + x[:, :, k])
    inner = torch.stack(run, 2)                                # [B, m, 16]
    before = torch.nn.functional.pad(row_cdf(inner[:, :-1, -1]), (1, 0))
    return (inner + before[:, :, None]).reshape(B, m * block)[:, :K]


def _pick_types(w: torch.Tensor, ut: torch.Tensor):
    """The type pick of a multi-type draw: each draw's column of ``w``
    [B, K] (per-type weight sums), in proportion to them (``r = ut *
    total`` counted against the running sums, clamped to K - 1). Returns
    (kidx int64 [B, C], total f32 [B])."""
    cdf = row_cdf(w)
    total = cdf[:, -1]
    r = ut * total[:, None]
    kidx = (r[:, :, None] >= cdf[:, None, :]).sum(-1)
    return kidx.clamp_max(w.shape[1] - 1), total


# ---------------------------------------------------------------------------
# global node and edge sampling (alias tables)
# ---------------------------------------------------------------------------

def draw_node_uniforms(generator: Optional[torch.Generator], count: int,
                       device, g=None) -> Tuple[torch.Tensor, ...]:
    """(u_type, u1, u2), each f32 [count] in [0, 1): the type pick of
    ``node_type=-1`` and the alias draw's two uniforms. For a ShardView
    ``g``: (u_type, u_shard, u1, u2), where member 0's type pick and
    shard choice win (the select shares them) and each shard's u1, u2
    draw inside it."""
    u_type = torch.rand((count,), generator=generator, device=device)
    if _is_shard_view(g):
        u_type = (u_type, torch.rand((count,), generator=generator,
                                     device=device))
    else:
        u_type = (u_type,)
    return u_type + draw_alias_uniforms(generator, (count,), device)


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
                 u1: torch.Tensor, u2: torch.Tensor, *more) -> torch.Tensor:
    """Deterministic weighted node draws from given uniforms; int32
    [count] node ids, -1 where the drawn type has no node.
    ``node_type`` is a type id, a name, or -1 for a draw over every type
    in proportion to the per-type weight sums."""
    if _is_shard_view(g):
        return _sharded().select_nodes_sharded(g, node_type, u_type, u1,
                                               u2, *more)
    if more:
        raise ValueError("select_nodes on one device reads (u_type, u1, "
                         "u2)")
    if isinstance(node_type, str):
        node_type = g.meta.node_type_id(node_type)
    return _select_typed(g.node_alias, node_type, u_type, u1, u2)


def sample_node(g: GraphTensors, count: int, node_type=-1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weighted global node sampling (reference: API_SAMPLE_NODE via
    per-type alias tables); int32 [count]."""
    return select_nodes(g, node_type,
                        *draw_node_uniforms(generator, count, g.device, g))


def select_edges(g: GraphTensors, edge_type, u_type: torch.Tensor,
                 u1: torch.Tensor, u2: torch.Tensor, *more):
    """Deterministic weighted edge draws from given uniforms over the
    per-edge-type alias tables of the CSR slots (``g.edge_alias``).
    ``edge_type`` is a type id, a name, or -1 for a draw over every type.
    Returns (src, dst, etype, eid), each int32 [count], -1 where the
    drawn type has no edge."""
    if _is_shard_view(g):
        return _sharded().select_edges_sharded(g, edge_type, u_type, u1, u2,
                                               *more)
    if more:
        raise ValueError("select_edges on one device reads (u_type, u1, "
                         "u2)")
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
                        *draw_edge_uniforms(generator, count, g.device, g))


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


def hop_kind(g: GraphTensors, ets: Tuple[int, ...]) -> str:
    """The branch of ``sample_neighbor_fast`` that a hop over ``ets``
    takes on ``g``: "union" (the ``fanu`` rows), "fan" (one fan row, one
    type), "typed" (one fan row per type) or "sampled" (neither pack:
    ``select_sampled_neighbors``). The "fan" and "union" hops read the
    uniforms (u1, u2), the others (ut, u1, u2)."""
    if uses_union(g, ets):
        return "union"
    if g.fan_pack is None:
        return "sampled"
    return "fan" if len(ets) == 1 else "typed"


def _fan_rows(g: GraphTensors) -> torch.Tensor:
    if g.fan_pack is None:
        raise ValueError("the graph has no 'fan' pack: select_neighbors "
                         "draws such a hop through select_sampled_neighbors")
    return g.fan_pack


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
    return fan_draw(_fan_rows(g), nodes, ets[0], g.meta.num_edge_types,
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
    sums (``_pick_types``), then draws in that type's row. Out-of-range
    row indices clamp, as XLA's gather does. Returns what
    ``select_fan_neighbors`` returns.
    """
    ets = as_etypes(g, edge_types)
    fan = _fan_rows(g)
    ET = g.meta.num_edge_types
    G = fan.shape[0]
    et = etype_tensor(ets, torch.int64, nodes.device)
    rows = nodes.to(torch.int64).clamp_min(0)
    packs = fan[(rows[:, None] * ET + et[None, :]).clamp_max(G - 1)]
    deg = packs[..., 0]                                        # [B, K]
    wsum = packs[..., 1].contiguous().view(torch.float32)      # [B, K]
    kidx, total = _pick_types(wsum, ut)
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
    """The uniforms one hop over ``edge_types`` reads: (u1, u2) for a
    "fan" or "union" hop, (ut, u1, u2) for a "typed" hop and for a
    "sampled" one (``hop_kind``; ``draw_sample_uniforms``). Over a
    ShardView, of the rows the owner answers (``neighbor_rows``)."""
    B = neighbor_rows(g, B)
    if hop_kind(g, as_etypes(g, edge_types)) in ("fan", "union"):
        return draw_fan_uniforms(generator, B, count, device)
    return draw_typed_uniforms(generator, B, count, device)


def select_neighbors(g: GraphTensors, nodes: torch.Tensor, edge_types,
                     uniforms: Sequence[torch.Tensor], default_id: int = -1,
                     return_types: bool = False):
    """One hop of ``sample_neighbor_fast`` from the uniforms that
    ``draw_neighbor_uniforms`` gives for it: (ids, valid[, types]). A
    "sampled" hop's valid is its type >= 0, as the reference's
    fallback returns it."""
    ets = as_etypes(g, edge_types)
    kind = hop_kind(g, ets)
    want = 2 if kind in ("fan", "union") else 3
    if len(uniforms) != want:
        raise ValueError(f"a hop over edge types {ets} reads {want} uniform "
                         f"tensors, got {len(uniforms)}")
    if _is_shard_view(g):
        if kind == "sampled":
            nbr, _, ty, _ = _sharded().sample_neighbor_sharded(
                g, nodes, ets, uniforms, default_id)
            return (nbr, ty >= 0, ty) if return_types else (nbr, ty >= 0)
        return _sharded().sample_neighbor_fast_sharded(
            g, nodes, ets, uniforms, default_id, return_types)
    if kind == "sampled":
        nbr, _, ty, _ = select_sampled_neighbors(g, nodes, ets, *uniforms,
                                                 default_id=default_id)
        return (nbr, ty >= 0, ty) if return_types else (nbr, ty >= 0)
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
# the general weighted draw over the grouped CSR
# ---------------------------------------------------------------------------

def _group_bounds(g: GraphTensors, rows: torch.Tensor, etype: torch.Tensor):
    """(lo, hi) CSR slot bounds of group (row, etype); rows and etype
    broadcast. Group indices past the graph clamp as XLA's gathers do:
    to the last group's row of ``group_pack`` where the graph has it (one
    row read), else to the end of ``group_ptr``."""
    gidx = rows.long() * g.meta.num_edge_types + etype.long()
    if g.group_pack is not None:
        gp = g.group_pack[gidx.clamp(0, g.group_pack.shape[0] - 1)]
        return gp[..., 0], gp[..., 1]
    last = g.group_ptr.shape[0] - 1
    return (g.group_ptr[gidx.clamp(0, last)],
            g.group_ptr[(gidx + 1).clamp(0, last)])


def _fetch_slots(g: GraphTensors, s: torch.Tensor, ok: torch.Tensor,
                 default_id: int):
    """(nbr, w, type, eid) of CSR slots ``s`` (in range), masked by
    ``ok``: default_id, 0, -1 and -1 where not ok. One row of
    ``adj_pack`` a slot where the graph has it."""
    if g.adj_pack is not None:
        pk = g.adj_pack[s]                                     # [..., 4]
        nbr, ty, eid = pk[..., 0], pk[..., 1], pk[..., 2]
        w = pk[..., 3].contiguous().view(torch.float32)
    else:
        nbr, w, ty, eid = g.adj_dst[s], g.adj_w[s], g.adj_type[s], \
            g.adj_eid[s]
    return (torch.where(ok, nbr, default_id), torch.where(ok, w, 0.0),
            torch.where(ok, ty, -1), torch.where(ok, eid, -1))


#: (u_type, u1, u2), each f32 [B, count]: the type pick, then the slot
#: pick and the keep-vs-alias test of ``sample_neighbor``'s draws (the
#: reference's ``kt, kd = split(key); k1, k2 = split(kd)``)
draw_sample_uniforms = draw_typed_uniforms


def select_sampled_neighbors(g: GraphTensors, nodes: torch.Tensor,
                             edge_types, u_type: torch.Tensor,
                             u1: torch.Tensor, u2: torch.Tensor,
                             default_id: int = -1):
    """Deterministic weighted draws with replacement over the union of the
    given edge-type groups, from the uniforms ``draw_sample_uniforms``
    gives (reference: sampling.py:165-220).

    Each draw picks a type in proportion to the node's per-type weight
    sums (``_pick_types``), then one slot of that group: a row of
    ``sample_pack`` where the graph has it (the slot ``u1 * size``
    truncated, its kept payload where ``u2 < prob``, else its alias's),
    otherwise the group's alias draw (``alias_select``) and the slot's
    payload. Returns (nbr int32, w f32, type int32, eid int32), each
    [B, count]; default_id, 0, -1 and -1 where the node is < 0, its
    weight sum 0 or the picked group empty. (The reference's third
    branch, a search over a weight cumsum for a graph without group alias
    tables, is left out: every graph that either package builds has them,
    and so does every shard of ``parallel.sharded.build_sharded``.)
    """
    ets = as_etypes(g, edge_types)
    if _is_shard_view(g):
        return _sharded().sample_neighbor_sharded(
            g, nodes, ets, (u_type, u1, u2), default_id)
    nodes = nodes.to(torch.int32)
    rows = nodes.clamp_min(0)
    et = etype_tensor(ets, torch.int64, nodes.device)
    n = g.group_w_sum.shape[0]
    W = g.group_w_sum[rows.long().clamp_max(n - 1)][:, et]    # [B, K]
    kidx, total = _pick_types(W, u_type)
    etype = et[kidx]                                           # [B, C]
    valid = (nodes >= 0)[:, None] & (total > 0)[:, None]
    lo, hi = _group_bounds(g, rows[:, None], etype)
    size = hi - lo
    if g.sample_pack is not None:
        slot = torch.minimum((u1 * size.to(torch.float32)).to(torch.int32),
                             (size - 1).clamp_min(0))
        E = g.sample_pack.shape[0]
        row = g.sample_pack[(lo + slot).long().clamp(0, E - 1)]  # [B, C, 9]
        prob = row[..., 0].contiguous().view(torch.float32)
        sel = torch.where((u2 < prob)[..., None], row[..., 1:5],
                          row[..., 5:9])
        ok = valid & (size > 0)
        w = sel[..., 3].contiguous().view(torch.float32)
        return (torch.where(ok, sel[..., 0], default_id),
                torch.where(ok, w, 0.0), torch.where(ok, sel[..., 1], -1),
                torch.where(ok, sel[..., 2], -1))
    slot = alias_select(g.adj_prob, g.adj_alias, lo, size, u1, u2)
    ok = (slot >= 0) & valid
    s = slot.long().clamp(0, g.adj_dst.shape[0] - 1)
    return _fetch_slots(g, s, ok, default_id)


def sample_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                    count: int, default_id: int = -1,
                    generator: Optional[torch.Generator] = None):
    """Sample ``count`` weighted neighbors per node from the union of the
    given edge-type groups, with replacement (reference: API_SAMPLE_NB,
    Node::SampleNeighbor): (nbr, w, type, eid), each [B, count]."""
    u = draw_sample_uniforms(generator, neighbor_rows(g, nodes.shape[0]),
                             count, nodes.device)
    return select_sampled_neighbors(g, nodes, edge_types, *u, default_id)


def select_nodes_with_src(g: GraphTensors, src_nodes: torch.Tensor,
                          u1: torch.Tensor, u2: torch.Tensor,
                          *more) -> torch.Tensor:
    """For each src node, ``count`` weighted draws of nodes of its node
    type from given uniforms u1, u2 (f32 [B, count]); int32 [B, count],
    -1 in rows of src < 0 (reference: sampling.py:75-91). Over a
    ShardView: (u_shard, u1, u2), each [S*B, count] (member 0's u_shard
    chooses the shard)."""
    if _is_shard_view(g):
        return _sharded().select_nodes_with_src_sharded(g, src_nodes, u1,
                                                        u2, *more)
    if more:
        raise ValueError("select_nodes_with_src on one device reads (u1, "
                         "u2)")
    na = g.node_alias
    src = src_nodes.to(torch.int32)
    n = g.node_type.shape[0]
    types = g.node_type[src.long().clamp(0, n - 1)].long()
    lo = na.type_ptr[types][:, None]
    size = (na.type_ptr[types + 1] - na.type_ptr[types])[:, None]
    pos = alias_select(na.prob, na.alias, lo, size, u1, u2)
    out = torch.where(pos >= 0, na.ids[pos.clamp_min(0).long()], -1)
    return torch.where((src >= 0)[:, None], out, -1)


def sample_node_with_src(g: GraphTensors, src_nodes: torch.Tensor,
                         count: int,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """For each src node, ``count`` nodes of the same node type (negative
    sampling; reference: API_SAMPLE_N_WITH_TYPES)."""
    rows = neighbor_rows(g, src_nodes.reshape(-1).shape[0], spread=True)
    u = draw_alias_uniforms(generator, (rows, count), src_nodes.device)
    if _is_shard_view(g):
        u = (torch.rand((rows, count), generator=generator,
                        device=src_nodes.device),) + u
    return select_nodes_with_src(g, src_nodes, *u)


# ---------------------------------------------------------------------------
# full neighborhoods
# ---------------------------------------------------------------------------

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
    if _is_shard_view(g):
        return _sharded().get_full_neighbor_sharded(
            g, nodes, ets, cap, default_id, sorted_by_id, offset)
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


def _top_k_rows(k: int, nbr, w, ty, eid, ok, default_id: int):
    """The ``k`` cells of each row with the largest weights, invalid cells
    last, ties to the lower column as ``jax.lax.top_k`` breaks them (a
    stable sort: torch.topk promises no order among ties); cells past the
    valid ones give default_id, 0, -1, -1."""
    neg = torch.where(ok, w, float("-inf"))
    idx = torch.sort(neg, dim=1, descending=True, stable=True)[1][:, :k]
    nbr, w, ty, eid, ok = (torch.gather(x, 1, idx)
                           for x in (nbr, w, ty, eid, ok))
    return (torch.where(ok, nbr, default_id), torch.where(ok, w, 0.0),
            torch.where(ok, ty, -1), torch.where(ok, eid, -1), ok)


def get_top_k_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                       k: int, cap: Optional[int] = None,
                       default_id: int = -1):
    """Top-k neighbors by edge weight among the first ``cap`` (default
    max(k, 16)) of the full neighborhood (reference: sampling.py:531-544,
    API_GET_NB_NODE TopK); (nbr, w, type, eid, ok), each [B, k]."""
    cap = cap or max(k, 16)
    return _top_k_rows(k, *get_full_neighbor(g, nodes, edge_types, cap,
                                             default_id), default_id)


# ---------------------------------------------------------------------------
# in-neighbor verbs over the in-CSR (graphs converted with in-edges)
# ---------------------------------------------------------------------------

def _require_in_csr(g: GraphTensors, name: str) -> None:
    if g.in_group_ptr is None:
        raise ValueError(
            f"{name} needs the in-adjacency: build the graph with "
            "has_in_edges=True (GraphMeta.has_in_edges)")


def _in_group_bounds(g: GraphTensors, rows: torch.Tensor,
                     etype: torch.Tensor):
    gidx = rows.long() * g.meta.num_edge_types + etype.long()
    last = g.in_group_ptr.shape[0] - 1
    return (g.in_group_ptr[gidx.clamp(0, last)],
            g.in_group_ptr[(gidx + 1).clamp(0, last)])


def _fetch_in_slots(g: GraphTensors, s: torch.Tensor, ty: torch.Tensor,
                    ok: torch.Tensor, default_id: int):
    return (torch.where(ok, g.in_adj_src[s], default_id),
            torch.where(ok, g.in_adj_w[s], 0.0), torch.where(ok, ty, -1),
            torch.where(ok, g.in_adj_eid[s], -1))


def select_in_neighbors(g: GraphTensors, nodes: torch.Tensor, edge_types,
                        u_type: torch.Tensor, u1: torch.Tensor,
                        u2: torch.Tensor, default_id: int = -1):
    """Deterministic weighted in-neighbor draws over the union of the
    (dst = node, edge type) in-groups, from the uniforms
    ``draw_sample_uniforms`` gives (reference: sampling.py:571-602): the
    type pick of ``select_sampled_neighbors``, then the in-group's alias
    draw. Returns (src, w, type, eid), each [B, count]."""
    _require_in_csr(g, "sample_in_neighbor")
    ets = as_etypes(g, edge_types)
    if _is_shard_view(g):
        return _sharded().sample_in_neighbor_sharded(
            g, nodes, ets, (u_type, u1, u2), default_id)
    nodes = nodes.to(torch.int32)
    rows = nodes.clamp_min(0)
    et = etype_tensor(ets, torch.int64, nodes.device)
    n = g.in_group_w_sum.shape[0]
    W = g.in_group_w_sum[rows.long().clamp_max(n - 1)][:, et]
    kidx, total = _pick_types(W, u_type)
    etype = et[kidx]
    lo, hi = _in_group_bounds(g, rows[:, None], etype)
    pos = alias_select(g.in_adj_prob, g.in_adj_alias, lo, hi - lo, u1, u2)
    ok = (pos >= 0) & (nodes >= 0)[:, None] & (total > 0)[:, None]
    s = pos.long().clamp(0, g.in_adj_src.shape[0] - 1)
    return _fetch_in_slots(g, s, etype.to(torch.int32), ok, default_id)


def sample_in_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                       count: int, default_id: int = -1,
                       generator: Optional[torch.Generator] = None):
    """Weighted in-neighbor sampling (reference: Node::SampleInNeighbor,
    the in-edge mirror of SampleNeighbor)."""
    _require_in_csr(g, "sample_in_neighbor")
    u = draw_sample_uniforms(generator,
                             neighbor_rows(g, nodes.shape[0], spread=True),
                             count, nodes.device)
    return select_in_neighbors(g, nodes, edge_types, *u, default_id)


def get_full_in_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                         cap: int, default_id: int = -1,
                         sorted_by_id: bool = False):
    """Padded full in-neighborhood, the mirror of ``get_full_neighbor``
    (reference: sampling.py:605-642): (src, w, type, eid, ok), each
    [B, cap]."""
    _require_in_csr(g, "get_full_in_neighbor")
    ets = as_etypes(g, edge_types)
    if _is_shard_view(g):
        return _sharded().get_full_in_neighbor_sharded(
            g, nodes, ets, cap, default_id, sorted_by_id)
    nodes = nodes.to(torch.int32)
    dev = nodes.device
    B, K = nodes.shape[0], len(ets)
    rows = nodes.clamp_min(0)
    et = etype_tensor(ets, torch.int32, dev)
    lo, hi = _in_group_bounds(g, rows[:, None], et[None, :])     # [B, K]
    deg = (hi - lo).long()
    offs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                      torch.cumsum(deg, dim=1)], dim=1)
    total = offs[:, -1]
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    k_idx = (j[None, :, None] >= offs[:, None, 1:]).sum(dim=-1)
    k_idx = k_idx.clamp_max(K - 1)
    slot = torch.gather(lo.long(), 1, k_idx) + (
        j[None, :] - torch.gather(offs[:, :-1], 1, k_idx))
    ok = (j[None, :] < total[:, None]) & (nodes >= 0)[:, None]
    s = slot.clamp(0, g.in_adj_src.shape[0] - 1)
    nbr, w, ty, eid = _fetch_in_slots(g, s, et[k_idx], ok, default_id)
    if sorted_by_id:
        key = torch.where(ok, nbr, torch.iinfo(torch.int32).max)
        order = torch.argsort(key, dim=1, stable=True)
        nbr, w, ty, eid, ok = (torch.gather(x, 1, order)
                               for x in (nbr, w, ty, eid, ok))
    return nbr, w, ty, eid, ok


def get_top_k_in_neighbor(g: GraphTensors, nodes: torch.Tensor, edge_types,
                          k: int, cap: Optional[int] = None,
                          default_id: int = -1):
    """Top-k in-neighbors by edge weight (reference: sampling.py:645-657)."""
    cap = cap or max(k, 16)
    return _top_k_rows(k, *get_full_in_neighbor(g, nodes, edge_types, cap,
                                                default_id), default_id)


# ---------------------------------------------------------------------------
# fanouts and the layer draw
# ---------------------------------------------------------------------------

def draw_fanout_uniforms(generator: Optional[torch.Generator], B: int,
                         counts: Sequence[int], device, g=None) -> list:
    """One ``draw_sample_uniforms`` tuple per hop of a fanout from B
    nodes: hop i draws counts[i] for each of B * prod(counts[:i]) (over a
    ShardView ``g``, for the rows the owner answers)."""
    out, n = [], B
    for c in counts:
        out.append(draw_sample_uniforms(generator, neighbor_rows(g, n), c,
                                        device))
        n *= c
    return out


def select_fanout(g: GraphTensors, nodes: torch.Tensor, edge_types_per_hop,
                  counts: Sequence[int], uniforms: Sequence,
                  default_id: int = -1):
    """Multi-hop fanout from the uniforms ``draw_fanout_uniforms`` gives
    (reference: sampling.py:660-683, a loop of ``sample_neighbor``).
    Returns (hop_nodes, hop_weights, hop_types, hop_eids): hop_nodes[0]
    is ``nodes``, hop_nodes[i] has B * prod(counts[:i]) entries."""
    cur = nodes.to(torch.int32).reshape(-1)
    hop_nodes, hop_w, hop_ty, hop_eid = [cur], [], [], []
    for ets, cnt, u in zip(edge_types_per_hop, counts, uniforms):
        nbr, w, ty, eid = select_sampled_neighbors(g, cur, ets, *u,
                                                   default_id)
        cur = nbr.reshape(-1)
        hop_nodes.append(cur)
        hop_w.append(w.reshape(-1))
        hop_ty.append(ty.reshape(-1))
        hop_eid.append(eid.reshape(-1))
    return hop_nodes, hop_w, hop_ty, hop_eid


def sample_fanout(g: GraphTensors, nodes: torch.Tensor, edge_types_per_hop,
                  counts: Sequence[int], default_id: int = -1,
                  generator: Optional[torch.Generator] = None):
    """Multi-hop fanout sampling (reference: SampleFanout,
    tf_euler/kernels/sample_fanout_op.cc:30-148)."""
    u = draw_fanout_uniforms(generator, nodes.reshape(-1).shape[0], counts,
                             nodes.device, g)
    return select_fanout(g, nodes, edge_types_per_hop, counts, u,
                         default_id)


def get_multi_hop_neighbor(g: GraphTensors, nodes: torch.Tensor,
                           edge_types_per_hop, counts: Sequence[int],
                           generator: Optional[torch.Generator] = None,
                           uniforms: Optional[Sequence] = None) -> list:
    """Per hop (frontier, edge_src_pos, edge_dst_nodes, mask) of a fanout,
    the sampled bipartite adjacency (reference: sampling.py:686-700);
    ``uniforms`` replays ``draw_fanout_uniforms``."""
    if uniforms is None:
        uniforms = draw_fanout_uniforms(generator, nodes.reshape(-1).shape[0],
                                        counts, nodes.device, g)
    hop_nodes, *_ = select_fanout(g, nodes, edge_types_per_hop, counts,
                                  uniforms)
    out = []
    for i, cnt in enumerate(counts):
        dst = hop_nodes[i + 1]
        # each frontier position repeated cnt times, as jnp.repeat
        src = torch.arange(dst.shape[0], dtype=torch.int32,
                           device=dst.device) // cnt
        out.append((dst, src, dst, dst >= 0))
    return out


#: the smallest key uniform of a Gumbel draw: the reference's
#: ``uniform(minval=1e-20, maxval=1.0)`` maps a 0 there, so log never
#: sees 0
GUMBEL_MIN = 1e-20


def draw_gumbel_uniforms(generator: Optional[torch.Generator], shape,
                         device) -> torch.Tensor:
    """f32 uniforms in [1e-20, 1) of ``shape``, as the reference's
    ``jax.random.uniform(key, shape, minval=1e-20, maxval=1.0)`` gives
    them (its 0 becomes 1e-20): the keys of a Gumbel-max draw."""
    return torch.rand(shape, generator=generator,
                      device=device).clamp_min_(GUMBEL_MIN)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)): Gumbel noise from ``draw_gumbel_uniforms``."""
    return -torch.log(-torch.log(u))


_WEIGHT_FUNCS = {"sqrt": torch.sqrt, "id": lambda x: x,
                 "uniform": torch.ones_like}


def draw_layer_uniforms(generator: Optional[torch.Generator], n: int,
                        candidates_per_node: int, device, g=None):
    """(the candidates' ``draw_sample_uniforms`` [n, c], the Gumbel keys
    [n * c]) of ``sample_layer`` over n frontier nodes (over a ShardView
    ``g``, the candidates' for the rows the owner answers)."""
    u = draw_sample_uniforms(generator, neighbor_rows(g, n),
                             candidates_per_node, device)
    return u, draw_gumbel_uniforms(generator, (n * candidates_per_node,),
                                   device)


def layer_keys(g: GraphTensors, frontier: torch.Tensor, edge_types,
               candidates_per_node: int, uniforms, weight_func="sqrt"):
    """The candidates of ``select_layer`` and their keys: (ids int32,
    weights f32, keys f32), each [n * candidates_per_node]; a key is
    log(weight_func(w)) + Gumbel noise, -inf where the score is 0."""
    wf = _WEIGHT_FUNCS.get(weight_func, weight_func)
    u_cand, u_key = uniforms
    cand, cw, _, _ = select_sampled_neighbors(g, frontier.reshape(-1),
                                              edge_types, *u_cand)
    flat, fw = cand.reshape(-1), cw.reshape(-1)
    score = torch.where(flat >= 0, wf(fw.clamp_min(0.0)), 0.0)
    return flat, fw, torch.where(score > 0, torch.log(score) + gumbel(u_key),
                                 float("-inf"))


def select_layer(g: GraphTensors, frontier: torch.Tensor, edge_types,
                 candidates_per_node: int, n_layer_nodes: int, uniforms,
                 weight_func="sqrt"):
    """One shared layer from the union of the frontier's neighborhoods,
    from the uniforms ``draw_layer_uniforms`` gives (reference:
    sampling.py:703-726, API_SAMPLE_L): ``candidates_per_node`` weighted
    draws a frontier node, scored ``weight_func(w)`` ("sqrt", "id",
    "uniform" or a callable), then the ``n_layer_nodes`` best of
    log(score) + Gumbel noise without replacement (``layer_keys``; ties
    to the lower index, as ``jax.lax.top_k``). Returns (layer_ids int32,
    weights f32), each [n_layer_nodes], -1 and 0 where fewer candidates
    have a score."""
    flat, fw, keyed = layer_keys(g, frontier, edge_types,
                                 candidates_per_node, uniforms, weight_func)
    top = torch.sort(keyed, descending=True, stable=True)[1][:n_layer_nodes]
    ok = torch.isfinite(keyed[top])
    return torch.where(ok, flat[top], -1), torch.where(ok, fw[top], 0.0)


def sample_layer(g: GraphTensors, frontier: torch.Tensor, edge_types,
                 candidates_per_node: int, n_layer_nodes: int,
                 weight_func="sqrt",
                 generator: Optional[torch.Generator] = None):
    """One shared layer sampled from the union of frontier neighborhoods
    (the op behind ``sampleLNB``); see ``select_layer``."""
    u = draw_layer_uniforms(generator, frontier.reshape(-1).shape[0],
                            candidates_per_node, frontier.device, g)
    return select_layer(g, frontier, edge_types, candidates_per_node,
                        n_layer_nodes, u, weight_func)


# ---------------------------------------------------------------------------
# adjacency, graph labels and node types
# ---------------------------------------------------------------------------

#: halving steps of a search over one CSR group: enough for any group
#: of fewer than 2^31 edges
SEARCH_STEPS = 32


def sparse_get_adj(g: GraphTensors, nodes: torch.Tensor,
                   nb_nodes: torch.Tensor, edge_types):
    """Bipartite adjacency between ``nodes`` [B] and ``nb_nodes`` [M]
    under the given edge types, as a dense (connected bool, weight f32)
    pair of [B, M] (reference: sampling.py:729-772, SparseGetAdj). Each
    membership test is the reference's 32 halving steps over the
    dst-sorted CSR group; a later type's hit overwrites the weight."""
    ets = as_etypes(g, edge_types)
    if _is_shard_view(g):
        return _sharded().sparse_get_adj_sharded(g, nodes, nb_nodes, ets)
    nodes = nodes.to(torch.int32).reshape(-1)
    nb = nb_nodes.to(torch.int32).reshape(-1)
    rows = nodes.clamp_min(0)
    B, M = nodes.shape[0], nb.shape[0]
    conn = torch.zeros((B, M), dtype=torch.bool, device=nodes.device)
    w = torch.zeros((B, M), dtype=torch.float32, device=nodes.device)
    E = g.adj_dst.shape[0]
    tgt = nb[None, :].expand(B, M)
    for t in ets:
        lo, hi = _group_bounds(g, rows, torch.full_like(rows, t))
        h_b = hi.long()[:, None].expand(B, M)
        l, h = lo.long()[:, None].expand(B, M), h_b
        for _ in range(SEARCH_STEPS):
            mid = (l + h) // 2
            right = g.adj_dst[mid.clamp(0, E - 1)] < tgt
            l, h = torch.where(right, mid + 1, l), torch.where(right, h, mid)
        slot = l.clamp(0, E - 1)
        hit = ((l < h_b) & (g.adj_dst[slot] == tgt)
               & (nodes >= 0)[:, None] & (nb >= 0)[None, :])
        conn = conn | hit
        w = torch.where(hit, g.adj_w[slot], w)
    return conn, w


def _require_graph_members(g: GraphTensors, name: str) -> None:
    if g.graph_members is None:
        raise ValueError(
            f"{name} needs graph-label membership: the graph must carry a "
            "'graph_label' binary node feature (store.Graph builds the "
            "table)")


def sample_graph_label(g: GraphTensors, count: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """``count`` graph indices drawn uniformly (reference:
    API_SAMPLE_GRAPH_LABEL); int32 [count]."""
    _require_graph_members(g, "sample_graph_label")
    return torch.randint(0, g.graph_members.shape[0], (count,),
                         generator=generator, device=g.device,
                         dtype=torch.int32)


def get_graph_by_label(g: GraphTensors, graph_idx: torch.Tensor):
    """The nodes of each graph (reference: sampling.py:795-809): (node ids
    int32 [B, maxN] padded with -1, mask [B, maxN], each node's graph
    index int32 [B * maxN]). A graph index < 0 counts from the end and
    one past the table clamps, as a jnp index does."""
    _require_graph_members(g, "get_graph_by_label")
    G = g.graph_members.shape[0]
    idx = graph_idx.long()
    members = g.graph_members[torch.where(idx < 0, idx + G, idx).clamp(
        0, G - 1)]
    B, maxN = members.shape
    node_graph_idx = torch.arange(B * maxN, dtype=torch.int32,
                                  device=members.device) // maxN
    return members, members >= 0, node_graph_idx


def get_node_type(g: GraphTensors, nodes: torch.Tensor) -> torch.Tensor:
    """Each node's type id, -1 for nodes < 0 (reference: API_GET_NODE_T)."""
    if _is_shard_view(g):
        return _sharded().get_node_type_sharded(g, nodes)
    nodes = nodes.to(torch.int32)
    n = g.node_type.shape[0]
    return torch.where(nodes >= 0,
                       g.node_type[nodes.long().clamp(0, n - 1)], -1)
