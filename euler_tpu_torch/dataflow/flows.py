"""Dataflow samplers: sampling strategy -> sequence of bipartite Blocks.

Counterpart of euler_tpu/dataflow/flows.py: ``SageDataFlow`` (the
fan-row draws, with or without ``typed``, and ``payload=True``),
``GCNDataFlow``, ``WholeDataFlow`` (and its sharded whole-graph block,
``full_graph_block_sharded``), ``LayerwiseDataFlow`` and
``FastDataFlow``, and the
registry ``get_flow_class``. Every flow is called as ``flow(g, roots,
generator=None, uniforms=None)`` and returns its blocks deepest first;
``num_layers`` is the number of blocks, one conv each. Flows that draw
nothing ignore ``generator`` and ``uniforms``. Every flow's constructor
ignores unknown keywords, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from euler_tpu_torch.dataflow.block import (Block, RelBlock, fanout_block,
                                            full_graph_block)
from euler_tpu_torch.ops import mp_ops, sampling
from euler_tpu_torch.ops.dispatch import is_shard_view


class SageDataFlow:
    """Per-hop weighted neighbor sampling (GraphSAGE).

    reference: SageDataFlow (euler_tpu/dataflow/flows.py:26-78;
    tf_euler/python/dataflow/sage_dataflow.py:24-50).
    ``payload=False`` (default): blocks carry edge_weight = the 0/1
    validity mask and e_id = -1; with ``typed=True`` also ``e_type``,
    each draw's edge type (-1 where invalid), which RGCN's
    ``relation_from_etype`` reads. A hop over one edge type draws from
    the fan rows, a hop over every type from the union rows where the
    graph has them, any other multi-type hop from one fan row per type,
    and a hop without its pack through ``select_sampled_neighbors``
    (``sampling.hop_kind``). ``payload=True`` draws every hop through
    ``select_sampled_neighbors`` (the reference's ``sample_neighbor``),
    so that blocks carry each edge's true weight, id and type; it wins
    over ``typed``.

    A call takes either ``generator`` (a torch.Generator on the graph's
    device, or None for the default one) or ``uniforms``, a list with one
    tuple per hop, so that a caller can replay given draws (``draw_hop``
    gives a hop's: ``(u1, u2)`` for fan and union hops, ``(ut, u1, u2)``
    for per-type, fan-less and payload hops). Unknown keywords are
    ignored, as the reference's flows ignore them.
    """

    def __init__(self, fanouts: Sequence[int], metapath,
                 add_self_loops: bool = True, default_id: int = -1,
                 payload: bool = False, typed: bool = False, **_):
        if len(fanouts) != len(metapath):
            raise ValueError("need one metapath entry per fanout")
        self.fanouts = list(fanouts)
        self.metapath = list(metapath)
        self.add_self_loops = add_self_loops
        self.default_id = default_id
        self.payload = payload
        self.typed = typed

    @property
    def num_layers(self) -> int:
        return len(self.fanouts)

    def draw_hop(self, g, ets, generator: Optional[torch.Generator],
                 B: int, count: int, device) -> tuple:
        """The uniforms of one hop of ``count`` draws for B nodes."""
        if self.payload:
            return sampling.draw_sample_uniforms(
                generator, sampling.neighbor_rows(g, B), count, device)
        return sampling.draw_neighbor_uniforms(g, ets, generator, B, count,
                                               device)

    def draw_uniforms(self, g, roots: torch.Tensor,
                      generator: Optional[torch.Generator]) -> list:
        """The ``uniforms`` a call over ``roots`` reads, one tuple per hop
        (the frontier grows by 1 + fanout a hop)."""
        out, n = [], roots.shape[0]
        for ets, c in zip(self.metapath, self.fanouts):
            out.append(self.draw_hop(g, ets, generator, n, c, roots.device))
            n *= 1 + c
        return out

    def __call__(self, g, roots: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence] = None):
        if uniforms is not None and len(uniforms) != len(self.fanouts):
            raise ValueError(f"need {len(self.fanouts)} uniform tuples, "
                             f"got {len(uniforms)}")
        cur = roots.reshape(-1).to(torch.int32)
        blocks = []
        for hop, (ets, cnt) in enumerate(zip(self.metapath, self.fanouts)):
            u = uniforms[hop] if uniforms is not None else \
                self.draw_hop(g, ets, generator, cur.shape[0], cnt,
                              cur.device)
            if self.payload:
                nbr, w, ty, eid = sampling.select_sampled_neighbors(
                    g, cur, ets, *u, default_id=self.default_id)
            else:
                nbr, valid, *tys = sampling.select_neighbors(
                    g, cur, ets, u, self.default_id,
                    return_types=self.typed)
                w, eid = valid.to(torch.float32), torch.full_like(nbr, -1)
                ty = tys[0] if tys else None
            blk = fanout_block(cur, nbr, w, eid, cnt, self.add_self_loops,
                               etypes=ty)
            blocks.append(blk)
            cur = blk.n_id
        return blocks[::-1]


class GCNDataFlow:
    """Full neighborhoods per hop, capped at ``caps[i]`` neighbors (a
    neighborhood past its cap is cut, in CSR slot order).

    reference: GCNDataFlow (euler_tpu/dataflow/flows.py:81-107;
    tf_euler/python/dataflow/gcn_dataflow.py, get_full_neighbor). Blocks
    carry the edges' weights, ids and types."""

    def __init__(self, caps: Sequence[int], metapath,
                 add_self_loops: bool = True, default_id: int = -1, **_):
        self.caps = list(caps)
        self.metapath = list(metapath)
        self.add_self_loops = add_self_loops
        self.default_id = default_id

    @property
    def num_layers(self) -> int:
        return len(self.caps)

    def __call__(self, g, roots: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence] = None):
        cur = roots.reshape(-1).to(torch.int32)
        blocks = []
        for ets, cap in zip(self.metapath, self.caps):
            nbr, w, ty, eid, ok = sampling.get_full_neighbor(
                g, cur, ets, cap, self.default_id)
            blk = fanout_block(cur, torch.where(ok, nbr, -1), w, eid, cap,
                               self.add_self_loops, etypes=ty)
            blocks.append(blk)
            cur = blk.n_id
        return blocks[::-1]


class WholeDataFlow:
    """Whole-graph propagation (full-batch GCN): one block over every
    node, repeated for each of ``num_layers`` layers; the caller picks the
    roots' rows out of the last layer.

    reference: WholeDataFlow (euler_tpu/dataflow/flows.py:110-196;
    tf_euler/python/dataflow/whole_dataflow.py:26-63). Three layouts, by
    the reference's rule: with ``layout="auto"`` or ``"ell"`` and the
    graph's ``ell`` pack, the pack's regular [N, C] rows masked to the
    metapath's types, with ``src_deg`` (in-degree over those types, + 1
    for the self loop) and ``ell_tpos``, so that convs aggregate from the
    compact [N, D] table; else, with ``cap`` set (at least the largest
    degree for the exact graph), the same regular rows assembled per call
    by ``get_full_neighbor`` (no transpose table: GNNNet expands each
    layer's output through ``n_id``); else the edge-list block
    ``full_graph_block``, whose reductions scatter. Over a ShardView,
    each shard's block holds its own edges over the global node set
    (``full_graph_block_sharded``) and its reductions complete over the
    graph group (``Block.psum_axis``).

    ``layout="rel"`` (never chosen by "auto") takes the graph's ``rel``
    pack: the edge-list block over the metapath's types, each edge's type
    in ``e_type`` (what ``relation_from_etype`` reads), with a
    ``RelBlock`` (the CSR grouped by (node, edge type), the pack and the
    taken types), on which R-GCN's per-relation mean runs
    (``Block.relation_mean``). It carries no self loops: R-GCN's root
    linear is its self term.
    """

    def __init__(self, num_layers: int, metapath,
                 add_self_loops: bool = True, cap: Optional[int] = None,
                 layout: str = "auto", **_):
        if layout not in ("auto", "ell", "edge_list", "rel"):
            raise ValueError(f"layout {layout!r} not in auto, ell, "
                             f"edge_list, rel")
        if layout == "rel" and add_self_loops:
            raise ValueError("layout 'rel' carries no self loops (R-GCN's "
                             "root linear is its self term): pass "
                             "add_self_loops=False")
        self.num_layers = num_layers
        self.metapath = list(metapath)
        self.add_self_loops = add_self_loops
        self.cap = cap
        self.layout = layout

    def _src_deg(self, blk, deg_in: torch.Tensor) -> torch.Tensor:
        if self.add_self_loops:
            deg_in = deg_in + 1.0
        ok = blk.n_id >= 0
        return torch.where(ok, deg_in[blk.n_id.long().clamp_min(0)], 0.0)

    def __call__(self, g, roots: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence] = None):
        if is_shard_view(g):
            blk = full_graph_block_sharded(g, self.metapath[0],
                                           self.add_self_loops)
            return [blk] * self.num_layers
        if self.layout == "rel":
            if g.rel is None:
                raise ValueError("layout 'rel' needs the graph's 'rel' pack")
            ets = sampling.as_etypes(g, self.metapath[0])
            blk = dataclasses.replace(
                full_graph_block(g, self.metapath[0], False),
                e_type=g.adj_type,
                rel=RelBlock(g.group_ptr, g.adj_dst, g.rel,
                             sum(1 << t for t in set(ets))))
            return [blk] * self.num_layers
        have_pack = g.ell_nbr is not None
        use_ell = self.layout == "ell" or (
            self.layout == "auto" and (have_pack or self.cap is not None))
        n = g.meta.n_nodes
        ets = sampling.etype_tensor(sampling.as_etypes(g, self.metapath[0]),
                                    torch.int32, g.device)
        all_nodes = torch.arange(n, dtype=torch.int32, device=g.device)
        if use_ell and have_pack:
            sel = torch.isin(g.ell_ty, ets)
            blk = fanout_block(
                all_nodes, torch.where(sel, g.ell_nbr, -1),
                torch.where(sel, g.ell_w, 0.0),
                torch.where(sel, g.ell_eid, -1), int(g.ell_nbr.shape[1]),
                self.add_self_loops, etypes=torch.where(sel, g.ell_ty, -1))
            deg_in = g.ell_in_deg[:, ets.long()].sum(dim=1)
            blk = dataclasses.replace(blk, src_deg=self._src_deg(blk, deg_in),
                                      ell_tpos=g.ell_tpos)
        elif use_ell and self.cap is not None:
            nbr, w, ty, eid, ok = sampling.get_full_neighbor(
                g, all_nodes, self.metapath[0], self.cap)
            blk = fanout_block(all_nodes, torch.where(ok, nbr, -1), w, eid,
                               self.cap, self.add_self_loops, etypes=ty)
            sel = torch.isin(g.adj_type, ets).to(torch.float32)
            deg_in = mp_ops.scatter_add(sel, g.adj_dst, n)
            blk = dataclasses.replace(blk,
                                      src_deg=self._src_deg(blk, deg_in))
        else:
            blk = full_graph_block(g, self.metapath[0], self.add_self_loops)
        return [blk] * self.num_layers


def full_graph_block_sharded(view, edge_types,
                             add_self_loops: bool = True) -> Block:
    """One shard's whole-graph block (flows.py:199-242): its local CSR
    edges addressed in GLOBAL node ids (target the edge's source, which
    this shard owns; source slot its destination), self loops only for
    the nodes it owns (the psum would count a loop on every shard
    otherwise); over every node, completed over the view's graph group
    (``psum_axis``)."""
    ets = sampling.etype_tensor(sampling.as_etypes(view, edge_types),
                                torch.int32, view.device)
    N, S = view.meta.n_nodes, view.num_shards
    ET = view.meta.num_edge_types
    me = view.my_shard
    dev = view.device
    gp = view.group_ptr
    E = view.adj_dst.shape[0]                      # padded e_max
    slots = torch.arange(E, dtype=gp.dtype, device=dev)
    real = slots < gp[-1]
    gidx = (torch.searchsorted(gp, slots, right=True) - 1).clamp(
        0, gp.shape[0] - 2)
    row = gidx // ET                               # local target row
    dst = torch.where(real, row * S + me, 0).to(torch.int32)
    ok_dst = view.adj_dst >= 0
    src = torch.where(real & ok_dst, view.adj_dst, 0).to(torch.int32)
    sel = real & torch.isin(view.adj_type, ets) & ok_dst & (dst < N)
    mask = sel.to(torch.float32)
    w = torch.where(sel, view.adj_w, 0.0)
    e_id = torch.where(sel, view.adj_eid, -1)
    if add_self_loops:
        n_local = view.node_type.shape[0]
        loop = torch.arange(n_local, dtype=torch.int32, device=dev) * S + me
        ok = loop < N
        loop = torch.where(ok, loop, 0)
        dst = torch.cat([dst, loop])
        src = torch.cat([src, loop])
        mask = torch.cat([mask, ok.to(torch.float32)])
        w = torch.cat([w, torch.ones((n_local,), dtype=w.dtype, device=dev)])
        e_id = torch.cat([e_id, torch.full((n_local,), -1,
                                           dtype=torch.int32, device=dev)])
    all_nodes = torch.arange(N, dtype=torch.int32, device=dev)
    return Block(n_id=all_nodes, res_n_id=all_nodes,
                 edge_index=torch.stack([dst, src]), e_id=e_id,
                 edge_weight=w, mask=mask, size=(N, N),
                 psum_axis=view.group)


class LayerwiseDataFlow:
    """Layer-wise importance sampling (LADIES-style): each hop draws one
    layer of ``layer_sizes[i]`` nodes shared by the whole frontier, with
    the full frontier x layer adjacency.

    reference: LayerwiseDataFlow (euler_tpu/dataflow/flows.py:245-311;
    tf_euler/python/dataflow/layerwise_dataflow.py). Per hop:
    ``sampling.select_layer`` (``candidates_per_node`` weighted draws a
    frontier node, the best ``m`` of log(weight_func(w)) + Gumbel noise),
    then the layer deduplicated (a node drawn through several candidates
    keeps its first place, the others become -1: first places from an
    argmax over the equality grid, the first maximal index winning as in
    jnp), then ``sampling.sparse_get_adj`` of frontier x layer. The block
    is ``shared_src`` over ``n_id = concat(frontier, layer)``: edge
    t*m+j joins target t to layer node j, masked where they are not
    adjacent (or either is -1) and weighted by the edge's weight, then T
    self loops of weight 1.

    ``weight_func`` is "sqrt" (the reference's default), "id", "uniform"
    or a callable. A call takes ``generator`` or ``uniforms``, one
    ``sampling.draw_layer_uniforms`` tuple per hop.
    """

    def __init__(self, layer_sizes: Sequence[int], metapath,
                 add_self_loops: bool = True, candidates_per_node: int = 8,
                 weight_func="sqrt", **_):
        if len(layer_sizes) != len(metapath):
            raise ValueError("need one metapath entry per layer size")
        self.layer_sizes = list(layer_sizes)
        self.metapath = list(metapath)
        self.add_self_loops = add_self_loops
        self.cpn = candidates_per_node
        self.weight_func = weight_func

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes)

    def __call__(self, g, roots: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence] = None):
        if uniforms is not None and len(uniforms) != len(self.layer_sizes):
            raise ValueError(f"need {len(self.layer_sizes)} uniform tuples, "
                             f"got {len(uniforms)}")
        cur = roots.reshape(-1).to(torch.int32)
        dev = cur.device
        blocks = []
        for hop, (ets, m) in enumerate(zip(self.metapath, self.layer_sizes)):
            T = cur.shape[0]
            u = uniforms[hop] if uniforms is not None else \
                sampling.draw_layer_uniforms(generator, T, self.cpn, dev, g)
            layer, _ = sampling.select_layer(g, cur, ets, self.cpn, m, u,
                                             self.weight_func)
            eq = (layer[None, :] == layer[:, None]).to(torch.uint8)
            first = eq.argmax(dim=1)
            layer = torch.where(first != torch.arange(m, device=dev), -1,
                                layer)
            conn, w2 = sampling.sparse_get_adj(g, cur, layer, ets)
            conn = conn & (cur >= 0)[:, None] & (layer >= 0)[None, :]
            n_id = torch.cat([cur, layer])
            dst = torch.arange(T, dtype=torch.int32,
                               device=dev).repeat_interleave(m)
            src = T + torch.arange(m, dtype=torch.int32, device=dev).repeat(T)
            mask = conn.to(torch.float32).reshape(-1)
            w = torch.where(conn, w2, 0.0).reshape(-1)
            e_id = torch.full((T * m,), -1, dtype=torch.int32, device=dev)
            if self.add_self_loops:
                loop = torch.arange(T, dtype=torch.int32, device=dev)
                dst = torch.cat([dst, loop])
                src = torch.cat([src, loop])
                mask = torch.cat([mask, (cur >= 0).to(torch.float32)])
                w = torch.cat([w, torch.ones((T,), dtype=w.dtype,
                                             device=dev)])
                e_id = torch.cat([e_id, torch.full(
                    (T,), -1, dtype=torch.int32, device=dev)])
            blocks.append(Block(
                n_id=n_id,
                res_n_id=torch.arange(T, dtype=torch.int32, device=dev),
                edge_index=torch.stack([dst, src]), e_id=e_id,
                edge_weight=w, mask=mask, size=(T, T + m), fanout=m,
                self_loops=self.add_self_loops, shared_src=True))
            cur = n_id
        return blocks[::-1]


class FastDataFlow(LayerwiseDataFlow):
    """FastGCN: the layerwise flow with every candidate scored alike
    (reference: flows.py:314-320, fast_dataflow.py)."""

    def __init__(self, layer_sizes: Sequence[int], metapath, **kw):
        kw.setdefault("weight_func", "uniform")
        super().__init__(layer_sizes, metapath, **kw)


_FLOWS = {
    "sage": SageDataFlow,
    "sample": SageDataFlow,
    "full": GCNDataFlow,
    "gcn": GCNDataFlow,
    "whole": WholeDataFlow,
    "layerwise": LayerwiseDataFlow,
    "adapt": LayerwiseDataFlow,
    "fast": FastDataFlow,
}


def get_flow_class(name: str):
    """The flow class of a registry name, as the reference's
    ``get_flow_class`` (flows.py:326-338; mp_utils/utils.py)."""
    return _FLOWS[name]
