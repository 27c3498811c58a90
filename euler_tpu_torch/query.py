"""Gremlin-style queries over the device graph.

Counterpart of euler_tpu/query.py (reference: euler's GQL,
euler/parser/gremlin.l:15-53 and gremlin.y:27-44: ``v()``, ``e()``,
``sampleN``, ``sampleE``, ``sampleNB``, ``sampleLNB``, ``outV``, ``inV``,
``outE``, ``values``, ``label``, ``has/hasLabel/gt/ge/lt/le/eq/ne/in_/
not_in``, ``order_by/limit``, ``as``, ``udf_*``). A ``Query`` records
verbs; ``run()`` executes them in order on the graph's device, eagerly.

    q = (Query(graph)
         .v(ids)
         .sampleNB(("link",), 10).alias("nb")
         .values("feature").alias("f"))
    out = q.run(generator=torch.Generator(device="cuda").manual_seed(0))
    out["nb"].ids, out["nb"].weights    # [B, 10] neighbor block
    out["f"]                            # [B * 10, dim] gathered features

The random verbs (``sampleN``, ``sampleE``, ``sampleNB``, ``sampleLNB``)
are split into a draw of their uniforms and a deterministic select, as
every verb of ops/sampling.py is. ``run(generator=)`` draws each random
step's uniforms from the generator in step order; ``run(uniforms=)``
takes them as a list, one entry per random step in step order, in the
form that step's draw gives (``sampling.draw_node_uniforms``,
``draw_edge_uniforms``, ``draw_sample_uniforms``, ``draw_layer_uniforms``,
``index.draw_condition_uniforms``); ``Query.last_uniforms`` holds the
list the last run used. ``run``'s ``jit`` is accepted for the
reference's signature and changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from euler_tpu_torch.graph.store import Graph
from euler_tpu_torch.ops import feature_ops, sampling
from euler_tpu_torch.ops import index as index_ops
from euler_tpu_torch.ops.index import Pred

INT32_MIN, INT32_MAX = torch.iinfo(torch.int32).min, torch.iinfo(
    torch.int32).max


@dataclasses.dataclass
class NodeResult:
    """A padded node frontier: ids [...], weights, types, eids, mask."""
    ids: torch.Tensor
    weights: Optional[torch.Tensor] = None
    types: Optional[torch.Tensor] = None
    eids: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


@dataclasses.dataclass
class EdgeResult:
    src: torch.Tensor
    dst: torch.Tensor
    types: torch.Tensor
    eids: torch.Tensor


def udf_mean(name: str):
    """values(udf_mean(f)): each row's mean of a dense feature
    (reference: euler/core/kernels/mean_udf.cc:63)."""
    return ("udf_mean", name)


def udf_min(name: str):
    return ("udf_min", name)


def udf_max(name: str):
    return ("udf_max", name)


_UDFS: Dict[str, Callable] = {
    "udf_mean": lambda x: x.mean(-1, keepdim=True),
    "udf_min": lambda x: x.amin(-1, keepdim=True),
    "udf_max": lambda x: x.amax(-1, keepdim=True),
}


def register_udf(name: str, fn) -> None:
    """Register a user UDF under ``name`` for ``values``.

    ``fn(x, *params)`` receives the gathered [B, dim] dense feature block
    of the frontier (a tensor on the graph's device) and the extra
    arguments given to ``udf`` (reference: euler/core/framework/udf.h:33,
    43, RegisterUdf and the parameterized ValuesUdf::Compute).
    """
    if not callable(fn):
        raise TypeError("udf must be callable")
    _UDFS[name] = fn


def udf(name_or_fn, feature: str, *params):
    """``values`` wrapper for a registered or inline UDF:
    ``udf("my_norm", "feature", 2.0)`` looks up a ``register_udf`` entry,
    ``udf(lambda x: x.sum(-1, keepdim=True), "feature")`` runs the
    callable; ``params`` follow the feature block."""
    if not (callable(name_or_fn) or name_or_fn in _UDFS):
        raise KeyError(f"unknown udf {name_or_fn!r}; register_udf first")
    return (name_or_fn, feature) + tuple(params)


class Query:
    """Chainable query plan over a device graph.

    Verbs append steps; ``run`` executes them. ``alias(name)`` (the
    reference's ``as``) records the current frontier or last value in the
    result dict. Predicates attach to the nearest ``sampleN``/``sampleE``;
    after ``v()``/``e()`` they filter the frontier (``filter``).
    """

    def __init__(self, graph):
        self._g = graph.tensors if isinstance(graph, Graph) else graph
        # (name, select(g, st, uniforms), draw(g, st, generator) or None)
        self._steps: List[tuple] = []
        self._preds: List[List[Pred]] = []   # DNF under construction
        self._pending_sample = None
        self.last_uniforms: Optional[list] = None

    # -- internal -----------------------------------------------------------

    def _add(self, name: str, fn: Callable, draw: Callable = None
             ) -> "Query":
        self._steps.append((name, fn, draw))
        return self

    def _take_dnf(self):
        dnf, self._preds = self._preds, []
        return dnf

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.int32).to(self._g.device)

    # -- roots --------------------------------------------------------------

    def v(self, ids) -> "Query":
        """Start from explicit node ids (gremlin ``v(nodes)``)."""
        ids = self._ids(ids)
        self._pending_sample = None

        def step(g, st, u):
            st["frontier"] = NodeResult(ids=ids, mask=ids >= 0)
        return self._add("v", step)

    def e(self, eids) -> "Query":
        """Start from explicit edge ids (edge rows; gremlin ``e(edges)``)."""
        eids = self._ids(eids)
        self._pending_sample = None

        def step(g, st, u):
            ok = eids >= 0
            if g.eid_slot is not None:
                inv = g.eid_slot
            else:
                # adj_eid is a permutation of [0, E): invert it per run
                # only for a store without the load-time inverse
                inv = torch.argsort(g.adj_eid, stable=True)
            slot = eids.long().clamp(0, inv.shape[0] - 1)
            slot = inv[slot].long()
            st["frontier"] = EdgeResult(
                src=torch.where(ok, g.adj_src[slot], -1),
                dst=torch.where(ok, g.adj_dst[slot], -1),
                types=torch.where(ok, g.adj_type[slot], -1),
                eids=eids)
        return self._add("e", step)

    def sampleN(self, node_type, count: int) -> "Query":
        """Weighted global node sampling, under any pending predicates
        (reference: API_SAMPLE_NODE with the index-backed conditional
        draw, sample_node_op.cc:65-103)."""
        bound = {"dnf": None}

        def draw(g, st, gen):
            if bound["dnf"]:
                return index_ops.draw_condition_uniforms(
                    g, count, bound["dnf"], node_type, "node", gen)
            return sampling.draw_node_uniforms(gen, count, g.device, g)

        def step(g, st, u):
            if bound["dnf"]:
                ids = index_ops.select_node_with_condition(
                    g, bound["dnf"], node_type, u)
            else:
                ids = sampling.select_nodes(g, node_type, *u)
            st["frontier"] = NodeResult(ids=ids, mask=ids >= 0)
        self._add("sampleN", step, draw)
        self._pending_sample = bound
        return self

    def sampleE(self, edge_type=-1, count: int = 512) -> "Query":
        """Weighted global edge sampling, under any pending edge-attribute
        predicates (reference: API_SAMPLE_EDGE and the edge side of the
        index)."""
        bound = {"dnf": None}

        def draw(g, st, gen):
            if bound["dnf"]:
                return index_ops.draw_condition_uniforms(
                    g, count, bound["dnf"], edge_type, "edge", gen)
            return sampling.draw_edge_uniforms(gen, count, g.device, g)

        def step(g, st, u):
            if bound["dnf"]:
                src, dst, ty, eid = index_ops.select_edge_with_condition(
                    g, bound["dnf"], edge_type, u)
            else:
                src, dst, ty, eid = sampling.select_edges(g, edge_type, *u)
            st["frontier"] = EdgeResult(src=src, dst=dst, types=ty, eids=eid)
        self._add("sampleE", step, draw)
        self._pending_sample = bound
        return self

    def filter(self) -> "Query":
        """Apply the pending predicates to the current frontier: an edge
        frontier through edge-attribute columns at its eids, a node
        frontier through node attributes at its ids. ``run`` appends it
        where predicates trail a ``v()``/``e()`` frontier."""
        dnf = self._take_dnf()
        self._pending_sample = None

        def step(g, st, u):
            f = st["frontier"]
            if isinstance(f, EdgeResult):
                m = index_ops.edge_dnf_mask(g, dnf, f.eids)
                st["frontier"] = EdgeResult(
                    *(torch.where(m, x, -1)
                      for x in (f.src, f.dst, f.types, f.eids)))
            else:
                m = index_ops.dnf_mask_at(g, dnf, f.ids)
                st["frontier"] = dataclasses.replace(
                    f, ids=torch.where(m, f.ids, -1),
                    mask=(f.mask & m) if f.mask is not None else m)
        return self._add("filter", step)

    # -- predicates (attach to the nearest sampleN / sampleE) ---------------

    def has(self, name: str, value) -> "Query":
        return self._pred(name, "eq", value)

    def hasLabel(self, *types) -> "Query":
        vals = types if len(types) > 1 else types[0]
        op = "in" if len(types) > 1 else "eq"
        return self._pred("node_type", op, vals)

    def eq(self, name, value):
        return self._pred(name, "eq", value)

    def ne(self, name, value):
        return self._pred(name, "ne", value)

    def gt(self, name, value):
        return self._pred(name, "gt", value)

    def ge(self, name, value):
        return self._pred(name, "ge", value)

    def lt(self, name, value):
        return self._pred(name, "lt", value)

    def le(self, name, value):
        return self._pred(name, "le", value)

    def in_(self, name, values):
        return self._pred(name, "in", tuple(values))

    def not_in(self, name, values):
        return self._pred(name, "not_in", tuple(values))

    def or_(self) -> "Query":
        """Close the current AND clause (DNF; the reference's
        common_index_result union)."""
        self._preds.append([])
        return self

    def _pred(self, name, op, value) -> "Query":
        if not self._preds:
            self._preds.append([])
        self._preds[-1].append(Pred(name, op, value))
        # bind to the most recent sample verb (gremlin allows a trailing
        # .has())
        if self._pending_sample is not None:
            self._pending_sample["dnf"] = [list(c) for c in self._preds
                                           if c]
        return self

    # -- traversal ----------------------------------------------------------

    def sampleNB(self, edge_types, count: int, default_id: int = -1
                 ) -> "Query":
        """Weighted neighbor sampling; the frontier becomes the [B, count]
        neighbor block (reference: API_SAMPLE_NB, through
        ``sampling.sample_neighbor``)."""
        def draw(g, st, gen):
            B = _node_ids(st).reshape(-1).shape[0]
            return sampling.draw_sample_uniforms(
                gen, sampling.neighbor_rows(g, B), count, g.device)

        def step(g, st, u):
            cur = _node_ids(st).reshape(-1)
            nbr, w, ty, eid = sampling.select_sampled_neighbors(
                g, cur, edge_types, *u, default_id=default_id)
            st["frontier"] = NodeResult(ids=nbr, weights=w, types=ty,
                                        eids=eid, mask=nbr >= 0)
        return self._add("sampleNB", step, draw)

    def sampleLNB(self, edge_types, count: int, n_layer_nodes: int,
                  weight_func: str = "sqrt") -> "Query":
        """Layerwise (LADIES-style) sampling: one shared layer of
        ``n_layer_nodes`` from the union of the frontier's neighborhoods
        (reference: sampleLNB, local_sample_layer_op.cc)."""
        def draw(g, st, gen):
            n = _node_ids(st).reshape(-1).shape[0]
            return sampling.draw_layer_uniforms(gen, n, count, g.device, g)

        def step(g, st, u):
            cur = _node_ids(st).reshape(-1)
            layer, lw = sampling.select_layer(g, cur, edge_types, count,
                                              n_layer_nodes, u, weight_func)
            st["frontier"] = NodeResult(ids=layer, weights=lw,
                                        mask=layer >= 0)
        return self._add("sampleLNB", step, draw)

    def outV(self) -> "Query":
        """Edge frontier -> source nodes (gremlin ``outV``)."""
        def step(g, st, u):
            f = st["frontier"]
            st["frontier"] = NodeResult(ids=f.src, mask=f.src >= 0)
        return self._add("outV", step)

    def inV(self) -> "Query":
        """Edge frontier -> destination nodes."""
        def step(g, st, u):
            f = st["frontier"]
            st["frontier"] = NodeResult(ids=f.dst, mask=f.dst >= 0)
        return self._add("inV", step)

    def outE(self, edge_types, cap: int = 64) -> "Query":
        """Node frontier -> its out-edges, padded to ``cap`` per node
        (reference: API_GET_NB_EDGE)."""
        def step(g, st, u):
            cur = _node_ids(st).reshape(-1)
            nbr, w, ty, eid, ok = sampling.get_full_neighbor(
                g, cur, edge_types, cap)
            src = torch.where(ok, cur[:, None].expand(-1, cap), -1)
            st["frontier"] = EdgeResult(src=src, dst=nbr, types=ty, eids=eid)
        return self._add("outE", step)

    # -- values -------------------------------------------------------------

    def values(self, *names) -> "Query":
        """Gather features of the current frontier: dense and sparse node
        features, ``udf_*(name)`` wrappers, and on an edge frontier edge
        features through its eids (reference: API_GET_P on nodes and
        edges and the UDF framework, get_feature_op.cc). Dense rows go
        through ``gather_rows``; repeated UDFs over one feature of one
        frontier share one gather (the reference's per-query UdfCache,
        udf.h:43)."""
        def step(g, st, u):
            f = st["frontier"]
            eids = f.eids.reshape(-1) if isinstance(f, EdgeResult) else None
            cur = _node_ids(st).reshape(-1)
            outs = []
            for n in names:
                if isinstance(n, tuple):          # udf
                    fn = n[0] if callable(n[0]) else _UDFS[n[0]]
                    cache = st.setdefault("_udf_cache", {})
                    ck = (id(f), n[1])
                    if ck not in cache:
                        cache[ck], = feature_ops.get_dense_feature(
                            g, cur, (n[1],))
                    outs.append(fn(cache[ck], *n[2:]))
                elif n in g.dense_nf:
                    outs.append(
                        feature_ops.get_dense_feature(g, cur, (n,))[0])
                elif n in g.sparse_nf:
                    outs.append(
                        feature_ops.get_sparse_feature(g, cur, (n,))[0])
                elif eids is not None and n in g.dense_ef:
                    outs.append(feature_ops.get_edge_dense_feature(
                        g, eids, (n,))[0])
                elif eids is not None and n in g.sparse_ef:
                    outs.append(feature_ops.get_edge_sparse_feature(
                        g, eids, (n,))[0])
                else:
                    raise KeyError(f"unknown feature {n!r}")
            st["last_value"] = outs[0] if len(outs) == 1 else tuple(outs)
        return self._add("values", step)

    def label(self) -> "Query":
        """Node type ids of the frontier (gremlin ``label()``)."""
        def step(g, st, u):
            st["last_value"] = sampling.get_node_type(g, _node_ids(st))
        return self._add("label", step)

    # -- post-processing (reference: POST_PROCESS order_by/limit,
    #    euler/core/kernels/post_process_op.cc:41-84) ------------------------

    def order_by(self, field: str = "id", desc: bool = False) -> "Query":
        """Order the node frontier's last axis by id or weight, invalid
        entries last, ties in their order. As the reference's: with
        ``desc`` an id order negates the keys, so the invalid entries'
        INT32_MIN wraps to itself and they come first."""
        def step(g, st, u):
            f = st["frontier"]
            valid = f.mask if f.mask is not None else f.ids >= 0
            if field == "id":
                kf = torch.where(valid, f.ids, INT32_MIN if desc
                                 else INT32_MAX)
            else:
                kf = torch.where(valid, f.weights,
                                 float("-inf") if desc else float("inf"))
            order = torch.argsort(-kf if desc else kf, dim=-1, stable=True)

            def take(x):
                return None if x is None else torch.gather(x, -1, order)
            st["frontier"] = NodeResult(
                ids=take(f.ids), weights=take(f.weights),
                types=take(f.types), eids=take(f.eids), mask=take(f.mask))
        return self._add("order_by", step)

    def limit(self, k: int) -> "Query":
        def step(g, st, u):
            f = st["frontier"]

            def cut(x):
                return None if x is None else x[..., :k]
            st["frontier"] = NodeResult(
                ids=cut(f.ids), weights=cut(f.weights), types=cut(f.types),
                eids=cut(f.eids), mask=cut(f.mask))
        return self._add("limit", step)

    # -- alias / run --------------------------------------------------------

    def alias(self, name: str) -> "Query":
        """Record the current result under ``name`` (gremlin ``as``)."""
        def step(g, st, u):
            v = st.pop("last_value", None)
            st["out"][name] = st["frontier"] if v is None else v
        return self._add("alias", step)

    # the reference's spelling (``as`` is reserved in Python)
    as_ = alias

    def run(self, generator: Optional[torch.Generator] = None,
            uniforms: Optional[list] = None, jit: bool = True
            ) -> Dict[str, Any]:
        """Execute the plan; returns {alias: result} plus ``_frontier``
        (and ``_value`` where the last step left a value). Each random
        step takes the next entry of ``uniforms`` or, without it, draws
        from ``generator``."""
        if self._preds and self._pending_sample is None:
            # predicates trailing a v()/e() frontier: filter it
            self.filter()
        g = self._g
        st: Dict[str, Any] = {"out": {}}
        given = None if uniforms is None else list(uniforms)
        used = []
        for name, fn, draw in self._steps:
            u = None
            if draw is not None:
                if given is None:
                    u = draw(g, st, generator)
                elif len(used) < len(given):
                    u = given[len(used)]
                else:
                    raise ValueError(
                        f"uniforms: {len(given)} entries for more random "
                        f"steps (at {name!r})")
                used.append(u)
            fn(g, st, u)
        if given is not None and len(used) != len(given):
            raise ValueError(f"uniforms: {len(given)} entries for "
                             f"{len(used)} random steps")
        self.last_uniforms = used
        out = st["out"]
        if "last_value" in st:
            out["_value"] = st["last_value"]
        out["_frontier"] = st.get("frontier")
        return out


def _node_ids(st) -> torch.Tensor:
    f = st["frontier"]
    if isinstance(f, EdgeResult):
        return f.dst
    return f.ids
