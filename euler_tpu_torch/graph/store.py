"""Device-resident graph store: the fields the sampled and whole-graph
paths read.

Counterpart of euler_tpu/graph/store.py (``GraphTensors``, ``Graph``,
``load_graph``). It reads the same converted directories (``meta.json``
plus ``part_*.npz``) and builds, with the same host code, the grouped CSR
with its per-slot source, type, weight and edge id, the per-group alias
tables, the ``fan`` and ``fanu`` packs that the fan-row draws read, the
``group``, ``adj`` and ``sample`` packs that the general verbs read
(``ops/sampling.py``'s ``sample_neighbor`` and full neighborhoods), the
``ell`` pack that whole-graph propagation reads, the in-CSR where the
graph was converted with in-edges, the per-node-type alias tables that
the root draw reads, the per-edge-type alias tables over the CSR slots
that the edge draw reads, each node's type and weight, the dense and
sparse node and edge features, each edge row's type and CSR slot, the
hash of each binary node feature that the query's predicates compare
(``string_hash32``) and the graph-label membership table; the attribute
indexes of ops/index.py (``node_index``, ``edge_index_``) are built after
the load. Only the fields these paths need live on the device; external
ids and binary node and edge features stay on the host. ``feature_dtype`` (e.g.
``torch.bfloat16``) keeps the dense feature tables half width, cast on
the host with round-to-nearest-even as numpy's cast to jnp.bfloat16
rounds. ``initialize_graph``/``default_graph`` hold a process-default
graph, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph import convert as _convert
from euler_tpu_torch.graph.meta import BINARY, DENSE, SPARSE, GraphMeta
from euler_tpu_torch.ops.alias import (FAN_D, FANU_MAX_TYPES, FANU_SHIFT,
                                       build_fan_pack, build_group_alias,
                                       build_typed_alias_tables)
from euler_tpu_torch.ops.rel_agg import RelHubs
from euler_tpu_torch.utils import io as _io

#: packs the port builds by default: the fan rows that the sampled flows
#: read. The reference builds its ALL_PACKS ("group", "adj", "sample",
#: "fan", "ell") by default; the port builds the others on request, since
#: the main path reads none of them and "sample" alone is 36 B an edge
#: (and a hop draws otherwise with it: give both packages the same packs
#: to compare draws). On request: "group" (each group's CSR bounds in one
#: row), "adj" (each CSR slot's payload in one row) and "sample" (the
#: fused alias-draw row) for the general verbs; "fanu" (union fan rows,
#: multi-type draws), which the reference leaves out of its ALL_PACKS;
#: "ell" (whole-graph ELL rows and their transpose); "rel" (the typed
#: whole-graph pack of R-GCN's per-relation mean, ``RelPack``), which the
#: reference does not have. Every verb draws without a pack it lacks (a
#: hop without "fan" through the sample pack or the group alias tables).
PACKS = ("fan",)
#: packs the port can build
KNOWN_PACKS = ("group", "adj", "sample", "fan", "fanu", "ell", "rel")
#: the block of XLA's CPU split of a cumsum's reduce_window; the cdf
#: matches ``jnp.cumsum`` bit for bit only with this value
XLA_CUMSUM_BLOCK = 16


def xla_cumsum(w: np.ndarray) -> np.ndarray:
    """The f32 running sum of ``w`` as XLA adds it on the CPU
    (``jnp.cumsum``, a reduce_window that XLA splits into blocks): left to
    right for up to ``XLA_CUMSUM_BLOCK`` values; past that, left to right
    inside each block, and each block's sum offset by the running sum of
    the earlier blocks' totals, taken the same way."""
    block = XLA_CUMSUM_BLOCK
    w = np.asarray(w, np.float32)
    n = len(w)
    if n <= block:
        return np.cumsum(w, dtype=np.float32)
    m = -(-n // block)
    inner = np.zeros(m * block, np.float32)
    inner[:n] = w
    inner = np.cumsum(inner.reshape(m, block), axis=1, dtype=np.float32)
    before = np.zeros(m, np.float32)
    before[1:] = xla_cumsum(inner[:-1, -1])
    return (inner + before[:, None]).reshape(-1)[:n]


def string_hash32(s: str) -> int:
    """Deterministic FNV-1a 32-bit hash of a string, as a signed int32; a
    copy of euler_tpu/graph/store.py ``string_hash32``. Binary (string)
    features are compared on the device through it."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h - 2**32 if h >= 2**31 else h


def _adj_pack_np(adj_dst, adj_type, adj_eid, adj_w):
    """Interleaved (dst, type, eid, weight bits) int32 rows, one a CSR
    slot; a copy of euler_tpu/graph/store.py ``_adj_pack_np``."""
    return np.stack(
        [adj_dst.astype(np.int32), adj_type.astype(np.int32),
         adj_eid.astype(np.int32),
         adj_w.astype(np.float32).view(np.int32)], axis=1)


def _sample_pack_np(group_ptr, prob, alias, adj_pack):
    """The fused alias-draw rows (``GraphTensors.sample_pack``); a copy of
    euler_tpu/graph/store.py ``_sample_pack_np``. ``alias`` holds
    within-group slots: each resolves to a global slot through its
    group's start, and both candidates' payloads are inlined, so that a
    weighted draw reads one row."""
    gp = np.asarray(group_ptr, np.int64)
    e = adj_pack.shape[0]
    seg = np.repeat(np.arange(len(gp) - 1), np.diff(gp))
    alias_global = gp[seg] + np.asarray(alias, np.int64)
    out = np.empty((e, 9), np.int32)
    out[:, 0] = np.asarray(prob, np.float32).view(np.int32)
    out[:, 1:5] = adj_pack
    out[:, 5:9] = adj_pack[alias_global] if e else adj_pack
    return out


def _graph_members_np(labels: np.ndarray) -> Dict[str, np.ndarray]:
    """The graph-label membership table of the ``graph_label`` binary node
    feature, as euler_tpu/graph/store.py:393-411 builds it: one row per
    distinct non-empty label in sorted order, holding the label's nodes
    padded with -1, and each row's count. No label: no table."""
    uniq = sorted({v for v in labels if v != ""})
    members = [np.nonzero(labels == u)[0].astype(np.int32) for u in uniq]
    if not members:
        return {}
    tab = np.full((len(uniq), max(len(m) for m in members)), -1, np.int32)
    for i, m in enumerate(members):
        tab[i, :len(m)] = m
    return dict(graph_members=tab, graph_member_cnt=np.asarray(
        [len(m) for m in members], np.int32))


@dataclasses.dataclass
class AliasTables:
    """Per-type alias tables over a typed population (ops/alias.py
    ``build_typed_alias_tables``), on one device.

    ``cdf`` is the running sum of ``w_sum`` that a draw over every type
    searches. The reference takes ``jnp.cumsum(w_sum)`` at each draw;
    torch.cumsum associates otherwise and differs in the last bit for
    three types or more, so the sum is taken once on the host when the
    graph is built, in XLA's order (``xla_cumsum``).
    """

    ids: torch.Tensor       # int32 [n] population sorted by type
    type_ptr: torch.Tensor  # int32 [T+1]
    prob: torch.Tensor      # f32   [n]
    alias: torch.Tensor     # int32 [n] (within-type slots)
    w_sum: torch.Tensor     # f32   [T]
    cdf: torch.Tensor       # f32   [T] running sum of w_sum (xla_cumsum)

    @classmethod
    def build(cls, type_of: np.ndarray, weights: np.ndarray,
              num_types: int, put) -> "AliasTables":
        """The tables of ``build_typed_alias_tables``, each array passed
        through ``put`` (numpy -> device tensor)."""
        t = build_typed_alias_tables(type_of, weights, num_types)
        return cls(ids=put(t["ids"]),
                   type_ptr=put(t["type_ptr"].astype(np.int32)),
                   prob=put(t["prob"]), alias=put(t["alias"]),
                   w_sum=put(t["w_sum"]),
                   cdf=put(xla_cumsum(t["w_sum"])))

    def to(self, device) -> "AliasTables":
        return AliasTables(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class RelPack:
    """The typed whole-graph pack ("rel"): what R-GCN's per-relation mean
    reads beside the CSR (``group_ptr`` groups each node's out-edges by
    edge type, ``adj_dst`` their neighbours), built once on the host.

    ``tptr``/``tsrc`` are the transposed CSR, grouped by (neighbour u,
    edge type r): segment u * R + r lists the nodes t whose segment (t, r)
    reads u, and ``tw`` holds 1 / c(t, r), the length of that segment, so
    that the mean's gradient to the neighbours' rows is a gather, never a
    scatter (``ops.rel_agg.rel_mean_tr``). ``hubs``/``tr_hubs`` chunk the
    two CSRs' segments longer than ``ops.rel_agg.HUB``.

    Host fields: ``type_lo``, node type k's ids [type_lo[k], type_lo[k +
    1]) where the node types run in contiguous id ranges (else empty);
    ``row_lo``/``row_hi``, the ids each edge type's neighbours lie in: the
    whole range of the one node type they all have where types run in
    ranges, else [least, greatest + 1) ([0, 0) for an edge type with no
    edge).
    """

    tptr: torch.Tensor        # int32 [N*R + 1]
    tsrc: torch.Tensor        # int32 [E]
    tw: torch.Tensor          # f32   [E]
    hubs: RelHubs
    tr_hubs: RelHubs
    type_lo: Tuple[int, ...]
    row_lo: Tuple[int, ...]
    row_hi: Tuple[int, ...]

    def to(self, device) -> "RelPack":
        return dataclasses.replace(
            self, tptr=self.tptr.to(device), tsrc=self.tsrc.to(device),
            tw=self.tw.to(device), hubs=self.hubs.to(device),
            tr_hubs=self.tr_hubs.to(device))


@dataclasses.dataclass
class GraphTensors:
    """The device graph. Every array field is a tensor on one device."""

    meta: GraphMeta
    node_type: torch.Tensor      # int32 [N]
    node_w: torch.Tensor         # f32   [N]
    group_ptr: torch.Tensor      # int32 [N*ET + 1]
    # per CSR slot (edges sorted by (src, type, dst)): the edge's source,
    # destination, type, weight and original row
    adj_src: torch.Tensor        # int32 [E]
    adj_dst: torch.Tensor        # int32 [E]
    adj_type: torch.Tensor       # int32 [E]
    adj_w: torch.Tensor          # f32   [E]
    adj_eid: torch.Tensor        # int32 [E]
    adj_prob: torch.Tensor       # f32   [E] per-group alias keep-prob
    adj_alias: torch.Tensor      # int32 [E] within-group alias slots
    group_w_sum: torch.Tensor    # f32   [N, ET]
    dense_nf: Dict[str, torch.Tensor]
    node_alias: AliasTables      # population = nodes, typed by node type
    edge_alias: AliasTables      # population = CSR slots, typed by edge type
    # interleaved rows of the general verbs: each group's (lo, hi) CSR
    # bounds ("group"), each slot's (dst, type, eid, weight bits) ("adj"),
    # and the fused alias-draw row ("sample"): the keep-probability bits,
    # then the payload if kept and the payload if aliased, so that a
    # weighted draw reads one row
    group_pack: Optional[torch.Tensor] = None     # int32 [N*ET, 2]
    adj_pack: Optional[torch.Tensor] = None       # int32 [E, 4]
    sample_pack: Optional[torch.Tensor] = None    # int32 [E, 9]
    # per-(node, edge_type) fan rows (ops/alias.py FAN_* layout) and the
    # groups with degree > FAN_D whose rows are reservoirs
    fan_pack: Optional[torch.Tensor] = None       # int32 [N*ET, 128]
    fan_over_rows: Optional[torch.Tensor] = None  # int32 [K]
    # union fan rows ("fanu" pack, ops/alias.py FANU_*): one row per node
    # over all edge types, lanes packing (etype << 27) | dst; fanu_ptr/
    # dst/prob/alias are the union-group CSR the reservoir redraw reads
    fanu_pack: Optional[torch.Tensor] = None       # int32 [N, 128]
    fanu_over_rows: Optional[torch.Tensor] = None  # int32 [K]
    fanu_ptr: Optional[torch.Tensor] = None        # int32 [N+1]
    fanu_dst: Optional[torch.Tensor] = None        # int32 [E] packed
    fanu_prob: Optional[torch.Tensor] = None       # f32   [E]
    fanu_alias: Optional[torch.Tensor] = None      # int32 [E]
    # whole-graph ELL pack ("ell"): every node's out-neighborhood (all
    # types, in CSR slot order) as a regular [N, C] row padded with -1,
    # and ell_tpos, per node u, the flat cells t*C + c that read u (the
    # transpose adjacency), so the backward of a whole-graph aggregate is
    # a gather, never a scatter (dataflow/block.py ``_ell_agg``)
    ell_nbr: Optional[torch.Tensor] = None      # int32 [N, C] (-1 pad)
    ell_w: Optional[torch.Tensor] = None        # f32   [N, C]
    ell_eid: Optional[torch.Tensor] = None      # int32 [N, C]
    ell_ty: Optional[torch.Tensor] = None       # int32 [N, C]
    ell_tpos: Optional[torch.Tensor] = None     # int32 [N, C_in] (-1 pad)
    ell_in_deg: Optional[torch.Tensor] = None   # f32   [N, ET]
    # the typed whole-graph pack ("rel")
    rel: Optional[RelPack] = None
    # sparse node features: name -> (ids int32 [N, L] padded with -1,
    # lengths int32 [N]); edge features and types by original edge row
    sparse_nf: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)
    dense_ef: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    sparse_ef: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)
    eid_type: Optional[torch.Tensor] = None     # int32 [E]
    # each original edge row's CSR slot (the stable argsort of adj_eid),
    # so that a verb that names edges by row (Query.e) never sorts
    eid_slot: Optional[torch.Tensor] = None     # int32 [E]
    # the int32 string_hash32 of each binary node feature's values, which
    # the query's predicates compare on the device
    binary_hash_nf: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # ops/index.py's AttrIndex of each indexed attribute ("name:column"),
    # built after the load by ``index.build_attr_index``
    node_index: Dict[str, object] = dataclasses.field(default_factory=dict)
    edge_index_: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the in-CSR of a graph converted with in-edges (meta.has_in_edges):
    # groups by (dst, edge_type), each slot's neighbor the true source
    in_group_ptr: Optional[torch.Tensor] = None   # int32 [N*ET + 1]
    in_adj_src: Optional[torch.Tensor] = None     # int32 [E]
    in_adj_w: Optional[torch.Tensor] = None       # f32   [E]
    in_adj_eid: Optional[torch.Tensor] = None     # int32 [E]
    in_group_w_sum: Optional[torch.Tensor] = None  # f32  [N, ET]
    in_adj_prob: Optional[torch.Tensor] = None    # f32   [E]
    in_adj_alias: Optional[torch.Tensor] = None   # int32 [E]
    # graph-label membership (the 'graph_label' binary node feature): the
    # nodes of each graph, padded with -1, and their counts
    graph_members: Optional[torch.Tensor] = None     # int32 [G, maxN]
    graph_member_cnt: Optional[torch.Tensor] = None  # int32 [G]

    @property
    def device(self) -> torch.device:
        return self.adj_dst.device

    def to(self, device) -> "GraphTensors":
        """A copy with every tensor on ``device``."""
        def mv(v):
            # tensors, AliasTables and ops/index.py's AttrIndex
            if isinstance(v, torch.Tensor) or callable(getattr(v, "to",
                                                               None)):
                return v.to(device)
            if isinstance(v, dict):
                return {k: mv(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return tuple(mv(x) for x in v)
            return v
        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def _ell_pack_np(n, net, group_ptr, adj_dst, adj_w, adj_eid, adj_type):
    """The whole-graph ELL pack (``GraphTensors.ell_*``) as numpy arrays;
    a copy of euler_tpu/graph/store.py ``_ell_pack_np``.

    Returns None (pack skipped) when padding would explode: ELL rows are
    max-degree wide, so a hub would inflate [N, C] far past the CSR's
    size. Gate: C and C_in each <= max(64, 4 * average degree), and
    N * C < 2^31.
    """
    E = len(adj_dst)
    node_lo = group_ptr[np.arange(n) * net]
    node_hi = group_ptr[np.arange(n) * net + net]
    row_deg = (node_hi - node_lo).astype(np.int64)
    in_deg = np.bincount(adj_dst, minlength=n).astype(np.int64)
    C = int(row_deg.max(initial=0))
    C_in = int(in_deg.max(initial=0))
    cap = max(64, 4 * max(1, E // max(n, 1)))
    if C > cap or C_in > cap or n * C >= 2 ** 31:
        return None
    rows = np.repeat(np.arange(n, dtype=np.int64), row_deg)
    pos = np.arange(E, dtype=np.int64) - np.repeat(node_lo, row_deg)
    nbr = np.full((n, C), -1, np.int32)
    w = np.zeros((n, C), np.float32)
    eid = np.full((n, C), -1, np.int32)
    ty = np.full((n, C), -1, np.int32)
    nbr[rows, pos] = adj_dst
    w[rows, pos] = adj_w
    eid[rows, pos] = adj_eid
    ty[rows, pos] = adj_type
    # transpose positions: for node u, the flat cells (row * C + pos)
    # that read u, sorted stable by u so that each u's cells pack left
    p = (rows * C + pos).astype(np.int64)
    order = np.argsort(adj_dst, kind="stable")
    u_sorted = adj_dst[order]
    start = np.concatenate([[0], np.cumsum(in_deg)[:-1]])
    pos_in_u = np.arange(E, dtype=np.int64) - np.repeat(start, in_deg)
    tpos = np.full((n, C_in), -1, np.int64)
    tpos[u_sorted, pos_in_u] = p[order]
    ell_in_deg = np.zeros((n, net), np.float32)
    np.add.at(ell_in_deg, (adj_dst, adj_type), 1.0)
    return dict(ell_nbr=nbr, ell_w=w, ell_eid=eid, ell_ty=ty,
                ell_tpos=tpos.astype(np.int32), ell_in_deg=ell_in_deg)


def _rel_pack_np(n, net, group_ptr, adj_src, adj_dst, adj_type, node_type,
                 num_node_types) -> dict:
    """The typed whole-graph pack's arrays (``RelPack``), numpy, from the
    CSR's slots (sorted by (source, type, destination))."""
    m = len(adj_dst)
    tptr, tsrc, _, _, _, perm = _convert.build_csr(
        n, net, adj_dst, adj_src, adj_type, np.ones(m, np.float32),
        np.arange(m, dtype=np.int32))
    cnt = np.diff(np.asarray(group_ptr, np.int64))
    seg = adj_src.astype(np.int64) * net + adj_type
    tw = (1.0 / cnt[seg].astype(np.float64)).astype(np.float32)[perm]
    node_type = np.asarray(node_type, np.int64)
    ranged = bool(np.all(node_type[1:] >= node_type[:-1])) if n else True
    type_lo = tuple(int(v) for v in np.searchsorted(
        node_type, np.arange(num_node_types + 1))) if ranged else ()
    # each edge type's neighbours: their node types, least and greatest id
    T = max(num_node_types, 1)
    per_type = np.bincount(adj_type.astype(np.int64) * T
                           + node_type[adj_dst], minlength=net * T
                           ).reshape(net, T)
    kinds = [np.nonzero(row)[0] for row in per_type]
    if any(len(k) > 1 or not ranged for k in kinds):
        lows = np.full(net, n, np.int64)
        highs = np.full(net, -1, np.int64)
        np.minimum.at(lows, adj_type, adj_dst)
        np.maximum.at(highs, adj_type, adj_dst)
    row_lo, row_hi = [], []
    for r in range(net):
        one = int(kinds[r][0]) if len(kinds[r]) == 1 else -1
        if one >= 0 and ranged:
            lo, hi = type_lo[one], type_lo[one + 1]
        elif len(kinds[r]):
            lo, hi = int(lows[r]), int(highs[r]) + 1
        else:
            lo = hi = 0
        row_lo.append(lo), row_hi.append(hi)
    return dict(tptr=tptr.astype(np.int32), tsrc=tsrc.astype(np.int32),
                tw=tw, hubs=RelHubs.build_np(group_ptr),
                tr_hubs=RelHubs.build_np(tptr), type_lo=type_lo,
                row_lo=tuple(row_lo), row_hi=tuple(row_hi))


def _check_edge_ids(eid: np.ndarray) -> None:
    """The edge-row tables (``eid_type``, ``dense_ef``, ``sparse_ef``) need
    edge ids that are a permutation of 0..E-1, as the reference requires
    (euler_tpu/graph/store.py:320-332)."""
    e = np.sort(eid.astype(np.int64))
    if len(e) and not np.array_equal(e, np.arange(len(e), dtype=np.int64)):
        raise ValueError(
            "edge ids must be a dense permutation of 0..E-1 "
            f"(got min={e[0]}, max={e[-1]}, E={len(e)}); re-run the "
            "converter, which assigns them")


def _inverse_permutation(p: np.ndarray) -> np.ndarray:
    """int32 ``inv`` with ``inv[p[i]] = i``: for ``adj_eid``, a permutation
    of 0..E-1 (``_check_edge_ids``), the reference's stable argsort
    (euler_tpu/graph/store.py:477), by a scatter in place of a sort."""
    inv = np.empty(len(p), np.int32)
    inv[p] = np.arange(len(p), dtype=np.int32)
    return inv


def _load_parts(path: str) -> Dict[str, np.ndarray]:
    """Every ``part_*.npz`` under ``path``, each array concatenated over
    the partitions in file order; several partitions are read on up to 8
    threads (zlib and file reads release the GIL), as the reference reads
    them (euler_tpu/graph/store.py:257-280)."""
    files = _io.glob(_io.join(path, "part_*.npz"))
    if not files:
        raise FileNotFoundError(f"no part_*.npz under {path}")

    def read(f):
        with _io.open_file(f, "rb") as fh:
            return dict(np.load(fh, allow_pickle=False))

    if len(files) > 1:
        with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
            parts = list(ex.map(read, files))
    else:
        parts = [read(files[0])]
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}



class Graph:
    """Host-side graph: external ids and binary features on the host,
    ``tensors`` on a device.

    The equivalent of euler_tpu's ``Graph`` for the packs in
    ``KNOWN_PACKS``. ``feature_dtype`` stores the dense node and edge
    feature tables in that dtype (e.g. ``torch.bfloat16``).
    """

    def __init__(self, meta: GraphMeta, arrays: Dict[str, np.ndarray],
                 packs: Tuple[str, ...] = PACKS, device=None,
                 feature_dtype: Optional[torch.dtype] = None):
        unknown = set(packs) - set(KNOWN_PACKS)
        if unknown:
            raise NotImplementedError(
                f"packs {sorted(unknown)} are not ported yet; the port "
                f"builds {KNOWN_PACKS}")
        dev = resolve_device(device)
        self.meta = meta
        n, net = meta.n_nodes, meta.num_edge_types

        # nodes may arrive partition-interleaved: restore local-id order
        order = np.argsort(arrays["node_local"], kind="stable")
        self.ext_ids = arrays["ext_ids"][order]
        node_type = arrays["node_type"][order]
        node_w = arrays["node_w"][order]
        self._local_of = {int(e): i for i, e in enumerate(self.ext_ids)}

        eid = np.asarray(arrays["eid"])
        _check_edge_ids(eid)
        (group_ptr, adj_dst, adj_w, _, adj_eid, perm) = _convert.build_csr(
            n, net, arrays["src"], arrays["dst"], arrays["etype"],
            arrays["ew"], arrays["eid"])
        adj_src = arrays["src"][perm].astype(np.int32)
        adj_type = arrays["etype"][perm].astype(np.int32)
        # exact per-group weight sums (no cumsum cancellation)
        seg = np.repeat(np.arange(n * net), np.diff(group_ptr))
        gws = np.zeros(n * net, np.float64)
        np.add.at(gws, seg, adj_w.astype(np.float64))
        group_w_sum = gws.astype(np.float32).reshape(n, net)
        adj_prob, adj_alias = build_group_alias(group_ptr, adj_w)

        dense_nf = {spec.name: arrays[f"nf_d:{spec.name}"][order]
                    for spec in meta.node_features if spec.kind == DENSE}
        sparse_nf = {spec.name: (arrays[f"nf_sp:{spec.name}"][order],
                                 arrays[f"nf_splen:{spec.name}"][order])
                     for spec in meta.node_features if spec.kind == SPARSE}
        # edge features and types in original edge-row order
        eorder = np.argsort(eid, kind="stable")
        dense_ef = {spec.name: arrays[f"ef_d:{spec.name}"][eorder]
                    for spec in meta.edge_features if spec.kind == DENSE}
        sparse_ef = {spec.name: (arrays[f"ef_sp:{spec.name}"][eorder],
                                 arrays[f"ef_splen:{spec.name}"][eorder])
                     for spec in meta.edge_features if spec.kind == SPARSE}
        self.binary_nf = {spec.name: arrays[f"nf_bin:{spec.name}"][order]
                          for spec in meta.node_features
                          if spec.kind == BINARY}
        self.binary_ef = {spec.name: arrays[f"ef_bin:{spec.name}"][eorder]
                          for spec in meta.edge_features
                          if spec.kind == BINARY}
        extra = {}
        if meta.has_in_edges:
            # the in-CSR: groups by dst, the "neighbor" column the source
            (ig_ptr, i_src, i_w, _, i_eid, _) = _convert.build_csr(
                n, net, arrays["dst"], arrays["src"], arrays["etype"],
                arrays["ew"], arrays["eid"])
            iseg = np.repeat(np.arange(n * net), np.diff(ig_ptr))
            igws = np.zeros(n * net, np.float64)
            np.add.at(igws, iseg, i_w.astype(np.float64))
            i_prob, i_alias = build_group_alias(ig_ptr, i_w)
            extra.update(in_group_ptr=ig_ptr.astype(np.int32),
                         in_adj_src=i_src, in_adj_w=i_w, in_adj_eid=i_eid,
                         in_group_w_sum=igws.astype(np.float32).reshape(
                             n, net),
                         in_adj_prob=i_prob, in_adj_alias=i_alias)
        if "graph_label" in self.binary_nf:
            extra.update(_graph_members_np(self.binary_nf["graph_label"]))
        if "group" in packs:
            extra["group_pack"] = np.stack(
                [group_ptr[:-1], group_ptr[1:]], axis=1).astype(np.int32)
        if "adj" in packs or "sample" in packs:
            adj_pack = _adj_pack_np(adj_dst, adj_type, adj_eid, adj_w)
            if "adj" in packs:
                extra["adj_pack"] = adj_pack
            if "sample" in packs:
                extra["sample_pack"] = _sample_pack_np(group_ptr, adj_prob,
                                                       adj_alias, adj_pack)

        def put(x, dtype=None):
            # the cast happens on the host: torch rounds f32 to bf16 to
            # nearest even, as numpy's cast to jnp.bfloat16 does
            t = torch.from_numpy(np.ascontiguousarray(x))
            return (t if dtype is None else t.to(dtype)).to(dev)

        pack_fields = {k: put(v) for k, v in extra.items()}
        if "fan" in packs:
            pack_fields.update(
                fan_pack=put(build_fan_pack(group_ptr, adj_dst, adj_prob,
                                            adj_alias,
                                            group_w_sum.reshape(-1))),
                fan_over_rows=put(np.nonzero(
                    np.diff(group_ptr) > FAN_D)[0].astype(np.int32)))
        # the reference's gate: built only where the lanes can encode it,
        # and otherwise skipped without a word
        if ("fanu" in packs and n and len(adj_dst) and 2 <= net
                <= FANU_MAX_TYPES and n < (1 << FANU_SHIFT)):
            node_ptr = group_ptr[::net].astype(np.int64)          # [N+1]
            packed = (adj_type << FANU_SHIFT) | adj_dst
            prob_u, alias_u = build_group_alias(node_ptr, adj_w)
            wsum_u = group_w_sum.reshape(n, net).sum(axis=1)
            pack_fields.update(
                fanu_pack=put(build_fan_pack(node_ptr, packed, prob_u,
                                             alias_u, wsum_u)),
                fanu_over_rows=put(np.nonzero(
                    np.diff(node_ptr) > FAN_D)[0].astype(np.int32)),
                fanu_ptr=put(node_ptr.astype(np.int32)),
                fanu_dst=put(packed), fanu_prob=put(prob_u),
                fanu_alias=put(alias_u))
        if "ell" in packs and n and len(adj_dst):
            ell = _ell_pack_np(n, net, group_ptr, adj_dst, adj_w, adj_eid,
                               adj_type)
            if ell is not None:            # degree-gated, as the reference
                pack_fields.update({k: put(v) for k, v in ell.items()})
        if "rel" in packs:
            rel = _rel_pack_np(n, net, group_ptr, adj_src, adj_dst, adj_type,
                               node_type, meta.num_node_types)
            pack_fields["rel"] = RelPack(
                tptr=put(rel["tptr"]), tsrc=put(rel["tsrc"]),
                tw=put(rel["tw"]),
                **{k: RelHubs(**{a: put(b) for a, b in rel[k].items()})
                   for k in ("hubs", "tr_hubs")},
                **{k: rel[k] for k in ("type_lo", "row_lo", "row_hi")})
        self.tensors = GraphTensors(
            meta=meta,
            node_type=put(node_type.astype(np.int32)),
            node_w=put(np.asarray(node_w, np.float32)),
            group_ptr=put(group_ptr.astype(np.int32)),
            adj_src=put(adj_src),
            adj_dst=put(adj_dst),
            adj_type=put(adj_type),
            adj_w=put(adj_w),
            adj_eid=put(adj_eid),
            adj_prob=put(adj_prob),
            adj_alias=put(adj_alias),
            group_w_sum=put(group_w_sum),
            dense_nf={k: put(v, feature_dtype) for k, v in dense_nf.items()},
            sparse_nf={k: (put(v[0]), put(v[1]))
                       for k, v in sparse_nf.items()},
            dense_ef={k: put(v, feature_dtype) for k, v in dense_ef.items()},
            sparse_ef={k: (put(v[0]), put(v[1]))
                       for k, v in sparse_ef.items()},
            eid_type=put(arrays["etype"][eorder].astype(np.int32)),
            eid_slot=put(_inverse_permutation(adj_eid)),
            binary_hash_nf={
                k: put(np.asarray([string_hash32(x) for x in v], np.int32))
                for k, v in self.binary_nf.items()},
            node_alias=AliasTables.build(node_type, node_w,
                                         meta.num_node_types, put),
            edge_alias=AliasTables.build(adj_type, adj_w, net, put),
            **pack_fields)

    # ---- host-side lookups (reference: store.py:496-516) ------------------
    def local_id(self, ext_id: int) -> int:
        return self._local_of[int(ext_id)]

    def local_ids(self, ext_ids) -> np.ndarray:
        return np.asarray([self._local_of[int(e)] for e in ext_ids], np.int32)

    def get_binary_feature(self, nodes, names):
        """Binary (string) node features, host only: one array per name."""
        nodes = np.asarray(nodes)
        return [self.binary_nf[n][nodes] for n in names]

    def get_edge_binary_feature(self, eids, names):
        """Binary edge features by original edge row, host only."""
        eids = np.asarray(eids)
        return [self.binary_ef[n][eids] for n in names]

    @property
    def max_id(self) -> int:
        return self.meta.n_nodes - 1


def load_graph(path: str, packs: Tuple[str, ...] = PACKS, device=None,
               feature_dtype: Optional[torch.dtype] = None) -> Graph:
    """Load a converted graph directory (local files) onto ``device``;
    ``feature_dtype`` as ``Graph``'s."""
    with _io.open_file(_io.join(path, _convert.META_FILE), "r") as f:
        meta = GraphMeta.from_json(f.read())
    return Graph(meta, _load_parts(path), packs=packs, device=device,
                 feature_dtype=feature_dtype)


# ---- the process-default graph (reference: store.py:536-553) -------------
_default_graph: Optional[Graph] = None


def initialize_graph(path_or_graph, **kw) -> Graph:
    """Set the process-default graph: a ``Graph``, or a directory that
    ``load_graph(path, **kw)`` loads (cf. tf_euler's
    initialize_embedded_graph)."""
    global _default_graph
    if isinstance(path_or_graph, Graph):
        _default_graph = path_or_graph
    else:
        _default_graph = load_graph(path_or_graph, **kw)
    return _default_graph


def default_graph() -> Graph:
    if _default_graph is None:
        raise RuntimeError("no graph initialized; call initialize_graph first")
    return _default_graph
