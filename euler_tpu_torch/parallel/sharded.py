"""The sharded graph store and the sharded verbs, over torch.distributed.

Counterpart of euler_tpu/parallel/sharded.py. Node ``v`` lives on shard
``v % S`` at local row ``v // S``. The reference runs one SPMD program
under ``shard_map``; the port runs one process a rank, and a rank's
``ShardView`` holds its shard's tensors and its graph group (the S ranks
that share its data index). Every verb answers for the ids this shard
owns and combines over the graph group, as the reference's do:

- the spread path (``_spread`` + ``_owner_to_mine``): every member's
  query ids are gathered, each owner answers every row it owns among
  the [S*b] and one tiled all_to_all sends each member its rows back;
- the request-routed path (``_request_route``): each member sends each
  owner only the distinct ids it owns, [S, cap_out] a member, and the
  answers come back the same way. Feature-like verbs take it from
  ``b >= 16 S``; samplers only past 4 shards, or when
  ``set_owner_compute(True)`` forces it (``_owner_cap``).

Random verbs are split as on one device: a draw step gives uniforms, a
deterministic select reads them. The uniforms follow the answering
owner, so a sharded draw step gives uniforms of the OWNER's answer
shape ([S*b, ...] spread, [S*cap_out, ...] routed; ``sampler_rows``),
where the reference's owner draws with its own key. The cooperative
root and edge draws share member 0's uniforms for the shard choice
(``_sync``, the reference's ``_sync_key``) and read each shard's own
uniforms for the draw inside the shard (the reference folds the shard
index into the key).

Each owner's local work is the one-device verb over its shard
(``ShardView.local``, a ``GraphTensors`` of local rows whose neighbor
ids stay global), called with local rows: ``id // S`` where this shard
owns the id and -1 where it does not, which gives the masked answer the
reference's ``ok & owned`` gives. So the fan-row draw is ``fan_draw``'s
kernel and a dense feature answer ``gather_rows``'s, on the card as on
one device.

Two layers, as in the reference:

- ``ShardedGraphTensors``: the host-built per-shard numpy arrays,
  stacked with a leading dim S and padded to one global ``n_max`` and
  ``e_max`` (``build_sharded``); ``write_shards`` saves one file a shard.
- ``ShardView``: one rank's shard on its device with its mesh
  (``take_shard``, ``load_shard``); the op modules route a view here.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from euler_tpu_torch.graph import convert as _convert
from euler_tpu_torch.graph.meta import GraphMeta
from euler_tpu_torch.graph.store import (AliasTables, GraphTensors,
                                         _adj_pack_np, _sample_pack_np,
                                         xla_cumsum)
from euler_tpu_torch.ops import index as index_ops, sampling
from euler_tpu_torch.ops import walk as walk_ops
from euler_tpu_torch.ops.alias import (FAN_D, FANU_MAX_TYPES, FANU_SHIFT,
                                       alias_select, build_fan_pack,
                                       build_group_alias,
                                       build_typed_alias_tables)
from euler_tpu_torch.ops.gather_rows import gather_rows
from euler_tpu_torch.parallel import comms

IMAX = torch.iinfo(torch.int32).max
_ALIAS_KEYS = ("ids", "type_ptr", "prob", "alias", "w_sum")


# ---------------------------------------------------------------------------
# the host store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedGraphTensors:
    """Stacked per-shard numpy arrays; leading dim = shard (the
    reference's fields, sharded.py:49-117). ``node_alias`` and
    ``edge_alias`` are dicts of the alias tables' stacked arrays."""

    meta: GraphMeta
    num_shards: int
    node_type: np.ndarray        # [S, n_max]
    node_w: np.ndarray           # [S, n_max]
    group_ptr: np.ndarray        # [S, n_max*ET+1]
    adj_dst: np.ndarray          # [S, e_max] GLOBAL neighbor ids (-1 pad)
    adj_type: np.ndarray         # [S, e_max]
    adj_w: np.ndarray            # [S, e_max]
    adj_w_cumsum: np.ndarray     # [S, e_max]
    adj_eid: np.ndarray          # [S, e_max] GLOBAL edge rows
    group_w_sum: np.ndarray      # [S, n_max, ET]
    adj_prob: np.ndarray         # [S, e_max] per-group alias tables
    adj_alias: np.ndarray        # [S, e_max] (within-group slots)
    node_alias: Dict[str, np.ndarray]
    edge_alias: Dict[str, np.ndarray]
    dense_nf: Dict[str, np.ndarray]              # [S, n_max, d]
    sparse_nf: Dict[str, Tuple[np.ndarray, np.ndarray]]
    dense_ef: Dict[str, np.ndarray]              # [S, e_max, d] by slot
    sparse_ef: Dict[str, Tuple[np.ndarray, np.ndarray]]
    binary_hash_nf: Dict[str, np.ndarray]        # [S, n_max]
    # each shard's owned global eids ascending (pad INT32_MAX) and the
    # matching local CSR slot
    eid_sorted: np.ndarray       # [S, e_max]
    eid_slot: np.ndarray         # [S, e_max]
    # replicated: per-shard per-type weight sums (root and edge draws)
    shard_node_w: np.ndarray     # [S, NT]
    shard_edge_w: np.ndarray     # [S, ET]
    group_pack: Optional[np.ndarray] = None    # [S, n_max*ET, 2]
    adj_pack: Optional[np.ndarray] = None      # [S, e_max, 4]
    sample_pack: Optional[np.ndarray] = None   # [S, e_max, 9]
    fan_pack: Optional[np.ndarray] = None      # [S, n_max*ET, 128]
    fanu_pack: Optional[np.ndarray] = None     # [S, n_max, 128]
    fanu_ptr: Optional[np.ndarray] = None      # [S, n_max+1]
    fanu_prob: Optional[np.ndarray] = None     # [S, e_max]
    fanu_alias: Optional[np.ndarray] = None    # [S, e_max]
    # the dst-partitioned in-CSR (graphs with in-edges)
    in_group_ptr: Optional[np.ndarray] = None    # [S, n_max*ET+1]
    in_adj_src: Optional[np.ndarray] = None      # [S, ie_max] GLOBAL ids
    in_adj_w: Optional[np.ndarray] = None
    in_adj_eid: Optional[np.ndarray] = None
    in_group_w_sum: Optional[np.ndarray] = None  # [S, n_max, ET]
    in_adj_prob: Optional[np.ndarray] = None
    in_adj_alias: Optional[np.ndarray] = None
    # replicated graph-label membership [G, maxN] (-1 pad)
    graph_members: Optional[np.ndarray] = None


#: fields of ShardedGraphTensors that every rank holds whole
REPLICATED = ("shard_node_w", "shard_edge_w", "graph_members")


def _build_shard_core(meta: GraphMeta, own_node_type, own_node_w,
                      lsrc, dst, etype, ew, eid):
    """One shard's unpadded CSR from its edges (a copy of
    sharded.py:176-197). ``lsrc`` is LOCAL rows; ``dst``/``eid`` stay
    GLOBAL. The sort is numpy's stable one, so that ``build_sharded``'s
    shards keep each group's edges in the one-device CSR's order (edges
    of one source, type and destination included), and each shard's
    alias tables and fan rows equal the one-device graph's."""
    ET, NT = meta.num_edge_types, meta.num_node_types
    (gp, col, w, cw, eid_s, perm) = _convert.build_csr(
        len(own_node_type), ET, np.ascontiguousarray(lsrc, np.int32),
        np.asarray(dst, np.int32), np.asarray(etype, np.int32),
        np.asarray(ew, np.float32), np.asarray(eid, np.int32), native=False)
    ety = np.asarray(etype)[perm]
    return dict(gp=gp, col=col, w=w, cw=cw, eid=eid_s, ety=ety, perm=perm,
                n_local=len(own_node_type), m_local=len(col),
                node_w_row=np.bincount(own_node_type, own_node_w,
                                       minlength=NT).astype(np.float32),
                edge_w_row=np.bincount(ety, w,
                                       minlength=ET).astype(np.float32))


def _pad_shard_fields(meta: GraphMeta, core, n_max, e_max,
                      own_node_type, own_node_w,
                      dense_nf_own, sparse_nf_own, binary_hash_own,
                      dense_ef_local, sparse_ef_local):
    """One shard's padded fields (a copy of sharded.py:200-312): node
    features in own-node order, edge features in local CSR slot order;
    every pack built over the local CSR."""
    ET, NT = meta.num_edge_types, meta.num_node_types
    n_local, m_local = core["n_local"], core["m_local"]

    def padn(a, fill=0, dtype=None):
        out = np.full((n_max,) + a.shape[1:], fill, dtype or a.dtype)
        out[:n_local] = a
        return out

    def pade(a, fill=0, dtype=None):
        out = np.full((e_max,) + a.shape[1:], fill, dtype or a.dtype)
        out[:m_local] = a
        return out

    gp = core["gp"]
    gp_full = np.full(n_max * ET + 1, gp[-1] if len(gp) else 0,
                      gp.dtype if len(gp) else np.int32)
    gp_full[: len(gp)] = gp
    seg = np.repeat(np.arange(len(gp_full) - 1), np.diff(gp_full))
    gws = np.zeros(n_max * ET, np.float64)
    np.add.at(gws, seg, core["w"].astype(np.float64))

    cw = core["cw"]
    last = cw[-1] if len(cw) else 0.0
    gprob, galias = build_group_alias(gp_full.astype(np.int64), core["w"])
    eorder = np.argsort(core["eid"], kind="stable").astype(np.int32)

    na = build_typed_alias_tables(
        np.concatenate([own_node_type,
                        np.full(n_max - n_local, NT, np.int32)]),
        np.concatenate([own_node_w, np.zeros(n_max - n_local)]), NT)
    ea = build_typed_alias_tables(
        np.concatenate([core["ety"],
                        np.full(e_max - m_local, ET, np.int32)]),
        np.concatenate([core["w"], np.zeros(e_max - m_local)]), ET)

    def alias_dict(t):
        return dict(ids=t["ids"], type_ptr=t["type_ptr"].astype(np.int32),
                    prob=t["prob"], alias=t["alias"], w_sum=t["w_sum"])

    gp32 = gp_full.astype(np.int32)
    adj_pack_u = _adj_pack_np(core["col"], core["ety"], core["eid"],
                              core["w"])
    sample_pack_u = _sample_pack_np(gp_full, gprob, galias, adj_pack_u)
    gws32 = gws.astype(np.float32)
    out = dict(
        node_type=padn(own_node_type, -1),
        node_w=padn(own_node_w),
        group_ptr=gp32,
        adj_dst=pade(core["col"], -1),
        adj_type=pade(core["ety"], -1),
        adj_w=pade(core["w"]),
        adj_w_cumsum=pade(cw, last),
        adj_eid=pade(core["eid"], -1),
        group_w_sum=gws32.reshape(n_max, ET),
        adj_prob=pade(gprob, 1.0),
        adj_alias=pade(galias),
        group_pack=np.stack([gp32[:-1], gp32[1:]], axis=1),
        adj_pack=pade(adj_pack_u, -1),
        sample_pack=pade(sample_pack_u),
        fan_pack=build_fan_pack(gp_full, core["col"], gprob, galias, gws32),
        node_alias=alias_dict(na),
        edge_alias=alias_dict(ea),
        dense_nf={k: padn(v) for k, v in dense_nf_own.items()},
        sparse_nf={k: (padn(ids, -1), padn(ln))
                   for k, (ids, ln) in sparse_nf_own.items()},
        dense_ef={k: pade(v) for k, v in dense_ef_local.items()},
        sparse_ef={k: (pade(ids, -1), pade(ln))
                   for k, (ids, ln) in sparse_ef_local.items()},
        binary_hash_nf={k: padn(v) for k, v in binary_hash_own.items()},
        eid_sorted=pade(core["eid"][eorder], np.iinfo(np.int32).max),
        eid_slot=pade(eorder),
    )
    # union fan rows over the local nodes, lanes packing (etype << 27) |
    # GLOBAL dst, under the reference's gate
    if 2 <= ET <= FANU_MAX_TYPES and meta.n_nodes < (1 << FANU_SHIFT):
        node_ptr = gp_full[::ET].astype(np.int64)
        packed = (core["ety"].astype(np.int32) << FANU_SHIFT) | core["col"]
        prob_u, alias_u = build_group_alias(node_ptr, core["w"])
        wsum_u = gws.astype(np.float32).reshape(n_max, ET).sum(axis=1)
        out.update(
            fanu_pack=build_fan_pack(node_ptr, packed, prob_u, alias_u,
                                     wsum_u),
            fanu_ptr=node_ptr.astype(np.int32),
            fanu_prob=pade(prob_u, 1.0),
            fanu_alias=pade(alias_u))
    return out


def _pad_in_fields(meta: GraphMeta, core, n_max, ie_max):
    """One shard's padded in-CSR (a copy of sharded.py:315-339)."""
    ET = meta.num_edge_types
    m = len(core["col"])

    def pade(a, fill=0):
        out = np.full((ie_max,) + a.shape[1:], fill, a.dtype)
        out[:m] = a
        return out

    gp = core["gp"].astype(np.int32)
    seg = np.repeat(np.arange(len(gp) - 1), np.diff(gp))
    gws = np.zeros(n_max * ET, np.float64)
    np.add.at(gws, seg, core["w"].astype(np.float64))
    iprob, ialias = build_group_alias(gp.astype(np.int64), core["w"])
    return dict(
        in_group_ptr=gp,
        in_adj_src=pade(core["col"].astype(np.int32), -1),
        in_adj_w=pade(core["w"].astype(np.float32)),
        in_adj_eid=pade(core["eid"].astype(np.int32), -1),
        in_group_w_sum=gws.astype(np.float32).reshape(n_max, ET),
        in_adj_prob=pade(iprob.astype(np.float32), 1.0),
        in_adj_alias=pade(ialias.astype(np.int32)),
    )


def _stack(values):
    first = values[0]
    if isinstance(first, dict):
        return {k: _stack([v[k] for v in values]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([v[i] for v in values])
                     for i in range(len(first)))
    return np.stack(values)


def assemble_sharded(meta: GraphMeta, S: int, fields_by_shard,
                     shard_node_w, shard_edge_w,
                     graph_members=None) -> ShardedGraphTensors:
    """Stack per-shard field dicts into a ShardedGraphTensors (the host
    branch of sharded.py:342-401; placement is ``take_shard``'s)."""
    missing = [s for s in range(S) if s not in fields_by_shard]
    if missing:
        raise ValueError(f"assemble_sharded needs every shard; missing "
                         f"{missing}")
    keys = fields_by_shard[0].keys()
    fields = {k: _stack([fields_by_shard[s][k] for s in range(S)])
              for k in keys}
    return ShardedGraphTensors(meta=meta, num_shards=S,
                               shard_node_w=shard_node_w,
                               shard_edge_w=shard_edge_w,
                               graph_members=graph_members, **fields)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_sharded(graph, num_shards: int) -> ShardedGraphTensors:
    """Partition a loaded ``Graph`` into stacked per-shard arrays on the
    host (a copy of sharded.py:404-485). The dense feature tables must be
    f32 or another dtype numpy holds."""
    meta = graph.meta
    S, N, ET, NT = num_shards, meta.n_nodes, meta.num_edge_types, \
        meta.num_node_types
    g = graph.tensors
    n_max = -(-N // S)
    node_type, node_w = _np(g.node_type), _np(g.node_w)
    adj_src, adj_dst, adj_type = _np(g.adj_src), _np(g.adj_dst), \
        _np(g.adj_type)
    adj_w, adj_eid = _np(g.adj_w), _np(g.adj_eid)
    shard_node_w = np.zeros((S, NT), np.float32)
    shard_edge_w = np.zeros((S, ET), np.float32)
    edge_shard = adj_src % S

    cores, owns = [], []
    e_max = 1
    for s in range(S):
        own = np.where(np.arange(N) % S == s)[0]
        esel = edge_shard == s
        core = _build_shard_core(
            meta, node_type[own], node_w[own], adj_src[esel] // S,
            adj_dst[esel], adj_type[esel], adj_w[esel], adj_eid[esel])
        cores.append(core)
        owns.append(own)
        e_max = max(e_max, core["m_local"])
        shard_node_w[s] = core["node_w_row"]
        shard_edge_w[s] = core["edge_w_row"]

    in_cores = None
    ie_max = 1
    if g.in_group_ptr is not None:
        in_cores = []
        in_shard = adj_dst % S
        for s in range(S):
            isel = in_shard == s
            (igp, icol, iw, _icum, ieid, _perm) = _convert.build_csr(
                n_max, ET, np.ascontiguousarray(adj_dst[isel] // S,
                                                np.int32),
                adj_src[isel].astype(np.int32), adj_type[isel],
                adj_w[isel], adj_eid[isel], native=False)
            in_cores.append(dict(gp=igp, col=icol, w=iw, eid=ieid))
            ie_max = max(ie_max, len(icol))

    dense_nf = {k: _np(v) for k, v in g.dense_nf.items()}
    sparse_nf = {k: (_np(a), _np(b)) for k, (a, b) in g.sparse_nf.items()}
    binary = {k: _np(v) for k, v in g.binary_hash_nf.items()}
    dense_ef = {k: _np(v) for k, v in g.dense_ef.items()}
    sparse_ef = {k: (_np(a), _np(b)) for k, (a, b) in g.sparse_ef.items()}
    fields_by_shard = {}
    for s in range(S):
        own, core = owns[s], cores[s]
        rows = core["eid"]                # global edge rows, slot order
        fields_by_shard[s] = _pad_shard_fields(
            meta, core, n_max, e_max, node_type[own], node_w[own],
            {k: v[own] for k, v in dense_nf.items()},
            {k: (a[own], b[own]) for k, (a, b) in sparse_nf.items()},
            {k: v[own] for k, v in binary.items()},
            {k: v[rows] for k, v in dense_ef.items()},
            {k: (a[rows], b[rows]) for k, (a, b) in sparse_ef.items()})
        if in_cores is not None:
            fields_by_shard[s].update(_pad_in_fields(
                meta, in_cores[s], n_max, ie_max))
    gm = g.graph_members
    return assemble_sharded(meta, S, fields_by_shard, shard_node_w,
                            shard_edge_w,
                            graph_members=None if gm is None else _np(gm))


# ---------------------------------------------------------------------------
# one shard on a rank's device
# ---------------------------------------------------------------------------

def _flat_shard(sg: ShardedGraphTensors, s: int) -> Dict[str, np.ndarray]:
    """Shard ``s``'s arrays under flat names (``node_alias.ids``,
    ``dense_nf:feature``, ``sparse_nf:tags:0``); the replicated fields
    whole."""
    out = {}
    for f in dataclasses.fields(sg):
        v = getattr(sg, f.name)
        if f.name in ("meta", "num_shards") or v is None:
            continue
        if f.name in REPLICATED:
            out[f.name] = v
        elif f.name in ("node_alias", "edge_alias"):
            out.update({f"{f.name}.{k}": v[k][s] for k in _ALIAS_KEYS})
        elif isinstance(v, dict):
            for name, x in v.items():
                if isinstance(x, tuple):
                    out.update({f"{f.name}:{name}:{i}": x[i][s]
                                for i in range(len(x))})
                else:
                    out[f"{f.name}:{name}"] = x[s]
        else:
            out[f.name] = v[s]
    return out


def _unflat(a: Dict[str, np.ndarray], field: str) -> dict:
    out: Dict[str, object] = {}
    for key, v in a.items():
        if not key.startswith(field + ":"):
            continue
        parts = key.split(":")
        if len(parts) == 2:
            out[parts[1]] = v
        else:
            out.setdefault(parts[1], {})[int(parts[2])] = v
    return {k: (tuple(v[i] for i in sorted(v)) if isinstance(v, dict)
                else v) for k, v in out.items()}


@dataclasses.dataclass
class ShardView:
    """One shard on one rank's device, with its graph group.

    ``local`` is the shard as a ``GraphTensors`` of local rows (the CSR,
    the packs, the alias tables, the features; neighbor ids global),
    which the one-device verbs read; attributes that the view lacks are
    read from it (``view.fan_pack``, ``view.device``, ``view.meta``).
    ``mesh`` is the rank's ``parallel.mesh.Mesh`` (None for a view that
    runs no collective)."""

    meta: GraphMeta
    num_shards: int
    shard: int
    local: GraphTensors
    eid_sorted: torch.Tensor
    eid_slot: torch.Tensor
    shard_node_w: torch.Tensor
    shard_edge_w: torch.Tensor
    mesh: object = None

    def __getattr__(self, name):
        if name == "local":          # not set yet (copying, unpickling)
            raise AttributeError(name)
        return getattr(self.local, name)

    @property
    def my_shard(self) -> int:
        return self.shard

    @property
    def group(self):
        if self.mesh is None:
            raise ValueError("this ShardView has no mesh: pass one to "
                             "take_shard/load_shard to run the verbs")
        return self.mesh.graph_group

    @property
    def n_nodes(self) -> int:
        """The local padded row count (predicate masks are per shard)."""
        return self.local.node_type.shape[0]


def _view(meta: GraphMeta, S: int, s: int, a: Dict[str, np.ndarray],
          device, mesh) -> ShardView:
    dev = torch.device(device)
    ET = meta.num_edge_types

    def put(x):
        # a copy on every device: a view writes its packs in place
        # (refresh_fan_pack_sharded), never the host store's arrays
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, copy=True)

    def alias(name):
        w_sum = a[f"{name}.w_sum"]
        return AliasTables(cdf=put(xla_cumsum(w_sum)), **{
            k: put(a[f"{name}.{k}"]) for k in _ALIAS_KEYS})

    gp = a["group_ptr"]
    adj_dst = a["adj_dst"]
    # each slot's global source: local row (group // ET) times S plus s
    row = np.searchsorted(gp, np.arange(len(adj_dst)), side="right") - 1
    adj_src = np.where(adj_dst >= 0, (row // ET) * S + s, -1).astype(
        np.int32)
    opt = {k: put(a[k]) for k in (
        "group_pack", "adj_pack", "sample_pack", "fan_pack", "fanu_pack",
        "fanu_ptr", "fanu_prob", "fanu_alias", "in_group_ptr", "in_adj_src",
        "in_adj_w", "in_adj_eid", "in_group_w_sum", "in_adj_prob",
        "in_adj_alias", "graph_members") if k in a}
    if "fan_pack" in a:
        opt["fan_over_rows"] = put(
            np.nonzero(np.diff(gp) > FAN_D)[0].astype(np.int32))
    if "fanu_pack" in a:
        opt["fanu_over_rows"] = put(
            np.nonzero(np.diff(a["fanu_ptr"]) > FAN_D)[0].astype(np.int32))
        opt["fanu_dst"] = put((a["adj_type"] << FANU_SHIFT)
                              | np.maximum(adj_dst, 0))
    local = GraphTensors(
        meta=meta, node_type=put(a["node_type"]), node_w=put(a["node_w"]),
        group_ptr=put(gp), adj_src=put(adj_src), adj_dst=put(adj_dst),
        adj_type=put(a["adj_type"]), adj_w=put(a["adj_w"]),
        adj_eid=put(a["adj_eid"]), adj_prob=put(a["adj_prob"]),
        adj_alias=put(a["adj_alias"]), group_w_sum=put(a["group_w_sum"]),
        dense_nf={k: put(v) for k, v in _unflat(a, "dense_nf").items()},
        sparse_nf={k: tuple(put(x) for x in v)
                   for k, v in _unflat(a, "sparse_nf").items()},
        dense_ef={k: put(v) for k, v in _unflat(a, "dense_ef").items()},
        sparse_ef={k: tuple(put(x) for x in v)
                   for k, v in _unflat(a, "sparse_ef").items()},
        binary_hash_nf={k: put(v)
                        for k, v in _unflat(a, "binary_hash_nf").items()},
        node_alias=alias("node_alias"), edge_alias=alias("edge_alias"),
        **opt)
    return ShardView(meta=meta, num_shards=S, shard=s, local=local,
                     eid_sorted=put(a["eid_sorted"]),
                     eid_slot=put(a["eid_slot"]),
                     shard_node_w=put(a["shard_node_w"]),
                     shard_edge_w=put(a["shard_edge_w"]), mesh=mesh)


def take_shard(sg: ShardedGraphTensors, s: int, device,
               mesh=None) -> ShardView:
    """Shard ``s`` of ``sg`` on ``device`` as a ShardView (the
    reference's ``shard_specs`` + ``to_view``): one rank's part."""
    return _view(sg.meta, sg.num_shards, s, _flat_shard(sg, s), device,
                 mesh)


def write_shards(sg: ShardedGraphTensors, path: str) -> None:
    """One ``shard_<s>.npz`` a shard under ``path`` (the replicated
    tables in each), for ranks that load only their own."""
    os.makedirs(path, exist_ok=True)
    for s in range(sg.num_shards):
        arrays = _flat_shard(sg, s)
        arrays["_meta"] = np.frombuffer(json.dumps(
            {"meta": sg.meta.to_json(), "num_shards": sg.num_shards}
        ).encode(), np.uint8)
        np.savez(os.path.join(path, f"shard_{s}.npz"), **arrays)


def load_shard(path: str, s: int, device, mesh=None) -> ShardView:
    """Shard ``s`` from ``write_shards``'s files, onto ``device``."""
    with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
        a = {k: z[k] for k in z.files}
    info = json.loads(a.pop("_meta").tobytes().decode())
    return _view(GraphMeta.from_json(info["meta"]), info["num_shards"], s,
                 a, device, mesh)


# ---------------------------------------------------------------------------
# routing (sharded.py:571-640, :745-863)
# ---------------------------------------------------------------------------

def _spread(view: ShardView, nodes: torch.Tensor) -> torch.Tensor:
    """Every member's query ids, [S*b, ...] in member order."""
    g = comms.all_gather(nodes, view.group)
    return g.reshape((-1,) + tuple(nodes.shape[1:]))


def owner_rows(view: ShardView, table: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` [...] of a table split over the graph axis (row r on
    shard r % S at local row r // S; ``table`` is this rank's block):
    every member's ids are gathered, each owner takes its rows (ids
    past the table clamp to its last local row) and one tiled all_to_all
    sends them back, summed over owners; rows of ids < 0 are 0. The
    owner exchange of layers.py:108-124 and scalable.py:40-56, with
    autograd through the collectives: the gradient of a block's row is
    the sum of its graph group's contributions."""
    S, n_local, d = view.num_shards, table.shape[0], table.shape[-1]
    flat = ids.reshape(-1).to(torch.int32)
    b = flat.shape[0]
    alln = _spread(view, flat)
    owned = (alln >= 0) & (alln % S == view.my_shard)
    rows = (torch.where(owned, alln, 0) // S).clamp(0, n_local - 1).long()
    v = torch.where(owned[:, None], table[rows], 0.0)
    out = comms.all_to_all(v, view.group).reshape(S, b, d).sum(0)
    out = torch.where((flat >= 0)[:, None], out, 0.0)
    return out.reshape(tuple(ids.shape) + (d,))


def _owner_to_mine(view: ShardView, vals: torch.Tensor,
                   b: int) -> torch.Tensor:
    """[S*b, ...] per-owner partial answers (0 where not owned) -> this
    member's [b, ...] rows: one tiled all_to_all, then the sum over
    owners (each row has one)."""
    ex = comms.all_to_all(vals, view.group)
    return ex.reshape((view.num_shards, b) + tuple(vals.shape[1:])).sum(0)


def _combine_ids(view, owned, local_ids, default=-1):
    """Merge per-shard id answers into one array on every member."""
    z = torch.where(owned, local_ids - default, 0)
    return comms.psum(z, view.group) + default


def _route_ids(view, owned, local_ids, b, default=-1):
    z = torch.where(owned, local_ids - default, 0)
    return _owner_to_mine(view, z, b) + default


def _route_vals(view, owned, vals, b):
    return _owner_to_mine(view, torch.where(owned, vals, 0), b)


def _own_rows(view: ShardView, nodes: torch.Tensor):
    S = view.num_shards
    owned = (nodes >= 0) & (nodes % S == view.my_shard)
    rows = (nodes // S).clamp(0, view.n_nodes - 1)
    return owned, rows


def _local_rows(view: ShardView, nodes: torch.Tensor) -> torch.Tensor:
    """int32 local rows of the ids this shard owns, -1 elsewhere: the
    one-device verbs then answer exactly the owned rows."""
    owned, rows = _own_rows(view, nodes)
    return torch.where(owned, rows, -1).to(torch.int32)


OWNER_COMPUTE_SLACK = 4
OWNER_ROUTE_SLACK = 2         # request-table slack over the b/S mean
OWNER_COMPUTE_MIN = 16
_owner_compute_force = None   # tests: True/False override


def set_owner_compute(flag):
    """Force the request-routed path (True), the spread path (False), or
    the automatic choice (None)."""
    global _owner_compute_force
    _owner_compute_force = flag


def _owner_cap(b, S, sampler: bool = False):
    """A positive int where the verb takes the request-routed path, None
    for the spread path (sharded.py:756-776): feature-like verbs route
    from 2 shards and ``b >= 16 S``; samplers only past 4 shards, where
    duplicate ids in one member's batch share a draw set."""
    if _owner_compute_force is False:
        return None
    cap = min(OWNER_COMPUTE_SLACK * b, S * b)
    if _owner_compute_force:
        return cap
    if b < OWNER_COMPUTE_MIN * S:
        return None
    if S < 2 or (sampler and S <= OWNER_COMPUTE_SLACK):
        return None
    return cap


def _cap_out(view: ShardView, b: int) -> int:
    """Rows of the request table per owner (sharded.py:815)."""
    S = view.num_shards
    return max(1, min(b, -(-OWNER_ROUTE_SLACK * b // S), view.n_nodes))


def sampler_rows(view: ShardView, b: int) -> int:
    """Rows a sharded neighbor draw over ``b`` query rows answers on
    this owner, the leading dim of its uniforms: S*b on the spread path,
    S*cap_out on the request-routed one."""
    S = view.num_shards
    if _owner_cap(b, S, sampler=True) is not None:
        return S * _cap_out(view, b)
    return S * b


def _request_route(view: ShardView, ids: torch.Tensor, answer_fn, fills):
    """Owner-compute with compact request routing (sharded.py:779-863),
    as the reference writes it: stable argsorts, searchsorted and
    gathers, no scatter. Sorts the member's ids by (owner, id), ranks the
    distinct ids within each owner, sends each owner its [cap_out] table,
    lets ``answer_fn(flat_ids [S*cap_out])`` answer and sends the answers
    back; each row reads its answer at (owner, rank). Rows whose rank
    passes cap_out get ``fills``. Returns (outputs, served [b])."""
    S = view.num_shards
    ids = ids.to(torch.int32)
    b = ids.shape[0]
    dev = ids.device
    cap_out = _cap_out(view, b)
    valid = ids >= 0
    owner = torch.where(valid, ids % S, S).to(torch.int64)
    order1 = torch.argsort(torch.where(valid, ids, IMAX), stable=True)
    order = order1[torch.argsort(owner[order1], stable=True)]
    inv = torch.argsort(order)
    own_s, ids_s = owner[order], ids[order]
    ok_s = ids_s >= 0
    first = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = ok_s & torch.cat(
        [first, (own_s[1:] != own_s[:-1]) | (ids_s[1:] != ids_s[:-1])])
    grank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    pos0 = torch.searchsorted(own_s, torch.arange(S, device=dev))
    base = grank[pos0.clamp(0, b - 1)]
    crank = grank - base[own_s.clamp(0, S - 1)]
    imax = torch.iinfo(torch.int64).max
    kq = torch.where(ok_s, own_s * (b + 1) + crank.clamp(0, b), imax)
    want = (torch.arange(S, device=dev)[:, None] * (b + 1)
            + torch.arange(cap_out, device=dev)[None, :]).reshape(-1)
    p = torch.searchsorted(kq, want).clamp(0, b - 1)
    hit = kq[p] == want
    req = torch.where(hit, ids_s[p], -1)
    reqs = comms.all_to_all(req, view.group)
    answers = answer_fn(reqs)
    c_i = crank[inv]
    served = valid & (c_i < cap_out)
    o_i = owner.clamp(0, S - 1)
    at = o_i * cap_out + c_i.clamp(0, cap_out - 1)
    outs = []
    for a, fill in zip(answers, fills):
        back = comms.all_to_all(a, view.group)
        got = back[at]
        ok = served.reshape((b,) + (1,) * (got.dim() - 1))
        outs.append(torch.where(ok, got, fill))
    return tuple(outs), served


# ---------------------------------------------------------------------------
# neighbor draws (sharded.py:642-742, :866-1008, :1429-1466)
# ---------------------------------------------------------------------------

def sample_neighbor_sharded(view: ShardView, nodes, ets, uniforms,
                            default_id: int = -1):
    """Payload draws (nbr, w, type, eid) [b, count] through the owners,
    from the owner's ``draw_sample_uniforms`` of ``sampler_rows(view,
    b)`` rows: the one-device ``select_sampled_neighbors`` over the
    shard (its sample-pack branch and its group alias branch)."""
    nodes = nodes.to(torch.int32)
    b = nodes.shape[0]
    _check_rows(view, uniforms, sampler_rows(view, b))

    def local(flat_ids):
        return sampling.select_sampled_neighbors(
            view.local, _local_rows(view, flat_ids), ets, *uniforms,
            default_id=default_id)

    if _owner_cap(b, view.num_shards, sampler=True) is not None:
        outs, _ = _request_route(view, nodes, local, fills=(
            default_id, 0.0, -1, -1))
        return outs
    spread = _spread(view, nodes)
    owned = _own_rows(view, spread)[0][:, None]
    nbr, w, ty, eid = local(spread)
    return (_route_ids(view, owned, nbr, b, default_id),
            _route_vals(view, owned, w, b),
            _route_ids(view, owned, ty, b, -1),
            _route_ids(view, owned, eid, b, -1))


def _check_rows(view, uniforms, rows):
    for u in uniforms:
        if u.shape[0] != rows:
            raise ValueError(
                f"a sharded draw reads the owner's uniforms of {rows} rows "
                f"(sampler_rows), got {tuple(u.shape)}")


def sample_neighbor_fast_sharded(view: ShardView, nodes, ets, uniforms,
                                 default_id: int = -1,
                                 return_types: bool = False):
    """Ids-only draws over each owner's fan rows (sharded.py:866-1008),
    from the owner's ``draw_neighbor_uniforms`` of ``sampler_rows(view,
    b)`` rows: the one-device hop (``select_neighbors``: the K=1 fan row
    through ``fan_draw``, the union rows through ``fan_draw``'s decode,
    one fan row per type for K>1) over the shard. Returns (ids, valid[,
    types]) [b, count]."""
    nodes = nodes.to(torch.int32)
    b = nodes.shape[0]
    _check_rows(view, uniforms, sampler_rows(view, b))

    def local(flat_ids):
        return sampling.select_neighbors(
            view.local, _local_rows(view, flat_ids), ets, uniforms,
            default_id, return_types=return_types)

    if _owner_cap(b, view.num_shards, sampler=True) is not None:
        def answer(flat_ids):
            out = local(flat_ids)
            return (out[0], out[1].to(torch.int8)) + tuple(out[2:])

        fills = (default_id, 0) + ((-1,) if return_types else ())
        outs, served = _request_route(view, nodes, answer, fills)
        valid = (outs[1] > 0) & served[:, None]
        ids = torch.where(valid, outs[0], default_id)
        if return_types:
            return ids, valid, torch.where(valid, outs[2], -1)
        return ids, valid
    spread = _spread(view, nodes)
    owned = _own_rows(view, spread)[0][:, None]
    out = local(spread)
    ok_all = out[1]
    ids = _route_ids(view, owned, out[0], b, default_id)
    valid = _route_vals(view, owned, ok_all.to(torch.int32), b) > 0
    ids = torch.where(valid, ids, default_id)
    if return_types:
        ty = _route_ids(view, ok_all, out[2], b, -1)
        return ids, valid, torch.where(valid, ty, -1)
    return ids, valid


def sample_in_neighbor_sharded(view: ShardView, nodes, ets, uniforms,
                               default_id: int = -1):
    """Weighted in-neighbor draws: the dst shard owns each node's
    in-groups (sharded.py:1429-1466), always on the spread path, from the
    owner's ``draw_sample_uniforms`` of S*b rows."""
    nodes = nodes.to(torch.int32)
    b = nodes.shape[0]
    _check_rows(view, uniforms, view.num_shards * b)
    spread = _spread(view, nodes)
    owned = _own_rows(view, spread)[0][:, None]
    nbr, w, ty, eid = sampling.select_in_neighbors(
        view.local, _local_rows(view, spread), ets, *uniforms,
        default_id=default_id)
    return (_route_ids(view, owned, nbr, b, default_id),
            _route_vals(view, owned, w, b),
            _route_ids(view, owned, ty, b, -1),
            _route_ids(view, owned, eid, b, -1))


# ---------------------------------------------------------------------------
# features and lookups (sharded.py:1011-1100, :1350-1395)
# ---------------------------------------------------------------------------

def _owned_lookup(view: ShardView, ids: torch.Tensor, answer_fn, fills,
                  plus_one):
    """A deterministic per-owner answer for ids (any shape): request-routed
    from ``b >= 16 S`` (``_owner_cap``), else spread. ``answer_fn(local
    rows [R]) -> tuple`` answers the rows this shard owns (-1 elsewhere);
    on the spread path the integer answers named in ``plus_one`` ride as
    value + 1 (0 where not owned), as the reference routes them."""
    shape_in = tuple(ids.shape)
    flat = ids.reshape(-1).to(torch.int32)
    b = flat.shape[0]
    if _owner_cap(b, view.num_shards) is not None:
        outs, _ = _request_route(
            view, flat, lambda q: answer_fn(_local_rows(view, q)), fills)
    else:
        spread = _spread(view, flat)
        owned, _ = _own_rows(view, spread)
        outs = []
        for a, p1 in zip(answer_fn(_local_rows(view, spread)), plus_one):
            ok = owned.reshape((-1,) + (1,) * (a.dim() - 1))
            if p1:
                outs.append(_owner_to_mine(
                    view, torch.where(ok, a + 1, 0), b) - 1)
            else:
                outs.append(_owner_to_mine(view, torch.where(ok, a, 0), b))
    return [o.reshape(shape_in + tuple(o.shape[1:])) for o in outs]


def get_dense_feature_sharded(view: ShardView, nodes, names):
    """Owner-served dense rows: each owner's answer is ``gather_rows``
    over its local rows (-1 rows are the zero rows the reference
    writes)."""
    return _owned_lookup(
        view, nodes,
        lambda rows: tuple(gather_rows(view.local.dense_nf[n], rows)
                           for n in names),
        (0.0,) * len(names), (False,) * len(names))


def _take_ids(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Integer rows of ``table`` at local rows, -1 rows where rows < 0."""
    r = rows.long()
    got = table[r.clamp(0, table.shape[0] - 1)]
    ok = (r >= 0).reshape((-1,) + (1,) * (got.dim() - 1))
    return torch.where(ok, got, -1)


def get_sparse_feature_sharded(view: ShardView, nodes, names):
    outs = _owned_lookup(
        view, nodes,
        lambda rows: tuple(_take_ids(view.local.sparse_nf[n][0], rows)
                           for n in names),
        (-1,) * len(names), (True,) * len(names))
    return [(ids, ids >= 0) for ids in outs]


def get_node_type_sharded(view: ShardView, nodes):
    (ty,) = _owned_lookup(
        view, nodes, lambda rows: (_take_ids(view.local.node_type, rows),),
        (-1,), (True,))
    return ty


def _eid_lookup_local(view: ShardView, eids: torch.Tensor):
    """(found, local slot) of global edge rows on this shard."""
    pos = torch.searchsorted(view.eid_sorted, eids.to(torch.int32))
    pos = pos.clamp(0, view.eid_sorted.shape[0] - 1)
    found = (view.eid_sorted[pos] == eids) & (eids >= 0)
    return found, view.eid_slot[pos]


def get_edge_feature_sharded(view: ShardView, eids, names, kind):
    """Edge features by global edge row from the edge's owner, spread
    (sharded.py:1358-1381); kind "dense" (through ``gather_rows``) or
    "sparse"."""
    shape_in = tuple(eids.shape)
    flat = eids.reshape(-1).to(torch.int32)
    b = flat.shape[0]
    found, slot = _eid_lookup_local(view, _spread(view, flat))
    rows = torch.where(found, slot, -1).to(torch.int32)
    out = []
    for n in names:
        if kind == "dense":
            v = _owner_to_mine(view, gather_rows(view.local.dense_ef[n],
                                                 rows), b)
            out.append(v.reshape(shape_in + tuple(v.shape[1:])))
        else:
            tab = view.local.sparse_ef[n][0]
            ids = torch.where(found[:, None], _take_ids(tab, rows) + 1, 0)
            ids = _owner_to_mine(view, ids, b) - 1
            ids = ids.reshape(shape_in + tuple(ids.shape[1:]))
            out.append((ids, ids >= 0))
    return out


def get_edge_type_sharded(view: ShardView, eids):
    shape_in = tuple(eids.shape)
    flat = eids.reshape(-1).to(torch.int32)
    found, slot = _eid_lookup_local(view, _spread(view, flat))
    ty = torch.where(found, view.local.adj_type[slot.long()] + 1, 0)
    return (_owner_to_mine(view, ty, flat.shape[0]) - 1).reshape(shape_in)


# ---------------------------------------------------------------------------
# cooperative draws (sharded.py:1102-1192, :1243-1275, :1397-1427)
# ---------------------------------------------------------------------------

def _sync(view: ShardView, u: torch.Tensor) -> torch.Tensor:
    """Member 0's ``u`` on every member (the reference's ``_sync_key``):
    the shard choice must agree across the group."""
    return comms.all_gather(u, view.group)[0]


def _sum_rows(w: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0, left to right (XLA's loop over a short axis)."""
    out = w[0]
    for i in range(1, w.shape[0]):
        out = out + w[i]
    return out


def _choose_shards(cdf_s: torch.Tensor, us: torch.Tensor, S: int):
    """Each draw's shard from ``us`` [...], in proportion to its row of
    per-shard weights' running sums ``cdf_s`` [..., S]."""
    rs = us * cdf_s[..., -1]
    return (rs[..., None] >= cdf_s).sum(-1).clamp_max(S - 1).to(torch.int32)


def _typed_draw(at: AliasTables, t, u1, u2):
    """Each draw's member of type ``t`` from this shard's alias tables
    ``at`` (a local row or CSR slot), -1 where the type is empty."""
    lo = at.type_ptr[t.long()]
    size = at.type_ptr[t.long() + 1] - lo
    pos = alias_select(at.prob, at.alias, lo, size, u1, u2)
    return torch.where(pos >= 0, at.ids[pos.clamp_min(0).long()], -1)


def _pick_type(w_per_shard, type_, ut, count):
    """The drawn type of each of ``count`` draws: ``type_`` or, for -1,
    in proportion to the graph's per-type weight sums."""
    if type_ != -1:
        return torch.full((count,), type_, dtype=torch.int64,
                          device=ut.device)
    w_type = _sum_rows(w_per_shard)
    cdf_t = sampling.row_cdf(w_type[None])[0]
    t = torch.searchsorted(cdf_t, ut * cdf_t[-1], right=True)
    return t.clamp_max(w_type.shape[0] - 1)


def select_nodes_sharded(view: ShardView, node_type, ut, us, u1, u2):
    """Proportional cross-shard root draws (sharded.py:1116-1149): member
    0's ``ut`` (type pick) and ``us`` (shard choice), this shard's
    ``u1``, ``u2`` for its alias draw; int32 [count] on every member."""
    S, my = view.num_shards, view.my_shard
    if isinstance(node_type, str):
        node_type = view.meta.node_type_id(node_type)
    ut, us = _sync(view, ut), _sync(view, us)
    count = us.shape[0]
    t = _pick_type(view.shard_node_w, node_type, ut, count)
    cdf_s = sampling.row_cdf(view.shard_node_w[:, t].T)
    choice = _choose_shards(cdf_s, us, S)
    local = _typed_draw(view.local.node_alias, t, u1, u2)
    gid = torch.where(local >= 0, local * S + my, -1)
    return _combine_ids(view, choice == my, gid, -1)


def select_edges_sharded(view: ShardView, edge_type, ut, us, u1, u2):
    """Proportional cross-shard edge draws (sharded.py:1152-1191):
    (src, dst, type, eid), each int32 [count] on every member."""
    S, my = view.num_shards, view.my_shard
    ET = view.meta.num_edge_types
    if isinstance(edge_type, str):
        edge_type = view.meta.edge_type_id(edge_type)
    ut, us = _sync(view, ut), _sync(view, us)
    count = us.shape[0]
    t = _pick_type(view.shard_edge_w, edge_type, ut, count)
    cdf_s = sampling.row_cdf(view.shard_edge_w[:, t].T)
    choice = _choose_shards(cdf_s, us, S)
    loc = view.local
    slot = _typed_draw(loc.edge_alias, t, u1, u2)
    sl = slot.long().clamp(0, loc.adj_dst.shape[0] - 1)
    row = torch.searchsorted(loc.group_ptr, sl.to(loc.group_ptr.dtype),
                             right=True) - 1
    ok = slot >= 0
    src = torch.where(ok, (row // ET) * S + my, -1).to(torch.int32)
    mine = choice == my
    return tuple(_combine_ids(view, mine, x, -1) for x in (
        src, torch.where(ok, loc.adj_dst[sl], -1),
        torch.where(ok, loc.adj_type[sl], -1),
        torch.where(ok, loc.adj_eid[sl], -1)))


def select_nodes_with_src_sharded(view: ShardView, src, us, u1, u2):
    """Same-type negatives under the mesh (sharded.py:1243-1274): each
    src's type from its owner, member 0's ``us`` [S*b, count] for the
    shard choice, this shard's ``u1``, ``u2`` [S*b, count] for its
    typed alias draw; int32 [b, count]."""
    S, my = view.num_shards, view.my_shard
    src = src.reshape(-1).to(torch.int32)
    b = src.shape[0]
    _check_rows(view, (us, u1, u2), S * b)
    us = _sync(view, us)
    alln = _spread(view, src)
    owned, rows = _own_rows(view, alln)
    t = _combine_ids(view, owned, torch.where(
        owned, view.local.node_type[rows.long()], -1), -1)
    ts = t.clamp_min(0).long()
    cdf_s = sampling.row_cdf(view.shard_node_w[:, ts].T)        # [B, S]
    choice = _choose_shards(cdf_s[:, None, :].expand(
        -1, us.shape[1], -1), us, S)
    na = view.local.node_alias
    pos = alias_select(na.prob, na.alias, na.type_ptr[ts][:, None],
                       (na.type_ptr[ts + 1] - na.type_ptr[ts])[:, None],
                       u1, u2)
    local = torch.where(pos >= 0, na.ids[pos.clamp_min(0).long()], -1)
    gid = torch.where(local >= 0, local * S + my, -1)
    mine = (choice == my) & (t >= 0)[:, None]
    return _route_ids(view, mine, gid, b, -1)


def select_node_with_condition_sharded(view: ShardView, dnf, node_type,
                                       us, u):
    """Conditional draws under the mesh (sharded.py:1397-1426): the local
    DNF mask and masked weights, a shard chosen by member 0's ``us`` in
    proportion to the gathered totals, this shard's ``u`` [count] for
    its masked draw; int32 [count] on every member."""
    S, my = view.num_shards, view.my_shard
    us = _sync(view, us)
    loc = view.local
    mask = index_ops.dnf_mask(loc, dnf)
    if node_type != -1:
        if isinstance(node_type, str):
            node_type = view.meta.node_type_id(node_type)
        mask = mask & (loc.node_type == node_type)
    mask = mask & (loc.node_type >= 0)
    wloc = loc.node_w * mask
    tots = comms.all_gather(wloc.sum(), view.group)               # [S]
    cdf = sampling.row_cdf(tots[None])[0]
    choice = ((us * cdf[-1])[:, None] >= cdf[None, :]).sum(-1).clamp_max(
        S - 1)
    local = index_ops.select_masked(wloc, u)
    gid = torch.where(local >= 0, local * S + my, -1)
    return _combine_ids(view, (choice == my) & (cdf[-1] > 0), gid, -1)


def query_index_ids_sharded(view: ShardView, dnf, cap: int):
    """Matching global ids across shards, ascending, padded to ``cap``
    with -1 (sharded.py:1514-1527)."""
    loc = view.local
    mask = index_ops.dnf_mask(loc, dnf) & (loc.node_type >= 0)
    gids = torch.arange(mask.shape[0], dtype=torch.int32,
                        device=mask.device) * view.num_shards + view.my_shard
    allv = comms.all_gather(torch.where(mask, gids, IMAX),
                            view.group).reshape(-1)
    top = torch.sort(allv)[0][:cap]
    ids = torch.where(top < IMAX, top, -1)
    return ids, ids >= 0


# ---------------------------------------------------------------------------
# whole neighborhoods (sharded.py:1194-1241, :1277-1348, :1468-1512)
# ---------------------------------------------------------------------------

def _route_neighborhood(view, b, nbr, w, ty, eid, ok, default_id,
                        sorted_by_id):
    nbr = _route_ids(view, ok, nbr, b, default_id)
    w = _route_vals(view, ok, w, b)
    ty = _route_ids(view, ok, ty, b, -1)
    eid = _route_ids(view, ok, eid, b, -1)
    okg = _owner_to_mine(view, ok.to(torch.int32), b) > 0
    if sorted_by_id:
        key = torch.where(okg, nbr, IMAX)
        order = torch.argsort(key, dim=1, stable=True)
        nbr, w, ty, eid, okg = (torch.gather(x, 1, order)
                                for x in (nbr, w, ty, eid, okg))
    return nbr, w, ty, eid, okg


def get_full_neighbor_sharded(view: ShardView, nodes, ets, cap: int,
                              default_id: int = -1,
                              sorted_by_id: bool = False, offset: int = 0):
    """Padded full neighborhoods from the owners' CSR, spread."""
    nodes = nodes.to(torch.int32)
    spread = _spread(view, nodes)
    out = sampling.get_full_neighbor(view.local, _local_rows(view, spread),
                                     ets, cap, default_id, offset=offset)
    return _route_neighborhood(view, nodes.shape[0], *out, default_id,
                               sorted_by_id)


def get_full_in_neighbor_sharded(view: ShardView, nodes, ets, cap: int,
                                 default_id: int = -1,
                                 sorted_by_id: bool = False):
    """Padded full in-neighborhoods from the dst owners' in-CSR."""
    nodes = nodes.to(torch.int32)
    spread = _spread(view, nodes)
    out = sampling.get_full_in_neighbor(
        view.local, _local_rows(view, spread), ets, cap, default_id)
    return _route_neighborhood(view, nodes.shape[0], *out, default_id,
                               sorted_by_id)


def sparse_get_adj_sharded(view: ShardView, nodes, nb_nodes, ets):
    """Bipartite adjacency under the mesh (sharded.py:1277-1315): each
    owner answers the membership tests of its rows against the querying
    member's nb list, by the reference's 32 halving steps."""
    nodes = nodes.reshape(-1).to(torch.int32)
    nb = nb_nodes.reshape(-1).to(torch.int32)
    b, m = nodes.shape[0], nb.shape[0]
    S = view.num_shards
    loc = view.local
    alln = _spread(view, nodes)
    allnb = _spread(view, nb).reshape(S, m)
    owned, rows = _own_rows(view, alln)
    B, E = alln.shape[0], loc.adj_dst.shape[0]
    tgt = allnb[:, None, :].expand(S, b, m).reshape(B, m)
    conn = torch.zeros((B, m), dtype=torch.bool, device=nodes.device)
    w = torch.zeros((B, m), dtype=torch.float32, device=nodes.device)
    for t in ets:
        lo, hi = sampling._group_bounds(loc, rows, torch.full_like(rows, t))
        h_b = hi.long()[:, None].expand(B, m)
        l, h = lo.long()[:, None].expand(B, m), h_b
        for _ in range(sampling.SEARCH_STEPS):
            mid = (l + h) // 2
            right = loc.adj_dst[mid.clamp(0, E - 1)] < tgt
            l, h = torch.where(right, mid + 1, l), torch.where(right, h, mid)
        slot = l.clamp(0, E - 1)
        hit = ((l < h_b) & (loc.adj_dst[slot] == tgt)
               & (alln >= 0)[:, None] & (tgt >= 0) & owned[:, None])
        conn = conn | hit
        w = torch.where(hit, loc.adj_w[slot], w)
    conn_g = _owner_to_mine(view, conn.to(torch.int32), b) > 0
    w_g = _owner_to_mine(view, w, b)
    return conn_g, torch.where(conn_g, w_g, 0.0)


def is_neighbor_sharded(view: ShardView, src, ets, cand):
    """Membership of ``cand`` in N_ets(``src``) from src's owner
    (sharded.py:1318-1347)."""
    shape = tuple(src.shape)
    src = src.reshape(-1).to(torch.int32)
    cand = cand.reshape(-1).to(torch.int32)
    alls, allc = _spread(view, src), _spread(view, cand)
    owned, rows = _own_rows(view, alls)
    found = walk_ops._is_neighbor(view.local, rows.to(torch.int32), ets,
                                  allc)
    found = found & owned & (alls >= 0) & (allc >= 0)
    return (_owner_to_mine(view, found.to(torch.int32), src.shape[0])
            > 0).reshape(shape)


# ---------------------------------------------------------------------------
# reservoir redraw (sharded.py:1530-1578)
# ---------------------------------------------------------------------------

def fold_seed(seed: int, index: int) -> int:
    """A seed for ``index``'s stream of ``seed``: the reference's
    ``fold_in``, as a 63-bit mix."""
    x = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9 + 1)
    x &= (1 << 64) - 1
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def refresh_fan_pack_sharded(view: ShardView, seed: int) -> ShardView:
    """Redraw this shard's fan and union reservoir rows in place from a
    generator seeded with ``seed`` folded with the graph index, so that
    the data-axis replicas of a shard draw the same rows."""
    gen = torch.Generator(device=view.device)
    gen.manual_seed(fold_seed(seed, view.my_shard))
    sampling.refresh_fan_pack(view.local, gen)
    return view
