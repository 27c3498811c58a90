"""Device-resident graph store: the fields the sampled paths read.

Counterpart of euler_tpu/graph/store.py (``GraphTensors``, ``Graph``,
``load_graph``). It reads the same converted directories (``meta.json``
plus ``part_*.npz``) and builds, with the same host code, the grouped CSR,
the per-group alias tables, the ``fan`` and ``fanu`` packs that neighbor
sampling reads, and the per-node-type alias tables that the root draw
reads. Only
the fields the sampled training and inference paths need live on the
device; external ids and binary features stay on the host.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph import convert as _convert
from euler_tpu_torch.graph.meta import DENSE, GraphMeta
from euler_tpu_torch.ops.alias import (FAN_D, FANU_MAX_TYPES, FANU_SHIFT,
                                       build_fan_pack, build_group_alias,
                                       build_typed_alias_tables)

#: packs the port builds by default; the reference's "group", "adj",
#: "sample" and "ell" packs wait for the slices whose verbs read them
PACKS = ("fan",)
#: packs the port can build: "fanu" (union fan rows, multi-type draws)
#: only on request, as the reference leaves it out of its ALL_PACKS
KNOWN_PACKS = ("fan", "fanu")


@dataclasses.dataclass
class AliasTables:
    """Per-type alias tables over a typed population (ops/alias.py
    ``build_typed_alias_tables``), on one device."""

    ids: torch.Tensor       # int32 [n] population sorted by type
    type_ptr: torch.Tensor  # int32 [T+1]
    prob: torch.Tensor      # f32   [n]
    alias: torch.Tensor     # int32 [n] (within-type slots)
    w_sum: torch.Tensor     # f32   [T]

    def to(self, device) -> "AliasTables":
        return AliasTables(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class GraphTensors:
    """The device graph. Every array field is a tensor on one device."""

    meta: GraphMeta
    group_ptr: torch.Tensor      # int32 [N*ET + 1]
    adj_dst: torch.Tensor        # int32 [E]
    adj_prob: torch.Tensor       # f32   [E] per-group alias keep-prob
    adj_alias: torch.Tensor      # int32 [E] within-group alias slots
    group_w_sum: torch.Tensor    # f32   [N, ET]
    dense_nf: Dict[str, torch.Tensor]
    node_alias: AliasTables      # population = nodes, typed by node type
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

    @property
    def device(self) -> torch.device:
        return self.adj_dst.device

    def to(self, device) -> "GraphTensors":
        """A copy with every tensor on ``device``."""
        def mv(v):
            if isinstance(v, (torch.Tensor, AliasTables)):
                return v.to(device)
            if isinstance(v, dict):
                return {k: mv(x) for k, x in v.items()}
            return v
        return dataclasses.replace(self, **{
            f.name: mv(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def _load_parts(path: str) -> Dict[str, np.ndarray]:
    files = sorted(glob.glob(os.path.join(path, "part_*.npz")))
    if not files:
        raise FileNotFoundError(f"no part_*.npz under {path}")
    parts = []
    for f in files:
        with np.load(f, allow_pickle=False) as z:
            parts.append(dict(z))
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}


class Graph:
    """Host-side graph: external ids on the host, ``tensors`` on a device.

    The equivalent of euler_tpu's ``Graph`` for the packs in
    ``KNOWN_PACKS``.
    """

    def __init__(self, meta: GraphMeta, arrays: Dict[str, np.ndarray],
                 packs: Tuple[str, ...] = PACKS, device=None):
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

        (group_ptr, adj_dst, adj_w, _, _, perm) = _convert.build_csr(
            n, net, arrays["src"], arrays["dst"], arrays["etype"],
            arrays["ew"], arrays["eid"])
        # exact per-group weight sums (no cumsum cancellation)
        seg = np.repeat(np.arange(n * net), np.diff(group_ptr))
        gws = np.zeros(n * net, np.float64)
        np.add.at(gws, seg, adj_w.astype(np.float64))
        group_w_sum = gws.astype(np.float32).reshape(n, net)
        adj_prob, adj_alias = build_group_alias(group_ptr, adj_w)
        na = build_typed_alias_tables(node_type, node_w,
                                      meta.num_node_types)

        dense_nf = {spec.name: arrays[f"nf_d:{spec.name}"][order]
                    for spec in meta.node_features if spec.kind == DENSE}

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        fan = {}
        if "fan" in packs:
            fan = dict(
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
            packed = (arrays["etype"][perm].astype(np.int32)
                      << FANU_SHIFT) | adj_dst
            prob_u, alias_u = build_group_alias(node_ptr, adj_w)
            wsum_u = group_w_sum.reshape(n, net).sum(axis=1)
            fan.update(
                fanu_pack=put(build_fan_pack(node_ptr, packed, prob_u,
                                             alias_u, wsum_u)),
                fanu_over_rows=put(np.nonzero(
                    np.diff(node_ptr) > FAN_D)[0].astype(np.int32)),
                fanu_ptr=put(node_ptr.astype(np.int32)),
                fanu_dst=put(packed), fanu_prob=put(prob_u),
                fanu_alias=put(alias_u))
        self.tensors = GraphTensors(
            meta=meta,
            group_ptr=put(group_ptr.astype(np.int32)),
            adj_dst=put(adj_dst),
            adj_prob=put(adj_prob),
            adj_alias=put(adj_alias),
            group_w_sum=put(group_w_sum),
            dense_nf={k: put(v) for k, v in dense_nf.items()},
            node_alias=AliasTables(
                ids=put(na["ids"]), type_ptr=put(na["type_ptr"].astype(
                    np.int32)), prob=put(na["prob"]), alias=put(na["alias"]),
                w_sum=put(na["w_sum"])),
            **fan)

    def local_id(self, ext_id: int) -> int:
        return self._local_of[int(ext_id)]


def load_graph(path: str, packs: Tuple[str, ...] = PACKS,
               device=None) -> Graph:
    """Load a converted graph directory (local files) onto ``device``."""
    with open(os.path.join(path, _convert.META_FILE)) as f:
        meta = GraphMeta.from_json(f.read())
    return Graph(meta, _load_parts(path), packs=packs, device=device)
