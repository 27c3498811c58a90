"""JSON graph -> binary shard converter: a copy of
euler_tpu/graph/convert.py, whose output the two packages share.

A graph converts to a directory of ``.npz`` partitions plus
``meta.json`` (reference: euler/tools/generate_euler_data.py:28-63 and
euler/tools/node.py:58-79): external ids compacted to int32 local ids in
sorted order (``ext_ids`` keeps the originals), node i in partition
i % P, each edge with its source, features packed dense (zero padded),
sparse (-1 padded, with lengths) or binary (host-only strings).
``build_csr`` sorts edges into the grouped CSR layout that the store
builds at load (reference: euler/core/graph/node.h:49-57). ``main`` is
the CLI, ``python -m euler_tpu_torch.graph.convert graph.json out_dir
[--partitions N]``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence

import numpy as np

from euler_tpu_torch.graph.meta import (BINARY, DENSE, SPARSE, FeatureSpec,
                                        GraphMeta)
from euler_tpu_torch.native import loader as _native
from euler_tpu_torch.utils import io as _io

META_FILE = "meta.json"


def _norm_type_names(types) -> List[str]:
    """Accept int-typed or str-typed type fields; return the canonical
    name list."""
    names = sorted({str(t) for t in types})
    return names


def _collect_feature_specs(items) -> List[FeatureSpec]:
    kinds: Dict[str, str] = {}
    dims: Dict[str, int] = {}
    for it in items:
        for f in it.get("features", []):
            name, kind = f["name"], f["type"]
            prev = kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"feature {name!r} has mixed kinds {prev}/{kind}")
            kinds[name] = kind
            if kind in (DENSE, SPARSE):
                dims[name] = max(dims.get(name, 0), len(f["value"]))
            else:
                dims[name] = 0
    return [FeatureSpec(n, kinds[n], dims[n]) for n in sorted(kinds)]


def _pack_features(items, specs: Sequence[FeatureSpec], hash_buckets: int):
    """Pack per-item feature lists into dense matrices.

    dense   -> float32 [N, dim]   (zero padded; reference stores ragged float,
                                   queried at fixed dim — get_feature_op.cc)
    sparse  -> int32  [N, dim]    (-1 padded) + int32 [N] lengths
    binary  -> object array       (host-only; e.g. 'graph_label')
    """
    n = len(items)
    out = {}
    for spec in specs:
        if spec.kind == DENSE:
            out[spec.name] = (np.zeros((n, spec.dim), np.float32),)
        elif spec.kind == SPARSE:
            out[spec.name] = (
                np.full((n, spec.dim), -1, np.int64),
                np.zeros((n,), np.int32),
            )
        else:
            out[spec.name] = (np.full((n,), "", dtype=object),)
    for i, it in enumerate(items):
        for f in it.get("features", []):
            spec = next(s for s in specs if s.name == f["name"])
            if spec.kind == DENSE:
                v = np.asarray(f["value"], np.float32)
                out[spec.name][0][i, : len(v)] = v
            elif spec.kind == SPARSE:
                v = np.asarray(f["value"], np.int64)
                if hash_buckets:
                    v = v % hash_buckets
                out[spec.name][0][i, : len(v)] = v
                out[spec.name][1][i] = len(v)
            else:
                out[spec.name][0][i] = f["value"]
    # sparse ids must fit int32 on device
    for spec in specs:
        if spec.kind == SPARSE:
            vals = out[spec.name][0]
            if vals.max(initial=0) >= 2**31:
                raise ValueError(
                    f"sparse feature {spec.name!r} ids exceed int32; "
                    "pass hash_buckets= to compact them")
            out[spec.name] = (vals.astype(np.int32), out[spec.name][1])
    return out


def convert_json_graph(
    graph: dict,
    out_dir: str,
    n_partitions: int = 1,
    directed: bool = True,
    build_in_edges: bool = True,
    hash_buckets: int = 0,
) -> GraphMeta:
    """Convert an euler-schema JSON graph dict to an ``out_dir`` shard set.

    JSON schema matches the reference's input
    (reference: tools/test_data/graph.json — nodes: {id, type, weight,
    features: [{name, type: sparse|dense|binary, value}]}; edges: {src, dst,
    type, weight, features}).
    """
    nodes = graph["nodes"]
    edges = graph.get("edges", [])

    node_type_names = _norm_type_names(n["type"] for n in nodes)
    edge_type_names = _norm_type_names(e["type"] for e in edges) or ["0"]
    nt_of = {name: i for i, name in enumerate(node_type_names)}
    et_of = {name: i for i, name in enumerate(edge_type_names)}

    # --- compact ids (stable order: sorted by external id) ----------------
    ext_ids = np.asarray(sorted(int(n["id"]) for n in nodes), np.int64)
    local = {int(e): i for i, e in enumerate(ext_ids)}
    order = np.argsort([int(n["id"]) for n in nodes], kind="stable")
    nodes = [nodes[i] for i in order]

    n, m = len(nodes), len(edges)
    node_type = np.asarray([nt_of[str(x["type"])] for x in nodes], np.int32)
    node_w = np.asarray([float(x.get("weight", 1.0)) for x in nodes],
                        np.float32)

    src = np.asarray([local[int(e["src"])] for e in edges], np.int32)
    dst = np.asarray([local[int(e["dst"])] for e in edges], np.int32)
    etype = np.asarray([et_of[str(e["type"])] for e in edges], np.int32)
    ew = np.asarray([float(e.get("weight", 1.0)) for e in edges], np.float32)

    node_specs = _collect_feature_specs(nodes)
    edge_specs = _collect_feature_specs(edges)

    nfeat = _pack_features(nodes, node_specs, hash_buckets)
    efeat = _pack_features(edges, edge_specs, hash_buckets)

    meta = GraphMeta(
        n_nodes=n,
        n_edges=m,
        node_types=tuple(node_type_names),
        edge_types=tuple(edge_type_names),
        node_features=tuple(node_specs),
        edge_features=tuple(edge_specs),
        directed=directed,
        has_in_edges=build_in_edges,
        sparse_hash_buckets=hash_buckets,
        n_partitions=n_partitions,
    )

    return write_shards(
        out_dir, meta, ext_ids, node_type, node_w, src, dst, etype, ew,
        nfeat, efeat)


def build_csr(n, n_et, src, dst, etype, ew, eid=None, native: bool = True):
    """Sort edges by (src, etype, dst); return group CSR arrays.

    Returns (group_ptr [n*n_et+1], col, w, w_cumsum, eid_sorted, perm).
    ``eid_sorted`` maps each CSR slot back to the original edge row.
    The native core does the sort when it loaded and ``native`` is true;
    numpy otherwise, whose sort is stable: edges with equal keys keep
    their input order (the native core's parallel sort does not).
    """
    m = len(src)
    if eid is None:
        eid = np.arange(m, dtype=np.int32)
    res = _native.build_csr_native(n, n_et, src, dst, etype, ew, eid) \
        if native else None
    if res is not None:
        return res
    perm = np.lexsort((dst, etype, src))
    s, t, d, w = src[perm], etype[perm], dst[perm], ew[perm]
    group_key = s.astype(np.int64) * n_et + t
    group_ptr = np.zeros(n * n_et + 1, np.int64)
    np.add.at(group_ptr, group_key + 1, 1)
    group_ptr = np.cumsum(group_ptr)
    if group_ptr[-1] <= 2**31 - 1:
        group_ptr = group_ptr.astype(np.int32)
    w_cumsum = np.cumsum(w, dtype=np.float64).astype(np.float32)
    return group_ptr, d.astype(np.int32), w.astype(np.float32), w_cumsum, \
        eid[perm].astype(np.int32), perm


def write_shards(out_dir, meta, ext_ids, node_type, node_w,
                 src, dst, etype, ew, nfeat, efeat):
    """Materialize meta.json + part_*.npz under out_dir.

    Partitioning is by ``local_id % n_partitions``
    (reference shard routing: (id % partition_number) % shard_num,
    euler/core/kernels/id_split_op.cc:46-48). Edges live with their source.
    """
    _io.makedirs(out_dir)
    npart = meta.n_partitions
    meta = dataclasses.replace(meta, part_edge_counts=tuple(
        int(np.sum((src % npart) == p)) for p in range(npart)))
    with _io.open_file(_io.join(out_dir, META_FILE), "w") as f:
        f.write(meta.to_json())

    for p in range(npart):
        nsel = (np.arange(len(ext_ids)) % npart) == p
        esel = (src % npart) == p
        arrs = {
            "ext_ids": ext_ids[nsel],
            "node_local": np.arange(len(ext_ids), dtype=np.int32)[nsel],
            "node_type": node_type[nsel],
            "node_w": node_w[nsel],
            "src": src[esel],
            "dst": dst[esel],
            "etype": etype[esel],
            "ew": ew[esel],
            "eid": np.arange(len(src), dtype=np.int32)[esel],
        }
        for name, parts in nfeat.items():
            spec = meta.node_feature(name)
            if spec.kind == BINARY:
                arrs[f"nf_bin:{name}"] = parts[0][nsel].astype("U")
            elif spec.kind == SPARSE:
                arrs[f"nf_sp:{name}"] = parts[0][nsel]
                arrs[f"nf_splen:{name}"] = parts[1][nsel]
            else:
                arrs[f"nf_d:{name}"] = parts[0][nsel]
        for name, parts in efeat.items():
            spec = meta.edge_feature(name)
            if spec.kind == BINARY:
                arrs[f"ef_bin:{name}"] = parts[0][esel].astype("U")
            elif spec.kind == SPARSE:
                arrs[f"ef_sp:{name}"] = parts[0][esel]
                arrs[f"ef_splen:{name}"] = parts[1][esel]
            else:
                arrs[f"ef_d:{name}"] = parts[0][esel]
        with _io.open_file(_io.join(out_dir, f"part_{p}.npz"),
                           "wb") as fh:
            np.savez_compressed(fh, **arrs)
    return meta


def convert_json_file(path: str, out_dir: str, **kw) -> GraphMeta:
    with open(path) as f:
        return convert_json_graph(json.load(f), out_dir, **kw)


def main(argv=None):
    """CLI: ``python -m euler_tpu_torch.graph.convert graph.json out_dir
    [--partitions N]`` — the role of the reference's converter entry
    ``python generate_euler_data.py graph.json output_dir partition_num``
    (euler/tools/generate_euler_data.py:53-62; index tables are derived
    from the converted features on device, so no index.meta input)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m euler_tpu_torch.graph.convert",
        description="Convert an euler-schema JSON graph to a shard "
                    "directory (meta.json + part_*.npz)")
    p.add_argument("graph_json", help="input JSON graph file")
    p.add_argument("out_dir", help="output shard directory")
    p.add_argument("partition_num", nargs="?", type=int, default=None,
                   help="positional partition count (reference CLI compat)")
    p.add_argument("--partitions", type=int, default=1)
    p.add_argument("--undirected", action="store_true",
                   help="add the reverse of every edge")
    p.add_argument("--no-in-edges", action="store_true",
                   help="skip building the in-adjacency (halves edge "
                        "storage; disables the in-neighbor verbs)")
    p.add_argument("--hash-buckets", type=int, default=0,
                   help="mod-hash sparse feature ids into this many "
                        "buckets (required if ids exceed int32)")
    args = p.parse_args(argv)
    nparts = args.partition_num or args.partitions
    meta = convert_json_file(
        args.graph_json, args.out_dir, n_partitions=nparts,
        directed=not args.undirected,
        build_in_edges=not args.no_in_edges,
        hash_buckets=args.hash_buckets)
    print(f"[euler_tpu_torch] converted {args.graph_json} -> {args.out_dir}: "
          f"{meta.n_nodes} nodes, {meta.n_edges} edges, "
          f"{len(meta.node_types)} node types, "
          f"{len(meta.edge_types)} edge types, {nparts} partition(s)")
    return meta


if __name__ == "__main__":
    main()
