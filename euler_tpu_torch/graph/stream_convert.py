"""Streaming, bounded-memory graph converter: a copy of
euler_tpu/graph/stream_convert.py, whose output the two packages share.

The whole-graph JSON converter (convert.py) holds the graph in host
memory; this module converts in chunks with a fixed memory budget
(reference: euler/tools/generate_euler_data.py:28-63 writes
per-partition files record by record):

  * ``StreamWriter`` routes each chunk's rows to per-partition
    append-only raw column files (no global arrays ever exist);
  * ``finalize()`` packs one partition at a time into the standard
    ``part_p.npz`` + ``meta.json`` shard set that ``load_graph`` reads:
    peak memory is O(chunk) while streaming and O(largest partition)
    while packing (choose n_partitions to bound it);
  * node ids must be dense ints in [0, N) (the ogbn convention): id
    compaction needs a global id map, which bounded memory forbids.

Front-ends: ``convert_ndjson`` (one JSON record per line: a node
``{"id", "type", "weight", "features": [...]}`` or an edge
``{"src", "dst", "type", "weight", ...}``) and ``convert_edge_list``
(``src<TAB>dst[<TAB>weight]`` text, nodes implied; parsed by the native
core where it loaded, else by a Python loop with the same skip and
comment rules). ``main`` is the CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from euler_tpu_torch.graph import convert as _convert
from euler_tpu_torch.graph.meta import DENSE, SPARSE, FeatureSpec, GraphMeta
from euler_tpu_torch.native import loader as _native


class _ColumnFiles:
    """Append-only raw columns for one partition."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._fh = {}

    def append(self, name: str, arr: np.ndarray):
        fh = self._fh.get(name)
        if fh is None:
            fh = self._fh[name] = open(
                os.path.join(self.root, name + ".bin"), "ab")
        np.ascontiguousarray(arr).tofile(fh)

    def close(self):
        for fh in self._fh.values():
            fh.close()
        self._fh = {}

    def read(self, name: str, dtype, shape_tail=()) -> np.ndarray:
        p = os.path.join(self.root, name + ".bin")
        if not os.path.exists(p):
            return np.zeros((0,) + shape_tail, dtype)
        a = np.fromfile(p, dtype=dtype)
        if shape_tail:
            a = a.reshape((-1,) + shape_tail)
        return a


class StreamWriter:
    """Chunked converter: call add_nodes/add_edges any number of times,
    then finalize(). Types and feature specs are discovered on first
    use and must stay consistent across chunks."""

    def __init__(self, out_dir: str, n_partitions: int = 1,
                 build_in_edges: bool = True, directed: bool = True):
        self.out_dir = out_dir
        self.P = int(n_partitions)
        self.build_in_edges = build_in_edges
        self.directed = directed
        self.tmp = os.path.join(out_dir, "_stream_tmp")
        if os.path.exists(self.tmp):
            shutil.rmtree(self.tmp)
        self.cols = [_ColumnFiles(os.path.join(self.tmp, f"p{p}"))
                     for p in range(self.P)]
        self.node_types: List[str] = []
        self.edge_types: List[str] = []
        self._nt = {}
        self._et = {}
        self.node_specs: Optional[List[FeatureSpec]] = None
        self.edge_specs: Optional[List[FeatureSpec]] = None
        self.n_nodes = 0          # max id + 1 seen
        self.n_edges = 0
        self._node_count = 0
        self._finalized = False

    # -- type interning ------------------------------------------------------
    def _type_ids(self, table, names, values) -> np.ndarray:
        out = np.empty(len(values), np.int32)
        for i, v in enumerate(values):
            v = str(v)
            t = table.get(v)
            if t is None:
                t = table[v] = len(names)
                names.append(v)
            out[i] = t
        return out

    def _specs(self, current, feats: Dict[str, Tuple[str, np.ndarray]],
               what: str) -> List[FeatureSpec]:
        got = sorted((n, k, int(a.shape[1]) if a.ndim > 1 else 0)
                     for n, (k, a) in feats.items())
        specs = [FeatureSpec(n, k, d) for n, k, d in got]
        if current is None:
            return specs
        if [(s.name, s.kind, s.dim) for s in specs] != \
                [(s.name, s.kind, s.dim) for s in current]:
            raise ValueError(
                f"{what} feature specs changed between chunks: "
                f"{current} -> {specs}")
        return current

    # -- chunk ingestion -----------------------------------------------------
    def add_nodes(self, ids, types="n", weights=None, dense=None,
                  sparse=None):
        """One chunk of nodes. ids int [c]; types str or [c]; weights
        [c] (default 1); dense: {name: f32 [c, d]}; sparse:
        {name: (int32 [c, d] -1-padded, int32 [c] lengths)}."""
        ids = np.asarray(ids, np.int64)
        c = len(ids)
        if np.isscalar(types) or isinstance(types, str):
            types = [types] * c
        ty = self._type_ids(self._nt, self.node_types, types)
        w = np.ones(c, np.float32) if weights is None \
            else np.asarray(weights, np.float32)
        feats = {}
        for name, a in (dense or {}).items():
            feats[name] = (DENSE, np.asarray(a, np.float32))
        for name, (a, ln) in (sparse or {}).items():
            feats[name] = (SPARSE, np.asarray(a, np.int32))
            feats[name + "\0len"] = ("len", np.asarray(ln, np.int32))
        self.node_specs = self._specs(
            self.node_specs,
            {n: v for n, v in feats.items() if not n.endswith("\0len")},
            "node")
        if ids.max(initial=-1) >= 2 ** 31:
            raise ValueError("node ids must fit int32 (dense [0, N) "
                             "ids; run the id compactor first)")
        self.n_nodes = max(self.n_nodes, int(ids.max(initial=-1)) + 1)
        self._node_count += c
        part = ids % self.P
        for p in range(self.P):
            sel = part == p
            if not sel.any():
                continue
            cf = self.cols[p]
            cf.append("node_local", ids[sel].astype(np.int32))
            cf.append("node_type", ty[sel])
            cf.append("node_w", w[sel])
            for name, (kind, a) in feats.items():
                tag = {"len": "nf_splen:", DENSE: "nf_d:",
                       SPARSE: "nf_sp:"}[kind]
                cf.append(tag + name.replace("\0len", ""), a[sel])

    def add_edges(self, src, dst, types="0", weights=None, dense=None,
                  sparse=None):
        """One chunk of edges; edge ids are assigned sequentially in
        arrival order (the dense 0..E-1 permutation the store requires).
        Edges are routed to their SOURCE node's partition."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        c = len(src)
        if np.isscalar(types) or isinstance(types, str):
            types = [types] * c
        ty = self._type_ids(self._et, self.edge_types, types)
        w = np.ones(c, np.float32) if weights is None \
            else np.asarray(weights, np.float32)
        feats = {}
        for name, a in (dense or {}).items():
            feats[name] = (DENSE, np.asarray(a, np.float32))
        for name, (a, ln) in (sparse or {}).items():
            feats[name] = (SPARSE, np.asarray(a, np.int32))
            feats[name + "\0len"] = ("len", np.asarray(ln, np.int32))
        self.edge_specs = self._specs(
            self.edge_specs,
            {n: v for n, v in feats.items() if not n.endswith("\0len")},
            "edge")
        if max(src.max(initial=-1), dst.max(initial=-1)) >= 2 ** 31:
            raise ValueError("edge endpoint ids must fit int32 (dense "
                             "[0, N) ids; run the id compactor first)")
        eid = np.arange(self.n_edges, self.n_edges + c, dtype=np.int32)
        self.n_edges += c
        self.n_nodes = max(self.n_nodes,
                           int(src.max(initial=-1)) + 1,
                           int(dst.max(initial=-1)) + 1)
        part = src % self.P
        for p in range(self.P):
            sel = part == p
            if not sel.any():
                continue
            cf = self.cols[p]
            cf.append("src", src[sel].astype(np.int32))
            cf.append("dst", dst[sel].astype(np.int32))
            cf.append("etype", ty[sel])
            cf.append("ew", w[sel])
            cf.append("eid", eid[sel])
            for name, (kind, a) in feats.items():
                tag = {"len": "ef_splen:", DENSE: "ef_d:",
                       SPARSE: "ef_sp:"}[kind]
                cf.append(tag + name.replace("\0len", ""), a[sel])

    # -- finalize ------------------------------------------------------------
    def finalize(self, default_node_type: str = "n") -> GraphMeta:
        """Pack part_p.npz one partition at a time + meta.json; remove
        the temp columns. Nodes never added explicitly (edge-list input)
        are synthesized with ``default_node_type`` and weight 1."""
        if self._finalized:
            raise RuntimeError("finalize() called twice")
        self._finalized = True
        for cf in self.cols:
            cf.close()
        if not self.node_types:
            self._type_ids(self._nt, self.node_types, [default_node_type])
        if not self.edge_types:
            self.edge_types.append("0")
        implicit_nodes = self._node_count == 0

        # canonical sorted type names (the bulk converter's contract):
        # remap the first-seen interning ids during the pack below
        nt_sorted = sorted(self.node_types)
        et_sorted = sorted(self.edge_types)
        nt_remap = np.asarray(
            [nt_sorted.index(n) for n in self.node_types], np.int32)
        et_remap = np.asarray(
            [et_sorted.index(n) for n in self.edge_types], np.int32)
        self.node_types, self.edge_types = nt_sorted, et_sorted

        node_specs = tuple(self.node_specs or ())
        edge_specs = tuple(self.edge_specs or ())
        meta = GraphMeta(
            n_nodes=self.n_nodes, n_edges=self.n_edges,
            node_types=tuple(self.node_types),
            edge_types=tuple(self.edge_types),
            node_features=node_specs, edge_features=edge_specs,
            directed=self.directed, has_in_edges=self.build_in_edges,
            sparse_hash_buckets=0, n_partitions=self.P)

        part_edge_counts = []
        for p in range(self.P):
            cf = self.cols[p]
            if implicit_nodes:
                ids = np.arange(p, self.n_nodes, self.P, dtype=np.int32)
                node_local = ids
                node_type = np.zeros(len(ids), np.int32)
                node_w = np.ones(len(ids), np.float32)
            else:
                node_local = cf.read("node_local", np.int32)
                node_type = cf.read("node_type", np.int32)
                node_w = cf.read("node_w", np.float32)
            arrs = dict(
                ext_ids=node_local.astype(np.int64),
                node_local=node_local,
                node_type=nt_remap[node_type],
                node_w=node_w,
                src=cf.read("src", np.int32),
                dst=cf.read("dst", np.int32),
                etype=et_remap[cf.read("etype", np.int32)],
                ew=cf.read("ew", np.float32),
                eid=cf.read("eid", np.int32),
            )
            for s in node_specs:
                if s.kind == DENSE:
                    arrs[f"nf_d:{s.name}"] = cf.read(
                        f"nf_d:{s.name}", np.float32).reshape(-1, s.dim)
                else:
                    arrs[f"nf_sp:{s.name}"] = cf.read(
                        f"nf_sp:{s.name}", np.int32).reshape(-1, s.dim)
                    arrs[f"nf_splen:{s.name}"] = cf.read(
                        f"nf_splen:{s.name}", np.int32)
            for s in edge_specs:
                if s.kind == DENSE:
                    arrs[f"ef_d:{s.name}"] = cf.read(
                        f"ef_d:{s.name}", np.float32).reshape(-1, s.dim)
                else:
                    arrs[f"ef_sp:{s.name}"] = cf.read(
                        f"ef_sp:{s.name}", np.int32).reshape(-1, s.dim)
                    arrs[f"ef_splen:{s.name}"] = cf.read(
                        f"ef_splen:{s.name}", np.int32)
            part_edge_counts.append(len(arrs["eid"]))
            # npz (zip64) — same layout write_shards produces
            np.savez(os.path.join(self.out_dir, f"part_{p}.npz"), **arrs)
            del arrs

        meta = dataclasses.replace(
            meta, part_edge_counts=tuple(part_edge_counts))
        with open(os.path.join(self.out_dir, _convert.META_FILE),
                  "w") as f:
            f.write(meta.to_json())
        shutil.rmtree(self.tmp)
        return meta


def _feat_arrays(records, specs_hint=None):
    """features list-of-dicts per record -> {name: dense arr | (ids, len)}.
    Dims come from the first chunk (records must pad consistently)."""
    dense, sparse = {}, {}
    names = {}
    for r in records:
        for f in r.get("features", []):
            names[f["name"]] = f["type"]
    for name, kind in names.items():
        vals = [next((f["value"] for f in r.get("features", [])
                      if f["name"] == name), []) for r in records]
        if kind == DENSE:
            d = max((len(v) for v in vals), default=0)
            a = np.zeros((len(records), d), np.float32)
            for i, v in enumerate(vals):
                a[i, :len(v)] = v
            dense[name] = a
        elif kind == SPARSE:
            d = max((len(v) for v in vals), default=0)
            a = np.full((len(records), d), -1, np.int32)
            ln = np.zeros(len(records), np.int32)
            for i, v in enumerate(vals):
                a[i, :len(v)] = v
                ln[i] = len(v)
            sparse[name] = (a, ln)
        else:
            raise ValueError(
                "binary features are not supported by the streaming "
                "converter; use convert_json_graph for labeled small "
                "graphs")
    return dense, sparse


def convert_ndjson(path: str, out_dir: str, n_partitions: int = 1,
                   chunk_size: int = 100_000, **kw) -> GraphMeta:
    """One JSON record per line: nodes carry "id", edges carry
    "src"/"dst" (euler JSON schema fields otherwise,
    tools/test_data/graph.json)."""
    w = StreamWriter(out_dir, n_partitions, **kw)

    def flush(nodes, edges):
        if nodes:
            dense, sparse = _feat_arrays(nodes)
            w.add_nodes([n["id"] for n in nodes],
                        [n.get("type", "n") for n in nodes],
                        [float(n.get("weight", 1.0)) for n in nodes],
                        dense=dense, sparse=sparse)
        if edges:
            dense, sparse = _feat_arrays(edges)
            w.add_edges([e["src"] for e in edges],
                        [e["dst"] for e in edges],
                        [e.get("type", "0") for e in edges],
                        [float(e.get("weight", 1.0)) for e in edges],
                        dense=dense, sparse=sparse)

    nodes, edges = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            (edges if "src" in r else nodes).append(r)
            if len(nodes) >= chunk_size:
                flush(nodes, [])
                nodes = []
            if len(edges) >= chunk_size:
                flush([], edges)
                edges = []
    flush(nodes, edges)
    return w.finalize()


def convert_edge_list(path: str, out_dir: str, n_partitions: int = 1,
                      chunk_size: int = 1_000_000, delimiter=None,
                      **kw) -> GraphMeta:
    """``src dst [weight]`` text lines; nodes are implicit (type 'n',
    weight 1) — the ogbn edge-list shape.

    The line loop parses through the native core when available
    (euler_tpu_torch/csrc/euler_core.cc etpu_parse_edge_list, two-pass
    parallel scan: a Python loop tops out ~1M lines/s, hours at
    papers100M scale); Python fallback otherwise, same skip/comment
    contract."""
    w = StreamWriter(out_dir, n_partitions, **kw)

    if _native.get_lib() is not None and delimiter in (None, "\t", " ",
                                                       ","):
        # binary chunks snapped to line boundaries -> native parse
        buf_bytes = max(1 << 22, chunk_size * 16)
        carry = b""
        with open(path, "rb") as f:
            while True:
                block = f.read(buf_bytes)
                if not block:
                    break
                block = carry + block
                cut = block.rfind(b"\n")
                if cut < 0:
                    carry = block
                    continue
                carry, chunk = block[cut + 1:], block[:cut + 1]
                res = _native.parse_edge_list_native(chunk)
                if res is None:   # native core vanished mid-stream
                    raise RuntimeError(
                        "native edge-list parser unavailable mid-file")
                s, d, wt = res
                if len(s):
                    w.add_edges(s, d, weights=wt)
        if carry:
            res = _native.parse_edge_list_native(carry + b"\n")
            if res is not None and len(res[0]):
                w.add_edges(res[0], res[1], weights=res[2])
        return w.finalize()

    src, dst, wt = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split(delimiter)
            if len(parts) < 2 or line.lstrip().startswith("#"):
                continue
            try:            # malformed rows are skipped, not fatal
                s, d = int(parts[0]), int(parts[1])
                wv = float(parts[2]) if len(parts) > 2 else 1.0
            except ValueError:
                continue
            src.append(s)
            dst.append(d)
            wt.append(wv)
            if len(src) >= chunk_size:
                w.add_edges(src, dst, weights=wt)
                src, dst, wt = [], [], []
    if src:
        w.add_edges(src, dst, weights=wt)
    return w.finalize()


def main(argv=None):
    """CLI: ``python -m euler_tpu_torch.graph.stream_convert input out_dir
    [--partitions N] [--format ndjson|edgelist]`` — the bounded-memory
    twin of ``python -m euler_tpu_torch.graph.convert``
    (reference: generate_euler_data.py incremental partition writes)."""
    import argparse
    p = argparse.ArgumentParser(prog="python -m euler_tpu_torch.graph."
                                     "stream_convert")
    p.add_argument("input")
    p.add_argument("out_dir")
    p.add_argument("--partitions", type=int, default=1)
    p.add_argument("--format", choices=["ndjson", "edgelist"],
                   default=None)
    p.add_argument("--chunk-size", type=int, default=100_000)
    p.add_argument("--no-in-edges", action="store_true")
    args = p.parse_args(argv)
    fmt = args.format or ("ndjson" if args.input.endswith(
        (".ndjson", ".jsonl")) else "edgelist")
    fn = convert_ndjson if fmt == "ndjson" else convert_edge_list
    meta = fn(args.input, args.out_dir, n_partitions=args.partitions,
              chunk_size=args.chunk_size,
              build_in_edges=not args.no_in_edges)
    print(f"[euler_tpu_torch] stream-converted {args.input} -> "
          f"{args.out_dir}: "
          f"{meta.n_nodes} nodes, {meta.n_edges} edges, "
          f"{meta.n_partitions} partition(s)")
    return meta


if __name__ == "__main__":
    main()
