"""Named datasets with the reference's metadata contract: a copy of
euler_tpu/datasets/registry.py.

The reference's dataset package (tf_euler/python/dataset/ —
base_dataset.py:37-120 download -> json -> binary; per-dataset classes
cora.py:33-49, citeseer, pubmed, ppi, reddit, mutag, fb15k, fb15k237,
wn18, ml_1m exposing max_node_id / train_node_type / train_edge_type /
feature_idx / feature_dim / label_idx / label_dim / id_file /
total_size; the registry utils.get_dataset). Nothing is downloaded;
``load_graph`` works in two modes:
  1. If the dataset's raw files are present under ``data_dir`` (the
     user's), they are parsed and converted: cora/citeseer content+cites
     text, pubmed's tab files, the GraphSAGE ppi/reddit files, MUTAG's
     TU files, KG triple files (train/valid/test.txt), ml-1m's
     ratings.dat.
  2. Otherwise a deterministic synthetic stand-in with the same metadata
     contract (feature_dim/label_dim/sizes scaled down) is generated and
     a notice printed. The stand-ins are seeded from
     ``abs(hash(self.name))``, as the reference's are, which Python
     salts per process unless PYTHONHASHSEED is set: two processes may
     generate different stand-ins.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from euler_tpu_torch.datasets.synthetic import (MotifDataset, SBMDataset,
                                                sbm_graph_json)
from euler_tpu_torch.graph.convert import convert_json_graph
from euler_tpu_torch.graph.store import Graph, load_graph


class NamedDataset:
    """Shared contract + convert-or-synthesize loading."""

    name = "base"
    feature_dim = 16
    label_dim = 4
    total_size = 400
    directed = False

    def __init__(self, data_dir: Optional[str] = None):
        root = data_dir or os.environ.get(
            "EULER_TPU_DATA", os.path.expanduser("~/.euler_tpu_data"))
        self.raw_dir = os.path.join(root, self.name)
        self.data_dir = os.path.join(root, self.name, "euler")
        self.max_node_id = self.total_size - 1
        self.train_node_type = "train"
        self.all_node_type = -1
        self.train_edge_type = ["train"]
        self.all_edge_type = ["train"]
        self.feature_idx = "feature"
        self.label_idx = "label"
        self.num_classes = self.label_dim
        self.id_file = os.path.join(self.data_dir, "test_ids.npy")

    # -- hooks ---------------------------------------------------------------
    def has_raw(self) -> bool:
        return False

    def raw_to_json(self) -> Dict:
        raise NotImplementedError

    def synthetic_json(self) -> Dict:
        # stand-ins scale the contract down; attrs track what's generated
        self.feature_dim = min(self.feature_dim, 64) or 16
        self.label_dim = min(self.label_dim, 16) or 4
        g, comm, is_train = sbm_graph_json(
            n_nodes=min(self.total_size, 2000),
            n_classes=self.label_dim,
            feat_dim=self.feature_dim,
            seed=abs(hash(self.name)) % (2 ** 31))
        # rename to the contract's type names
        for n in g["nodes"]:
            n["type"] = "train" if n["type"] == "train" else "test"
        for e in g["edges"]:
            e["type"] = "train"
        self._test_mask = ~is_train
        return g

    # -- loading -------------------------------------------------------------
    def load_graph(self, device=None, **kw) -> Graph:
        """Convert the raw files (else a stand-in) on first use, then
        ``load_graph(data_dir, device=, **kw)``."""
        meta_path = os.path.join(self.data_dir, "meta.json")
        if not os.path.exists(meta_path):
            if self.has_raw():
                j = self.raw_to_json()
            else:
                print(f"[euler_tpu_torch] dataset '{self.name}': raw files "
                      f"not found under {self.raw_dir}; generating a "
                      f"synthetic stand-in with the same contract")
                j = self.synthetic_json()
            convert_json_graph(j, self.data_dir, directed=self.directed)
            if getattr(self, "_test_mask", None) is not None:
                np.save(self.id_file,
                        np.nonzero(self._test_mask)[0].astype(np.int32))
        graph = load_graph(self.data_dir, device=device, **kw)
        # contract values reflect what was actually converted
        self.max_node_id = graph.meta.n_nodes - 1
        self.total_size = graph.meta.n_nodes
        if os.path.exists(self.id_file):
            self._test_ids = np.load(self.id_file)
        else:
            self._test_ids = np.arange(graph.meta.n_nodes, dtype=np.int32)
        return graph

    @property
    def test_ids(self) -> np.ndarray:
        if not hasattr(self, "_test_ids"):
            self.load_graph(device="cpu")   # for the ids; the graph is dropped
        return self._test_ids


class _ContentCitesDataset(NamedDataset):
    """cora/citeseer raw format: <name>.content (id feat... label) +
    <name>.cites (citing cited), reference: cora.py convert2json."""

    content_file = None
    cites_file = None

    def load_graph(self, device=None, **kw) -> Graph:
        """As ``NamedDataset.load_graph``; the feature and label widths
        are the converted directory's. ``raw_to_json`` sets them from
        the raw files at the first conversion; a fresh object over the
        directory would keep the class's declared ones, which the
        reference does, so that a raw set of other widths (a miniature
        fixture) fails the model of every later run."""
        graph = super().load_graph(device=device, **kw)
        self.feature_dim = graph.meta.node_feature(self.feature_idx).dim
        self.label_dim = graph.meta.node_feature(self.label_idx).dim
        return graph

    def has_raw(self):
        return (os.path.exists(os.path.join(self.raw_dir,
                                            self.content_file)) and
                os.path.exists(os.path.join(self.raw_dir, self.cites_file)))

    def raw_to_json(self):
        ids, feats, labels = [], [], []
        with open(os.path.join(self.raw_dir, self.content_file)) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) < 3:
                    continue
                ids.append(parts[0])
                feats.append([float(v) for v in parts[1:-1]])
                labels.append(parts[-1])
        classes = sorted(set(labels))
        cls_of = {c: i for i, c in enumerate(classes)}
        id_of = {s: i for i, s in enumerate(ids)}
        n = len(ids)
        rng = np.random.default_rng(0)
        # reference holds out the tail for test (cora.py test_start_num)
        test_start = int(n * 0.63)
        nodes = []
        is_test = np.zeros(n, bool)
        for i, (sid, fv, lab) in enumerate(zip(ids, feats, labels)):
            one_hot = [0.0] * len(classes)
            one_hot[cls_of[lab]] = 1.0
            ntype = "test" if i >= test_start else "train"
            is_test[i] = i >= test_start
            nodes.append({"id": i, "type": ntype, "weight": 1.0,
                          "features": [
                              {"name": "feature", "type": "dense",
                               "value": fv},
                              {"name": "label", "type": "dense",
                               "value": one_hot}]})
        edges = []
        with open(os.path.join(self.raw_dir, self.cites_file)) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 2:
                    continue
                a, b = parts
                if a in id_of and b in id_of:
                    for s, d in ((a, b), (b, a)):
                        edges.append({"src": id_of[s], "dst": id_of[d],
                                      "type": "train", "weight": 1.0,
                                      "features": []})
        self.feature_dim = len(feats[0])
        self.label_dim = len(classes)
        self._test_mask = is_test
        return {"nodes": nodes, "edges": edges}


class Cora(_ContentCitesDataset):
    name = "cora"
    feature_dim = 1433
    label_dim = 7
    total_size = 2708
    content_file = "cora.content"
    cites_file = "cora.cites"


class Citeseer(_ContentCitesDataset):
    name = "citeseer"
    feature_dim = 3703
    label_dim = 6
    total_size = 3312
    content_file = "citeseer.content"
    cites_file = "citeseer.cites"


class Pubmed(NamedDataset):
    """Pubmed-Diabetes tab files (NODE.paper.tab: header of w-* feature
    names, rows id<TAB>label=N<TAB>w-x=v...<TAB>summary; DIRECTED.cites.tab
    rows idx<TAB>paper:src<TAB>|<TAB>paper:dst).
    reference: pubmed.py convert2json + pubmed_utils.py:20-97 — node ids
    indexed by first appearance in the cites file, features sum-normalized,
    test = local id > test_start_num."""

    name = "pubmed"
    feature_dim = 500
    label_dim = 3
    total_size = 19717
    test_start_num = 18717

    def _raw_files(self):
        base = os.path.join(self.raw_dir, "data")
        if not os.path.isdir(base):
            base = self.raw_dir
        return (os.path.join(base, "Pubmed-Diabetes.NODE.paper.tab"),
                os.path.join(base, "Pubmed-Diabetes.DIRECTED.cites.tab"))

    def has_raw(self):
        return all(os.path.exists(p) for p in self._raw_files())

    def raw_to_json(self):
        node_tab, cite_tab = self._raw_files()
        id_of: Dict[str, int] = {}
        pairs = []
        with open(cite_tab) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 4:
                    continue
                s = parts[1].split(":")[1]
                d = parts[3].split(":")[1]
                id_of.setdefault(s, len(id_of))
                id_of.setdefault(d, len(id_of))
                pairs.append((id_of[s], id_of[d]))
        fea_of: Dict[str, int] = {}
        feats = {}
        labels = {}
        with open(node_tab) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 2:
                    continue
                if line.strip().startswith("cat=1,2,3"):
                    for tok in parts[1:-1]:
                        fea_of[tok.split(":")[-2]] = len(fea_of)
                    continue
                if len(parts) < 3 or "=" not in parts[1]:
                    continue        # header / malformed row
                pid = parts[0]
                if pid not in id_of:
                    id_of[pid] = len(id_of)
                lab = int(parts[1].split("=")[1]) - 1
                fv = np.zeros(len(fea_of), np.float64)
                for tok in parts[2:-1]:
                    k, v = tok.split("=")
                    if k in fea_of:
                        fv[fea_of[k]] = float(v)
                fv /= fv.sum() + 1e-7       # pubmed.py add_node normalizes
                feats[id_of[pid]] = fv
                labels[id_of[pid]] = lab
        n = len(id_of)
        tsn = self.test_start_num
        nodes = []
        is_test = np.zeros(n, bool)
        for i in range(n):
            one_hot = [0.0] * self.label_dim
            if i in labels:
                one_hot[labels[i]] = 1.0
            fv = feats.get(i, np.zeros(len(fea_of)))
            is_test[i] = i > tsn
            nodes.append({"id": i, "type": "test" if i > tsn else "train",
                          "weight": 1.0, "features": [
                              {"name": "feature", "type": "dense",
                               "value": list(map(float, fv))},
                              {"name": "label", "type": "dense",
                               "value": one_hot}]})
        edges = [{"src": s, "dst": d,
                  "type": "train_removed" if (s > tsn or d > tsn)
                  else "train", "weight": 1.0, "features": []}
                 for s, d in pairs]
        self.feature_dim = len(fea_of)
        self.all_edge_type = ["train", "train_removed"]
        self._test_mask = is_test
        return {"nodes": nodes, "edges": edges}


class PPI(NamedDataset):
    """GraphSAGE ppi.zip: ppi-G.json (node_link graph with test/val node
    flags), ppi-feats.npy, ppi-id_map.json, ppi-class_map.json.
    reference: ppi.py convert2json — node weight = degree, edge type
    train_removed when either end is test/val."""

    name = "ppi"
    feature_dim = 50
    label_dim = 121
    total_size = 56944

    def has_raw(self):
        return all(os.path.exists(os.path.join(self.raw_dir, f)) for f in
                   ("ppi-G.json", "ppi-feats.npy", "ppi-id_map.json",
                    "ppi-class_map.json"))

    def raw_to_json(self):
        import json as _json
        with open(os.path.join(self.raw_dir, "ppi-G.json")) as f:
            G = _json.load(f)
        feats = np.load(os.path.join(self.raw_dir, "ppi-feats.npy"))
        with open(os.path.join(self.raw_dir, "ppi-id_map.json")) as f:
            id_map = _json.load(f)
        with open(os.path.join(self.raw_dir, "ppi-class_map.json")) as f:
            class_map = _json.load(f)
        gnodes = G["nodes"]
        deg = {}
        links = []
        for e in G["links"]:
            s, d = e["source"], e["target"]
            # node_link refs may be positional indices or node ids
            sid = gnodes[s]["id"] if isinstance(s, int) and s < len(gnodes) \
                else s
            did = gnodes[d]["id"] if isinstance(d, int) and d < len(gnodes) \
                else d
            links.append((sid, did))
            deg[sid] = deg.get(sid, 0) + 1
            deg[did] = deg.get(did, 0) + 1
        nodes = []
        is_eval = {}
        n = len(gnodes)
        is_test = np.zeros(n, bool)
        for nd in gnodes:
            nid = nd["id"]
            idx = id_map[str(nid)] if str(nid) in id_map else id_map[nid]
            typ = "test" if nd.get("test") else (
                "val" if nd.get("val") else "train")
            is_eval[nid] = typ != "train"
            if idx < n:
                is_test[idx] = nd.get("test", False)
            lab = class_map[str(nid)] if str(nid) in class_map \
                else class_map[nid]
            nodes.append({"id": idx, "type": typ,
                          # true degree, 0 for isolated nodes — matches
                          # the reference's ppi.py convert2json weights
                          "weight": float(deg.get(nid, 0)),
                          "features": [
                              {"name": "feature", "type": "dense",
                               "value": list(map(float, feats[idx]))},
                              {"name": "label", "type": "dense",
                               "value": list(map(float, lab))}]})
        edges = []
        for sid, did in links:
            et = "train_removed" if (is_eval.get(sid) or is_eval.get(did)) \
                else "train"
            si = id_map[str(sid)] if str(sid) in id_map else id_map[sid]
            di = id_map[str(did)] if str(did) in id_map else id_map[did]
            for a, b in ((si, di), (di, si)):
                edges.append({"src": a, "dst": b, "type": et,
                              "weight": 1.0, "features": []})
        self.feature_dim = int(feats.shape[1])
        self.all_edge_type = ["train", "train_removed"]
        self._test_mask = is_test
        return {"nodes": nodes, "edges": edges}

    def synthetic_json(self):
        # multi-label stand-in: labels are independent sigmoid targets
        g = super().synthetic_json()
        rng = np.random.default_rng(1)
        for n in g["nodes"]:
            lab = (rng.random(self.label_dim) < 0.3).astype(float)
            for f in n["features"]:
                if f["name"] == "label":
                    f["value"] = lab.tolist()
        return g


class Reddit(NamedDataset):
    """GraphSAGE reddit.zip: reddit-G.json / reddit-feats.npy /
    reddit-id_map.json / reddit-class_map.json (same node_link format as
    PPI with SCALAR class labels). reference: reddit.py + sage_util.py
    load_data — features standardized by the train split's mean/std,
    node weight = degree, edge type train_removed when either end is
    val/test."""

    name = "reddit"
    feature_dim = 602
    label_dim = 41
    total_size = 232965

    def has_raw(self):
        return all(os.path.exists(os.path.join(self.raw_dir, f)) for f in
                   ("reddit-G.json", "reddit-feats.npy",
                    "reddit-id_map.json", "reddit-class_map.json"))

    def raw_to_json(self):
        import json as _json
        with open(os.path.join(self.raw_dir, "reddit-G.json")) as f:
            G = _json.load(f)
        feats = np.load(os.path.join(self.raw_dir, "reddit-feats.npy"))
        with open(os.path.join(self.raw_dir, "reddit-id_map.json")) as f:
            id_map = _json.load(f)
        with open(os.path.join(self.raw_dir, "reddit-class_map.json")) as f:
            class_map = _json.load(f)
        gnodes = G["nodes"]

        def idx_of(nid):
            return id_map[str(nid)] if str(nid) in id_map else id_map[nid]

        n = len(gnodes)
        # train-split standardization (sage_util.py:83-91 StandardScaler)
        train_rows = [idx_of(nd["id"]) for nd in gnodes
                      if not (nd.get("test") or nd.get("val"))]
        mu = feats[train_rows].mean(axis=0)
        sd = feats[train_rows].std(axis=0)
        feats = (feats - mu) / np.where(sd > 0, sd, 1.0)

        deg = {}
        links = []
        for e in G["links"]:
            s, d = e["source"], e["target"]
            sid = gnodes[s]["id"] if isinstance(s, int) and s < n else s
            did = gnodes[d]["id"] if isinstance(d, int) and d < n else d
            links.append((sid, did))
            deg[sid] = deg.get(sid, 0) + 1
            deg[did] = deg.get(did, 0) + 1

        ncls = self.label_dim
        nodes, is_eval = [], {}
        is_test = np.zeros(n, bool)
        for nd in gnodes:
            nid = nd["id"]
            idx = idx_of(nid)
            typ = "test" if nd.get("test") else (
                "val" if nd.get("val") else "train")
            is_eval[nid] = typ != "train"
            if idx < n:
                is_test[idx] = bool(nd.get("test", False))
            cls = class_map[str(nid)] if str(nid) in class_map \
                else class_map[nid]
            one_hot = [0.0] * ncls
            one_hot[int(cls)] = 1.0
            nodes.append({"id": idx, "type": typ,
                          "weight": float(deg.get(nid, 0)),
                          "features": [
                              {"name": "feature", "type": "dense",
                               "value": [float(v) for v in feats[idx]]},
                              {"name": "label", "type": "dense",
                               "value": one_hot}]})
        edges = []
        for sid, did in links:
            et = "train_removed" if (is_eval.get(sid) or is_eval.get(did)) \
                else "train"
            si, di = idx_of(sid), idx_of(did)
            for a, b in ((si, di), (di, si)):
                edges.append({"src": a, "dst": b, "type": et,
                              "weight": 1.0, "features": []})
        self.feature_dim = int(feats.shape[1])
        self.all_edge_type = ["train", "train_removed"]
        self._test_mask = is_test
        return {"nodes": nodes, "edges": edges}


class Mutag(NamedDataset):
    """Graph classification from the TU-Dortmund files MUTAG_A.txt /
    MUTAG_graph_indicator.txt / MUTAG_graph_labels.txt /
    MUTAG_node_labels.txt (reference: mutag.py convert2json +
    multigraph_util.gen_graph_json — 1-based ids, graph label
    max(lbl, 0), per-node 'f1' sparse node label + 'label' dense graph
    label + 'graph_label' binary membership). Delegates to
    MotifDataset's generator when no raw data."""

    name = "mutag"
    feature_dim = 7
    label_dim = 2
    total_size = 3371
    train_rate = 0.9

    def _raw(self, suffix):
        return os.path.join(self.raw_dir, f"MUTAG_{suffix}.txt")

    def has_raw(self):
        return all(os.path.exists(self._raw(s)) for s in
                   ("A", "graph_indicator", "graph_labels", "node_labels"))

    def raw_to_json(self):
        def read_ints(path, split=None):
            with open(path) as f:
                return [line for line in (l.strip() for l in f) if line]

        adj = [tuple(int(x.strip()) - 1 for x in line.split(","))
               for line in read_ints(self._raw("A"))]
        indicator = [int(l) - 1
                     for l in read_ints(self._raw("graph_indicator"))]
        graph_labels = [max(int(l), 0)
                        for l in read_ints(self._raw("graph_labels"))]
        node_labels = [int(l) for l in read_ints(self._raw("node_labels"))]
        nodes = []
        for i, nl in enumerate(node_labels):
            gi = indicator[i]
            nodes.append({
                "id": i, "type": str(nl), "weight": 1.0,
                "features": [
                    {"name": "f1", "type": "sparse", "value": [nl]},
                    {"name": "label", "type": "dense",
                     "value": [float(graph_labels[gi])]},
                    # zero-padded so the store's lexicographic
                    # graph-label order equals the integer order
                    {"name": "graph_label", "type": "binary",
                     "value": f"g{gi:05d}"}]})
        edges = [{"src": s, "dst": d, "type": "0", "weight": 1.0,
                  "features": []} for s, d in adj]
        n_graphs = len(graph_labels)
        # reference id_file: the last (1 - train_rate) of graphs
        self._graph_test_ids = np.arange(
            int(n_graphs * self.train_rate), n_graphs, dtype=np.int32)
        self.total_size = n_graphs
        return {"nodes": nodes, "edges": edges}

    def load_graph(self, device=None, **kw) -> Graph:
        if self.has_raw() or os.path.exists(
                os.path.join(self.data_dir, "meta.json")):
            g = super().load_graph(device, **kw)
            G = (g.tensors.graph_members.shape[0]
                 if g.tensors.graph_members is not None else 0)
            ids = getattr(self, "_graph_test_ids", None)
            self._test_ids = ids if ids is not None else np.arange(
                int(G * self.train_rate), G, dtype=np.int32)
            self.total_size = G
            return g
        inner = MotifDataset(self.raw_dir, n_graphs=80, seed=3)
        self._inner = inner
        g = inner.load_graph(device, **kw)
        self.data_dir = inner.data_dir
        self._test_ids = np.arange(
            g.tensors.graph_members.shape[0] if g.tensors.graph_members is
            not None else 0, dtype=np.int32)
        return g


class _TripleDataset(NamedDataset):
    """KG triple files: train/valid/test.txt of ``head<TAB>rel<TAB>tail``
    (reference: fb15k.py convert2json)."""

    directed = True

    def has_raw(self):
        return os.path.exists(os.path.join(self.raw_dir, "train.txt"))

    def raw_to_json(self):
        ent_of, rel_of = {}, {}
        triples = {"train": [], "valid": [], "test": []}
        for split in triples:
            p = os.path.join(self.raw_dir, f"{split}.txt")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 3:
                        continue
                    h, r, t = parts
                    ent_of.setdefault(h, len(ent_of))
                    ent_of.setdefault(t, len(ent_of))
                    rel_of.setdefault(r, len(rel_of))
                    triples[split].append((ent_of[h], rel_of[r], ent_of[t]))
        nodes = [{"id": i, "type": "train", "weight": 1.0, "features": []}
                 for i in range(len(ent_of))]
        edges = [{"src": h, "dst": t, "type": f"r{r}", "weight": 1.0,
                  "features": []}
                 for h, r, t in triples["train"]]
        self.n_relations = len(rel_of)
        self.label_dim = 0
        self._test_triples = np.asarray(triples["test"] or
                                        triples["train"][:1000], np.int64)
        self._test_mask = None
        return {"nodes": nodes, "edges": edges}

    def synthetic_json(self):
        rng = np.random.default_rng(abs(hash(self.name)) % (2 ** 31))
        n_ent, n_rel, n_tr = 500, 8, 6000
        h = rng.integers(0, n_ent, n_tr)
        r = rng.integers(0, n_rel, n_tr)
        # structured tails so embeddings are learnable
        t = (h + (r + 1) * 13) % n_ent
        nodes = [{"id": int(i), "type": "train", "weight": 1.0,
                  "features": []} for i in range(n_ent)]
        edges = [{"src": int(hi), "dst": int(ti), "type": f"r{ri}",
                  "weight": 1.0, "features": []}
                 for hi, ri, ti in zip(h, r, t)]
        self.n_relations = n_rel
        self._test_triples = np.stack([h[:500], r[:500], t[:500]],
                                      axis=1).astype(np.int64)
        self._test_mask = None
        return {"nodes": nodes, "edges": edges}

    def _triples_file(self):
        return os.path.join(self.data_dir, "test_triples.npy")

    def load_graph(self, device=None, **kw) -> Graph:
        g = super().load_graph(device, **kw)
        # persist the test split next to the converted shards so a FRESH
        # dataset object loading an already-converted dir still has it
        # (raw_to_json/synthetic_json only run on first conversion)
        if getattr(self, "_test_triples", None) is not None and \
                not os.path.exists(self._triples_file()):
            np.save(self._triples_file(), self._test_triples)
        if getattr(self, "_test_triples", None) is None and \
                os.path.exists(self._triples_file()):
            self._test_triples = np.load(self._triples_file())
        return g

    @property
    def test_triples(self) -> np.ndarray:
        if getattr(self, "_test_triples", None) is None:
            self.load_graph(device="cpu")   # for the ids; the graph is dropped
        if getattr(self, "_test_triples", None) is None:
            raise ValueError(
                f"{self.name}: no test_triples.npy beside the converted "
                "shards; delete the euler dir to re-convert")
        return self._test_triples


class FB15K(_TripleDataset):
    name = "fb15k"
    total_size = 14951


class FB15K237(_TripleDataset):
    name = "fb15k237"
    total_size = 14541


class WN18(_TripleDataset):
    name = "wn18"
    total_size = 40943


class ML1M(NamedDataset):
    """MovieLens-1M bipartite user-item graph
    (reference: ml_1m.py — ratings.dat 'user::item::rating::ts')."""

    name = "ml_1m"
    feature_dim = 0
    label_dim = 0
    total_size = 9746
    directed = False

    def has_raw(self):
        return os.path.exists(os.path.join(self.raw_dir, "ratings.dat"))

    def raw_to_json(self):
        users, items = {}, {}
        ratings = []
        with open(os.path.join(self.raw_dir, "ratings.dat"),
                  encoding="latin-1") as f:
            for line in f:
                parts = line.strip().split("::")
                if len(parts) < 3:
                    continue
                u, i, r = parts[0], parts[1], float(parts[2])
                users.setdefault(u, len(users))
                items.setdefault(i, len(items))
                ratings.append((users[u], items[i], r))
        n_u = len(users)
        nodes = [{"id": u, "type": "user", "weight": 1.0, "features": []}
                 for u in range(n_u)]
        nodes += [{"id": n_u + i, "type": "item", "weight": 1.0,
                   "features": []} for i in range(len(items))]
        edges = [{"src": u, "dst": n_u + i, "type": "rate", "weight": r,
                  "features": []} for u, i, r in ratings]
        self.train_edge_type = ["rate"]
        self.all_edge_type = ["rate"]
        self.train_node_type = "user"
        self._test_mask = None
        return {"nodes": nodes, "edges": edges}

    def synthetic_json(self):
        rng = np.random.default_rng(7)
        n_u, n_i, n_r = 300, 200, 5000
        u = rng.integers(0, n_u, n_r)
        i = rng.integers(0, n_i, n_r)
        r = rng.integers(1, 6, n_r).astype(float)
        nodes = [{"id": int(x), "type": "user", "weight": 1.0,
                  "features": []} for x in range(n_u)]
        nodes += [{"id": int(n_u + x), "type": "item", "weight": 1.0,
                   "features": []} for x in range(n_i)]
        edges = [{"src": int(uu), "dst": int(n_u + ii), "type": "rate",
                  "weight": float(rr), "features": []}
                 for uu, ii, rr in zip(u, i, r)]
        self.train_edge_type = ["rate"]
        self.all_edge_type = ["rate"]
        self.train_node_type = "user"
        self._test_mask = None
        return {"nodes": nodes, "edges": edges}


_REGISTRY = {
    "cora": Cora, "citeseer": Citeseer, "pubmed": Pubmed, "ppi": PPI,
    "reddit": Reddit, "mutag": Mutag, "fb15k": FB15K,
    "fb15k237": FB15K237, "wn18": WN18, "ml_1m": ML1M,
}


def get_dataset(name: str, data_dir: Optional[str] = None):
    """reference: tf_euler/python/dataset/utils.py get_dataset."""
    if name == "sbm":
        return SBMDataset(data_dir or os.path.expanduser("~/.euler_tpu_data"))
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; "
                       f"choices: {sorted(_REGISTRY) + ['sbm']}")
    return _REGISTRY[name](data_dir)
