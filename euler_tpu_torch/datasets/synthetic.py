"""Synthetic graphs: hermetic stand-ins for downloads, copies of
euler_tpu/datasets/synthetic.py.

``sbm_graph_json`` (a stochastic block model with class-correlated
features and a train/test node split) and ``motif_graphs_json`` (cycles
against near-cliques, the graph-classification toy set) give euler-schema
JSON graphs; ``SBMDataset`` and ``MotifDataset`` convert one on first use
under their ``data_dir`` and load it, with the reference's dataset
contract (reference: tf_euler/python/dataset/cora.py:33-49).

``motif_graph`` builds in memory the graph that ``MotifDataset`` writes
and loads: the same seeded numpy draws in the same order, so the two
graphs are equal. Class 0 graphs are cycles, class 1 near-cliques; each
node carries a 4-wide ``feature``, its graph's class as the 1-wide
``label`` and its graph as the ``graph_label`` binary feature.
"""
from __future__ import annotations

import os

import numpy as np

from euler_tpu_torch.graph.convert import convert_json_graph
from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import PACKS, Graph, load_graph

#: MotifDataset's metadata contract
MOTIF_FEATURE_DIM, MOTIF_CLASSES = 4, 2


def motif_graph(n_graphs: int = 60, min_nodes: int = 6, max_nodes: int = 12,
                seed: int = 0, packs=PACKS, device=None) -> Graph:
    """``n_graphs`` graphs of ``min_nodes``..``max_nodes`` nodes (graph i
    of class i % 2), on ``device``."""
    rng = np.random.default_rng(seed)
    feats, labels, graph_label, src, dst = [], [], [], [], []
    nid = 0
    for gi in range(n_graphs):
        cls = gi % 2
        n = int(rng.integers(min_nodes, max_nodes + 1))
        ids = list(range(nid, nid + n))
        nid += n
        for _ in ids:
            feats.append(rng.normal(0, 1, 4))
            labels.append(float(cls))
            graph_label.append(f"g{gi:05d}")
        pairs = set()
        if cls == 0:
            for i in range(n):
                pairs.add((ids[i], ids[(i + 1) % n]))
        else:
            for i in range(n):
                for j in range(i + 1, n):
                    if rng.random() < 0.8:
                        pairs.add((ids[i], ids[j]))
        for s, d in pairs:
            src += [s, d]
            dst += [d, s]
    m = len(src)
    arrays = {
        "ext_ids": np.arange(nid, dtype=np.int64),
        "node_local": np.arange(nid, dtype=np.int32),
        "node_type": np.zeros(nid, np.int32),
        "node_w": np.ones(nid, np.float32),
        "src": np.asarray(src, np.int32), "dst": np.asarray(dst, np.int32),
        "etype": np.zeros(m, np.int32), "ew": np.ones(m, np.float32),
        "eid": np.arange(m, dtype=np.int32),
        "nf_d:feature": np.asarray(feats, np.float32),
        "nf_d:label": np.asarray(labels, np.float32)[:, None],
        "nf_bin:graph_label": np.asarray(graph_label, dtype=object),
    }
    meta = GraphMeta(
        n_nodes=nid, n_edges=m, node_types=("n",), edge_types=("l",),
        node_features=(FeatureSpec("feature", "dense", MOTIF_FEATURE_DIM),
                       FeatureSpec("graph_label", "binary", 0),
                       FeatureSpec("label", "dense", 1)),
        edge_features=(), has_in_edges=True, part_edge_counts=(m,))
    return Graph(meta, arrays, packs=packs, device=device)


def sbm_graph_json(n_nodes=400, n_classes=4, p_in=0.08, p_out=0.005,
                   feat_dim=16, feat_noise=0.8, seed=0,
                   train_frac=0.7):
    """Stochastic block model with class-correlated Gaussian features.

    Node features: one-hot(community)*2 + noise; label = one-hot community.
    Node types: 'train' / 'test' split so NodeEstimator's
    sample_node(train_node_type) contract works like the planetoid sets.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_classes, n_nodes)
    centers = rng.normal(0, 1.0, (n_classes, feat_dim))
    feats = centers[comm] + rng.normal(0, feat_noise, (n_nodes, feat_dim))
    is_train = rng.random(n_nodes) < train_frac

    nodes = []
    for i in range(n_nodes):
        label = np.zeros(n_classes, np.float32)
        label[comm[i]] = 1.0
        nodes.append({
            "id": i,
            "type": "train" if is_train[i] else "test",
            "weight": 1.0,
            "features": [
                {"name": "feature", "type": "dense",
                 "value": feats[i].tolist()},
                {"name": "label", "type": "dense", "value": label.tolist()},
            ],
        })

    edges = []
    # expected-degree sampling (sparse-friendly)
    probs = np.where(comm[:, None] == comm[None, :], p_in, p_out)
    upper = np.triu(rng.random((n_nodes, n_nodes)) < probs, 1)
    src, dst = np.nonzero(upper)
    for s, d in zip(src, dst):
        edges.append({"src": int(s), "dst": int(d), "type": "link",
                      "weight": 1.0})
        edges.append({"src": int(d), "dst": int(s), "type": "link",
                      "weight": 1.0})
    return {"nodes": nodes, "edges": edges}, comm, is_train


def motif_graphs_json(n_graphs=60, min_nodes=6, max_nodes=12, seed=0):
    """Graph-classification toy set: class 0 = cycle graphs, class 1 =
    near-clique graphs (a mutag-role stand-in). Each node carries the
    graph's id via the 'graph_label' binary feature (the reference's
    convention, get_graph_by_label_op.cc) and the class via a 'label'
    dense feature on every member node."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    nid = 0
    for gi in range(n_graphs):
        cls = gi % 2
        n = int(rng.integers(min_nodes, max_nodes + 1))
        ids = list(range(nid, nid + n))
        nid += n
        for v in ids:
            nodes.append({
                "id": v, "type": "n", "weight": 1.0,
                "features": [
                    {"name": "feature", "type": "dense",
                     "value": rng.normal(0, 1, 4).tolist()},
                    {"name": "label", "type": "dense", "value": [float(cls)]},
                    {"name": "graph_label", "type": "binary",
                     "value": f"g{gi:05d}"},
                ]})
        pair_set = set()
        if cls == 0:  # cycle
            for i in range(n):
                pair_set.add((ids[i], ids[(i + 1) % n]))
        else:  # near-clique
            for i in range(n):
                for j in range(i + 1, n):
                    if rng.random() < 0.8:
                        pair_set.add((ids[i], ids[j]))
        for s, d in pair_set:
            edges.append({"src": s, "dst": d, "type": "l", "weight": 1.0})
            edges.append({"src": d, "dst": s, "type": "l", "weight": 1.0})
    return {"nodes": nodes, "edges": edges}


class MotifDataset:
    """Graph-classification dataset contract (mutag stand-in)."""

    name = "motif"

    def __init__(self, data_dir: str, n_graphs=60, seed=0):
        self.data_dir = os.path.join(data_dir, f"motif_{n_graphs}")
        self.n_graphs = n_graphs
        self.seed = seed
        self.total_size = n_graphs
        self.num_classes = 2
        self.label_idx = "label"
        self.feature_idx = "feature"
        self.feature_dim = 4
        self.train_edge_type = ["l"]
        self.all_edge_type = ["l"]

    def load_graph(self, device=None, **kw) -> Graph:
        """Convert on first use, then ``load_graph(data_dir, device=,
        **kw)``."""
        if not os.path.exists(os.path.join(self.data_dir, "meta.json")):
            convert_json_graph(motif_graphs_json(self.n_graphs,
                                                 seed=self.seed),
                               self.data_dir)
        return load_graph(self.data_dir, device=device, **kw)


class SBMDataset:
    """Dataset-contract wrapper over the SBM generator."""

    name = "sbm"

    def __init__(self, data_dir: str, n_nodes=400, n_classes=4,
                 feat_dim=16, seed=0, **kw):
        self.data_dir = os.path.join(data_dir, f"sbm_{n_nodes}_{n_classes}")
        self.n_nodes = n_nodes
        self.n_classes = n_classes
        self.feat_dim = feat_dim
        self.seed = seed
        self.kw = kw
        # metadata contract (reference: cora.py:33-49)
        self.max_node_id = n_nodes - 1
        self.total_size = n_nodes
        self.train_node_type = "train"
        self.all_node_type = -1
        self.train_edge_type = ["link"]
        self.all_edge_type = ["link"]
        self.feature_idx = "feature"
        self.feature_dim = feat_dim
        self.label_idx = "label"
        self.label_dim = n_classes
        self._test_ids = None

    def load_graph(self, device=None, **kw) -> Graph:
        """Generate and convert on first use, then ``load_graph(data_dir,
        device=, **kw)``."""
        if not os.path.exists(os.path.join(self.data_dir, "meta.json")):
            g_json, comm, is_train = sbm_graph_json(
                self.n_nodes, self.n_classes, feat_dim=self.feat_dim,
                seed=self.seed, **self.kw)
            convert_json_graph(g_json, self.data_dir)
            np.save(os.path.join(self.data_dir, "test_ids.npy"),
                    np.nonzero(~is_train)[0].astype(np.int32))
        self._test_ids = np.load(os.path.join(self.data_dir, "test_ids.npy"))
        return load_graph(self.data_dir, device=device, **kw)

    @property
    def test_ids(self):
        if self._test_ids is None:
            self.load_graph(device="cpu")   # for the ids; the graph is dropped
        return self._test_ids
