"""The graph-classification stand-in of euler_tpu/datasets/synthetic.py.

``motif_graph`` builds in memory the graph that the reference's
``MotifDataset`` writes and loads (``motif_graphs_json`` through the JSON
converter): the same seeded numpy draws in the same order, so the two
graphs are equal. Class 0 graphs are cycles, class 1 near-cliques; each
node carries a 4-wide ``feature``, its graph's class as the 1-wide
``label`` and its graph as the ``graph_label`` binary feature.
"""
from __future__ import annotations

import numpy as np

from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import PACKS, Graph

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
