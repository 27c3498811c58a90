"""Fast in-memory random graph construction (benchmark scale).

A copy of euler_tpu/datasets/random_graph.py: the same seeded numpy draws
build the converter's array dict directly, so the port's graph equals the
reference's for the same arguments.
"""
from __future__ import annotations

import numpy as np

from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import PACKS, Graph


def random_graph(n_nodes: int, avg_degree: int, feat_dim: int = 0,
                 n_classes: int = 0, num_edge_types: int = 1,
                 seed: int = 0, weighted: bool = True,
                 build_in_edges: bool = False, packs=PACKS,
                 device=None) -> Graph:
    """Uniform random multigraph with optional dense features/labels;
    ``build_in_edges`` adds the in-CSR (``GraphMeta.has_in_edges``)."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, m).astype(np.int32)
    dst = rng.integers(0, n_nodes, m).astype(np.int32)
    etype = rng.integers(0, num_edge_types, m).astype(np.int32)
    ew = (rng.random(m).astype(np.float32) + 0.1) if weighted else \
        np.ones(m, np.float32)

    node_features = []
    arrays = dict(
        ext_ids=np.arange(n_nodes, dtype=np.int64),
        node_local=np.arange(n_nodes, dtype=np.int32),
        node_type=np.zeros(n_nodes, np.int32),
        node_w=np.ones(n_nodes, np.float32),
        src=src, dst=dst, etype=etype, ew=ew,
        eid=np.arange(m, dtype=np.int32),
    )
    if feat_dim:
        node_features.append(FeatureSpec("feature", "dense", feat_dim))
        arrays["nf_d:feature"] = rng.normal(
            0, 1, (n_nodes, feat_dim)).astype(np.float32)
    if n_classes:
        node_features.append(FeatureSpec("label", "dense", n_classes))
        lab = np.zeros((n_nodes, n_classes), np.float32)
        lab[np.arange(n_nodes), rng.integers(0, n_classes, n_nodes)] = 1
        arrays["nf_d:label"] = lab

    meta = GraphMeta(
        n_nodes=n_nodes, n_edges=m,
        node_types=("n",), edge_types=tuple(str(i) for i in
                                            range(num_edge_types)),
        node_features=tuple(node_features), edge_features=(),
        has_in_edges=build_in_edges)
    return Graph(meta, arrays, packs=packs, device=device)
