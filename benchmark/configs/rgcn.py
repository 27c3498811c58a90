"""The ``rgcn`` configuration (``rgcn.json``): OGB's full-batch R-GCN over
an ogbn-mag-sized heterogeneous graph, the port's supervised GNN system
(``GNNNet`` over ``WholeDataFlow(layout="rel")`` with per-relation
``RelationConv`` convs and a ``TypedEncoder``, ``SuperviseModel``,
``NodeEstimator``'s ``TrainLoop``), checked against the plain reference
in ``benchmark/reference/rgcn.py``.

The graph is drawn from the configuration's fixed seed at ogbn-mag's
counts (``graph_arrays``), node ids by type in contiguous ranges. The
benchmark's weights are ``emb.<type>`` (the featureless types' tables),
``l<i>.matrix`` [R, F, D_in] (every W_r), ``l<i>.root`` [T, F, D_in] and
``l<i>.root_b`` [T, F] (each type's root linear), then ``out.w``,
``out.b`` and ``head.w``. The check compares every leaf: each W_r, each
root's weight and bias as a leaf of its own, each table whole
(``per_leaf``). The second layer's edge types into other nodes than
papers, and its roots of those types, reach no root's row: their
gradient is exactly zero in both, held by its norm and not by its
direction (``train_gaps``).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import judge, supervised
from benchmark.harness.drive import sub_seed
from benchmark.reference import gnn as ref_gnn
from benchmark.reference import rgcn as ref_rgcn

__all__ = ["build", "check"]


def type_lo(gcfg: dict) -> List[int]:
    """Node type k's ids [lo[k], lo[k + 1])."""
    out = [0]
    for _, count in gcfg["node_types"]:
        out.append(out[-1] + count)
    return out


def relations(gcfg: dict) -> List[tuple]:
    """The example's relations in its order, (name, edge type index,
    reversed): each edge type stored from its target (its messages flow
    into the target, the example's ``adj.t()``), then, where the type is
    not symmetric, from its source (the example's reverse, ``'to'``)."""
    out = []
    for k, et in enumerate(gcfg["edge_types"]):
        out.append((et["name"], k, False))
        if not et.get("symmetric"):
            out.append((f"{et['target']}_to_{et['source']}", k, True))
    return out


def _zipf_ends(rng, count: int, n: int, s: float, perm: np.ndarray
               ) -> np.ndarray:
    """``count`` local ids of a type of ``n`` nodes: Zipf ranks (rank =
    floor(n u^(1 / (1 - s)))) through the type's fixed order ``perm``."""
    rank = np.floor(n * rng.random(count) ** (1.0 / (1.0 - s)))
    return perm[np.minimum(rank.astype(np.int64), n - 1)]


def _pairs(rng, et: dict, sizes: dict) -> tuple:
    """The distinct (source, destination) local id pairs of one published
    edge type, in the order drawn: symmetric types hold unordered pairs
    without self pairs."""
    ns, nd = sizes[et["source"]], sizes[et["target"]]
    zs, zd = et["zipf"]
    ps, pd = rng.permutation(ns), rng.permutation(nd)
    want, sym = et["edges"], bool(et.get("symmetric"))
    keys = np.zeros(0, np.int64)
    while True:
        m = int((want - len(keys)) * 1.2) + 1024
        a = _zipf_ends(rng, m, ns, zs, ps).astype(np.int64)
        b = _zipf_ends(rng, m, nd, zd, pd).astype(np.int64)
        if sym:
            a, b = np.minimum(a, b), np.maximum(a, b)
            keep = a != b
            a, b = a[keep], b[keep]
        keys = np.concatenate([keys, a * nd + b])
        _, first = np.unique(keys, return_index=True)
        first.sort()
        keys = keys[first]
        if len(keys) >= want:
            keys = keys[:want]
            return keys // nd, keys % nd


def graph_arrays(gcfg: dict) -> Dict[str, np.ndarray]:
    """The configuration's fixed graph: for each published edge type its
    distinct pairs (``_pairs``), stored as the relations say (``relations``:
    src is the node that aggregates, dst its neighbour), plus the node
    arrays the store reads; node ids by type in ``type_lo``'s ranges."""
    rng = np.random.default_rng(gcfg["seed"])
    lo = dict(zip([t for t, _ in gcfg["node_types"]], type_lo(gcfg)))
    sizes = dict(gcfg["node_types"])
    pairs = [_pairs(rng, et, sizes) for et in gcfg["edge_types"]]
    src, dst, ety = [], [], []
    for r, (_, k, rev) in enumerate(relations(gcfg)):
        et = gcfg["edge_types"][k]
        a = pairs[k][0] + lo[et["source"]]
        b = pairs[k][1] + lo[et["target"]]
        if et.get("symmetric"):
            a, b = np.concatenate([a, b]), np.concatenate([b, a])
        tgt, nbr = (a, b) if rev else (b, a)
        src.append(tgt.astype(np.int32))
        dst.append(nbr.astype(np.int32))
        ety.append(np.full(len(tgt), r, np.int32))
    src, dst, ety = (np.concatenate(v) for v in (src, dst, ety))
    n = type_lo(gcfg)[-1]
    node_type = np.repeat(np.arange(len(sizes), dtype=np.int32),
                          [c for _, c in gcfg["node_types"]])
    return dict(ext_ids=np.arange(n, dtype=np.int64),
                node_local=np.arange(n, dtype=np.int32),
                node_type=node_type, node_w=np.ones(n, np.float32),
                src=src, dst=dst, etype=ety,
                ew=np.ones(len(src), np.float32),
                eid=np.arange(len(src), dtype=np.int32))


def degree_report(gcfg: dict, arrays: Dict[str, np.ndarray]) -> str:
    """Per relation, its edges and its targets' degree quantiles (50, 90,
    99, 99.9%) and largest degree, over the targets' type."""
    lo, rows = type_lo(gcfg), []
    names = [t for t, _ in gcfg["node_types"]]
    for r, (name, k, rev) in enumerate(relations(gcfg)):
        et = gcfg["edge_types"][k]
        tt = names.index(et["source"] if rev else et["target"])
        sel = arrays["etype"] == r
        deg = np.bincount(arrays["src"][sel] - lo[tt],
                          minlength=lo[tt + 1] - lo[tt])
        q = np.quantile(deg, [0.5, 0.9, 0.99, 0.999])
        rows.append(f"{name} ({int(sel.sum())} edges): degree p50 "
                    f"{q[0]:g}, p90 {q[1]:g}, p99 {q[2]:g}, p99.9 {q[3]:g}, "
                    f"max {int(deg.max())}")
    return "; ".join(rows)


def program_graph(cfg: dict, arrays: Dict[str, np.ndarray], device):
    """The port's ``Graph`` over ``arrays`` with the configuration's packs."""
    from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
    from euler_tpu_torch.graph.store import Graph
    g, d = cfg["graph"], cfg["data"]
    meta = GraphMeta(
        n_nodes=type_lo(g)[-1], n_edges=len(arrays["src"]),
        node_types=tuple(t for t, _ in g["node_types"]),
        edge_types=tuple(name for name, _, _ in relations(g)),
        node_features=(), edge_features=())
    graph = Graph(meta, arrays, packs=tuple(g["packs"]), device=device)
    graph.meta = dataclasses.replace(meta, node_features=(
        FeatureSpec("feature", "dense", d["feature_dim"]),
        FeatureSpec("label", "dense", d["classes"])))
    return graph


def make_data(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The feature type's features [P, D] (normal, the feature dtype) and
    one-hot f32 labels [P, L], on ``device`` from ``seed``."""
    g, d = cfg["graph"], cfg["data"]
    p = dict(g["node_types"])[d["feature_type"]]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    feat = torch.randn((p, d["feature_dim"]), generator=gen, device=device,
                       dtype=supervised.DTYPES[d["feature_dtype"]])
    cls = torch.randint(0, d["classes"], (p,), generator=gen, device=device)
    label = torch.nn.functional.one_hot(cls, d["classes"]).to(torch.float32)
    return dict(feature=feat, label=label)


def tables(cfg: dict) -> List[tuple]:
    """(type name, count) of each type that reads a learned table."""
    return [(t, c) for t, c in cfg["graph"]["node_types"]
            if t != cfg["data"]["feature_type"]]


def weight_shapes(cfg: dict) -> Dict[str, tuple]:
    """The model's weights by the benchmark's names (module docstring)."""
    m, d, g = cfg["model"], cfg["data"], cfg["graph"]
    R, T = len(relations(g)), len(g["node_types"])
    widths = [d["feature_dim"]] + list(m["dims"])
    out = {f"emb.{t}": (c, d["feature_dim"]) for t, c in tables(cfg)}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"l{i}.matrix"] = (R, b, a)
        out[f"l{i}.root"] = (T, b, a)
        out[f"l{i}.root_b"] = (T, b)
    out["out.w"] = (m["dims"][-1], widths[-1])
    out["out.b"] = (m["dims"][-1],)
    out["head.w"] = (d["classes"], m["dims"][-1])
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights from ``seed`` on ``device``: the tables Glorot uniform
    over their shape (the example's ``xavier_uniform_``), the linears
    lecun-normal over their last axis clipped at two deviations (one
    draw), biases zero."""
    shapes = weight_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    lin = {k: s for k, s in shapes.items() if not k.startswith("emb.")}
    total = sum(int(np.prod(s)) for k, s in lin.items()
                if not _is_bias(k, s))
    flat = torch.randn((total,), generator=gen, device=device).clamp_(-2, 2)
    out, off = {}, 0
    for name, s in shapes.items():
        k = int(np.prod(s))
        if name.startswith("emb."):
            bound = (6.0 / (s[0] + s[1])) ** 0.5
            out[name] = (torch.rand(s, generator=gen, device=device) * 2
                         - 1) * bound
        elif _is_bias(name, s):
            out[name] = torch.zeros(s, device=device)
        else:
            std = (1.0 / s[-1]) ** 0.5 / 0.87962566103423978
            out[name] = (flat[off:off + k] * std).reshape(s)
            off += k
    return out


def _is_bias(name: str, shape: tuple) -> bool:
    return len(shape) == 1 or name.endswith("root_b")


def program_names(cfg: dict) -> Dict[str, str]:
    """The benchmark's weight names -> the port's parameter names."""
    parts = {"matrix": "matrix", "root": "root_weight", "root_b": "root_bias"}
    out = {}
    for name in weight_shapes(cfg):
        if name.startswith("emb."):
            out[name] = f"embedder.feature.{name}"
        elif name.startswith("l"):
            layer, part = name[1:].split(".")
            out[name] = f"embedder.convs.{layer}.{parts[part]}"
    out.update({"out.w": "embedder.out_fc.weight",
                "out.b": "embedder.out_fc.bias", "head.w": "head_fc.weight"})
    return out


def per_leaf(leaves: Dict[str, torch.Tensor], cfg: dict
             ) -> Dict[str, torch.Tensor]:
    """The compared leaves: each W_r (``l<i>.rel.<relation>``), each
    type's root weight and bias (``l<i>.root.<type>``,
    ``l<i>.root_b.<type>``); the rest as they are."""
    g = cfg["graph"]
    rels = [name for name, _, _ in relations(g)]
    types = [t for t, _ in g["node_types"]]
    out = {}
    for name, v in leaves.items():
        layer, _, part = name.partition(".")
        if part in ("matrix", "root", "root_b") and layer.startswith("l"):
            keys = rels if part == "matrix" else types
            tag = "rel" if part == "matrix" else part
            for k, key in enumerate(keys):
                out[f"{layer}.{tag}.{key}"] = v[k]
        else:
            out[name] = v
    return out


class Rgcn(supervised.Supervised):
    """``supervised.Supervised`` with R-GCN convs over the typed
    whole-graph blocks, the typed encoder, and this configuration's data
    and weights."""

    def __init__(self, cfg: dict, seed: int, device, graph):
        from euler_tpu_torch.dataflow import WholeDataFlow
        from euler_tpu_torch.estimator import NodeEstimator, RunConfig
        from euler_tpu_torch.models import (GNNNet, SuperviseModel,
                                            TypedEncoder)
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        m, d, t, g = cfg["model"], cfg["data"], cfg["train"], cfg["graph"]
        t0 = time.perf_counter()
        encoder = TypedEncoder(
            [(name, c, "feature" if name == d["feature_type"] else None)
             for name, c in g["node_types"]], d["feature_dim"],
            generator=torch.Generator().manual_seed(0))
        R = len(relations(g))
        net = GNNNet("rgcn", WholeDataFlow(m["layers"], [tuple(range(R))],
                                           add_self_loops=False,
                                           layout="rel"),
                     m["dims"], encoder, in_dim=d["feature_dim"],
                     dtype=supervised.DTYPES[m["activation_dtype"]],
                     device=self.device,
                     generator=torch.Generator().manual_seed(0),
                     conv_kwargs={"num_relations": R, "per_relation": True,
                                  "node_types": len(g["node_types"])})
        self.model = SuperviseModel(net, "label", d["classes"],
                                    device=self.device)
        t1 = time.perf_counter()
        self.data = make_data(cfg, seed, self.device)
        graph.tensors = dataclasses.replace(graph.tensors, meta=graph.meta,
                                            dense_nf=dict(self.data))
        self.graph = graph
        t2 = time.perf_counter()
        self.weights0 = make_weights(cfg, seed, self.device)
        self.names = program_names(cfg)
        params = dict(self.model.named_parameters())
        if set(params) != set(self.names.values()):
            raise RuntimeError(f"the port's parameters {sorted(params)} are "
                               f"not the benchmark's {sorted(self.names)}")
        with torch.no_grad():
            for ours, theirs in self.names.items():
                params[theirs].copy_(self.weights0[ours])
        spl = t["steps_per_loop"]
        self.est = NodeEstimator(self.model, graph, RunConfig(
            batch_size=t["batch"], optimizer=t["optimizer"],
            learning_rate=t["learning_rate"], log_steps=0,
            reservoir_refresh=spl, steps_per_loop=spl), device=self.device)
        self.steps_per_loop = spl
        self.id_range = graph.meta.n_nodes
        self.opt = self.gen = self._loop = None
        self._kept = None
        self._keep_hook = None
        self.setup_parts = {"model": t1 - t0, "data": t2 - t1,
                            "weights, estimator": time.perf_counter() - t2}


def build(cfg: dict, seed: int, device) -> Rgcn:
    """The system of one run: the fixed graph (arrays kept for the
    reference; its degrees printed), then ``seed``'s model, data, weights,
    estimator and loop. A port without the typed pack, conv or encoder
    fails at the first import, before the graph is drawn."""
    from euler_tpu_torch.models import TypedEncoder  # noqa: F401
    from euler_tpu_torch.ops.rel_agg import rel_mean  # noqa: F401
    t0 = time.perf_counter()
    arrays = graph_arrays(cfg["graph"])
    print("degrees: " + degree_report(cfg["graph"], arrays), file=sys.stderr)
    t1 = time.perf_counter()
    graph = program_graph(cfg, arrays, device)
    t2 = time.perf_counter()
    system = Rgcn(cfg, seed, device, graph)
    system.arrays = arrays
    system.setup_parts = dict({"edge arrays": t1 - t0,
                               "program graph": t2 - t1},
                              **system.setup_parts)
    return system


class RgcnReference:
    """The reference's view of one seed: the graph rebuilt from the
    benchmark's arrays (``reference.rgcn.RelGraph``), the seed's data made
    again and the weights the benchmark made; ``fault`` holds
    ``rgcn_embed``'s options for the readings' planted faults (empty:
    the published layer)."""

    def __init__(self, cfg: dict, arrays, seed: int, device,
                 weights0: Dict[str, torch.Tensor],
                 graph: Optional[ref_rgcn.RelGraph] = None):
        ref_gnn.no_tf32()
        self.cfg, self.device = cfg, torch.device(device)
        g = cfg["graph"]
        self.type_lo = type_lo(g)
        self.graph = graph or ref_rgcn.RelGraph(
            arrays["src"], arrays["dst"], arrays["etype"], self.type_lo[-1],
            len(relations(g)), self.device)
        self.data = make_data(cfg, seed, self.device)
        self.weights0 = {k: v.to(self.device, torch.float32)
                         for k, v in weights0.items()}
        self.fault: dict = {}

    def loss(self, w, roots: torch.Tensor, q=ref_gnn.identity
             ) -> torch.Tensor:
        roots = roots.to(self.device).long()
        emb = ref_rgcn.rgcn_embed(
            w, self.data["feature"], [t for t, _ in tables(self.cfg)],
            self.graph, self.type_lo, self.cfg["model"]["layers"], q,
            **self.fault)[roots]
        label = self.data["label"][roots]
        return ref_gnn.sigmoid_xent_loss(emb @ w["head.w"].T, label,
                                         torch.ones_like(roots,
                                                         dtype=torch.bool))

    def follow(self, rec: dict, q=ref_gnn.identity) -> dict:
        """The reference's own steps on the program's roots; the compared
        leaves (``per_leaf``)."""
        out = ref_gnn.train_steps(
            self.weights0, self.cfg["train"]["learning_rate"],
            lambda w, i: self.loss(w, rec["roots"][i], q), len(rec["loss"]))
        out["weights0"] = self.weights0
        return dict(out, **{k: per_leaf(out[k], self.cfg)
                            for k in ("grad1", "weights", "weights0")})


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``judge.train_gaps``'s numbers over every leaf: ``grad_gap`` and
    ``update_gap`` by each leaf's norm, ``grad_dir_gap`` over the leaves
    whose reference gradient is not exactly zero (a zero has no
    direction; the module docstring says which leaves)."""
    out = judge.train_gaps(prog, ref)
    keep = list(ref["grad1"])
    turned = [k for k in keep if float(ref["grad1"][k].abs().max()) > 0]

    def grads(d):
        return {k: d["grad1"][k].cpu() for k in keep}

    def moves(d):
        return {k: d["weights"][k].cpu() - d["weights0"][k].cpu()
                for k in keep}
    out.update(grad_gap=judge.norm_gap(grads(prog), grads(ref), keep),
               grad_dir_gap=judge.direction_gap(grads(prog), grads(ref),
                                                turned),
               update_gap=judge.norm_gap(moves(prog), moves(ref), keep))
    return out


def check_train(ref: RgcnReference, rec: dict) -> Dict[str, float]:
    """The compared numbers of a whole-graph cell, every leaf compared
    (``train_gaps``), and the roots."""
    prog = dict(loss=rec["loss"], grad1=per_leaf(rec["grad1"], ref.cfg),
                weights0=per_leaf(rec["weights0"], ref.cfg),
                weights=per_leaf(rec["weights_after"], ref.cfg))
    out = train_gaps(prog, ref.follow(rec))
    every = torch.arange(ref.cfg["train"]["batch"], dtype=torch.int32)
    out["root_misses"] = float(sum(
        every.shape[0] if r.shape != every.shape
        else int((r != every).sum()) for r in rec["roots"]))
    return out


def check(cfg: dict, seed: int, device, handed: dict, evidence: dict
          ) -> Dict[str, float]:
    """The compared numbers of one run: the reference over the
    benchmark's inputs (``handed`` by ``Rgcn.release``) follows the
    program's first steps (``evidence["steps"]``)."""
    ref = RgcnReference(cfg, handed["arrays"], seed, device,
                        handed["weights0"])
    return check_train(ref, evidence["steps"])
