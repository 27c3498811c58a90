"""The system under test of the supervised GNN configurations: the port's
graph, model, estimator and ``TrainLoop``, built from a configuration file
and a seed through the port's public constructors.

The benchmark makes every input itself and hands the same to the program
and to the plain reference: the graph's edge arrays (numpy, from the
configuration's fixed graph seed, as Euler's bench builds its random
graph), the bfloat16 features and one-hot labels and the model's weights
(on the device, from ``--seed``). What the program derives from them (its
CSR, alias tables, fan and ELL packs) stays the program's; the reference
works it out again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness.drive import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def edge_count(gcfg: dict) -> int:
    """Edges of the configuration's graph: ``edges`` drawn pairs, each
    also reversed where the graph is ``symmetric``."""
    return gcfg["edges"] * (2 if gcfg.get("symmetric") else 1)


def graph_arrays(gcfg: dict) -> Dict[str, np.ndarray]:
    """The configuration's fixed graph: ``edges`` pairs with uniform
    endpoints and types and weights uniform in [weight_low,
    weight_high), drawn as Euler's bench draws its random graph, each
    pair also stored reversed (same type and weight) where the graph is
    ``symmetric``, plus the node arrays the store reads."""
    n, m = gcfg["nodes"], gcfg["edges"]
    rng = np.random.default_rng(gcfg["seed"])
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    etype = rng.integers(0, gcfg["edge_types"], m).astype(np.int32)
    lo, hi = gcfg["weight_low"], gcfg["weight_high"]
    ew = (rng.random(m).astype(np.float32) * np.float32(hi - lo)
          + np.float32(lo))
    if gcfg.get("symmetric"):
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        etype, ew = np.concatenate([etype, etype]), np.concatenate([ew, ew])
    return dict(ext_ids=np.arange(n, dtype=np.int64),
                node_local=np.arange(n, dtype=np.int32),
                node_type=np.zeros(n, np.int32),
                node_w=np.ones(n, np.float32),
                src=src, dst=dst, etype=etype, ew=ew,
                eid=np.arange(len(src), dtype=np.int32))


def program_graph(cfg: dict, arrays: Dict[str, np.ndarray], device):
    """The port's ``Graph`` over ``arrays`` with the configuration's packs
    (this builds the program's CSR, alias tables and packs)."""
    from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
    from euler_tpu_torch.graph.store import Graph
    g, d = cfg["graph"], cfg["data"]
    meta = GraphMeta(
        n_nodes=g["nodes"], n_edges=len(arrays["src"]), node_types=("n",),
        edge_types=tuple(str(i) for i in range(g["edge_types"])),
        node_features=(), edge_features=())
    graph = Graph(meta, arrays, packs=tuple(g["packs"]), device=device)
    # the features arrive per seed (``Supervised``), on the device
    graph.meta = dataclasses.replace(meta, node_features=(
        FeatureSpec("feature", "dense", d["feature_dim"]),
        FeatureSpec("label", "dense", d["classes"])))
    return graph


def make_data(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Features [N, D] in the configuration's feature dtype (normal) and
    one-hot f32 labels [N, L], on ``device`` from ``seed``: the same seed
    gives the same tensors."""
    n, d = cfg["graph"]["nodes"], cfg["data"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    feat = torch.randn((n, d["feature_dim"]), generator=gen, device=device,
                       dtype=DTYPES[d["feature_dtype"]])
    cls = torch.randint(0, d["classes"], (n,), generator=gen, device=device)
    label = torch.nn.functional.one_hot(cls, d["classes"]).to(torch.float32)
    return dict(feature=feat, label=label)


def weight_shapes(cfg: dict) -> Dict[str, tuple]:
    """The model's weights by the benchmark's own names, [out, in] as
    ``nn.Linear`` holds them: per conv layer ``l<i>.self``/``l<i>.neigh``
    (sage) or ``l<i>.fc`` (gcn), then ``out.w``, ``out.b`` and
    ``head.w``."""
    m, d = cfg["model"], cfg["data"]
    widths = [d["feature_dim"]] + list(m["dims"])
    out = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        parts = ("self", "neigh") if m["conv"] == "sage" else ("fc",)
        for p in parts:
            out[f"l{i}.{p}"] = (b, a)
    out["out.w"] = (m["dims"][-1], widths[-1])
    out["out.b"] = (m["dims"][-1],)
    out["head.w"] = (d["classes"], m["dims"][-1])
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights from ``seed`` on ``device`` in one draw: kernels
    lecun-normal (flax's Dense default scale) clipped at two deviations,
    biases zero."""
    shapes = weight_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn((total,), generator=gen, device=device).clamp_(-2, 2)
    out, off = {}, 0
    for name, s in shapes.items():
        k = int(np.prod(s))
        if len(s) == 1:
            out[name] = torch.zeros(s, device=device)
        else:
            std = (1.0 / s[1]) ** 0.5 / 0.87962566103423978
            out[name] = (flat[off:off + k] * std).reshape(s)
        off += k
    return out


def program_names(cfg: dict) -> Dict[str, str]:
    """The benchmark's weight names -> the port's parameter names."""
    if cfg["model"]["conv"] not in ("sage", "gcn"):
        raise ValueError(f"no weights for conv {cfg['model']['conv']!r}")
    parts = {"self": "self_fc", "neigh": "neigh_fc", "fc": "fc"}
    out = {}
    for name in weight_shapes(cfg):
        if name.startswith("l"):
            layer, part = name[1:].split(".")
            out[name] = f"embedder.convs.{layer}.{parts[part]}.weight"
    out.update({"out.w": "embedder.out_fc.weight",
                "out.b": "embedder.out_fc.bias", "head.w": "head_fc.weight"})
    return out


class Supervised:
    """One seed's system: the port's ``SuperviseModel`` over its graph,
    with the benchmark's data and weights and a ``NodeEstimator``; for the
    training cells Adam and a ``TrainLoop`` of ``steps_per_loop`` steps
    (``loop``); and the hooks that record what the correctness check
    reads.

    ``graph`` is a port ``Graph`` built by ``program_graph`` (shared by
    every seed of one process); its features and labels are replaced by
    this seed's."""

    def __init__(self, cfg: dict, seed: int, device, graph):
        from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
        from euler_tpu_torch.estimator import NodeEstimator, RunConfig
        from euler_tpu_torch.models import (GNNNet, ShallowEncoder,
                                            SuperviseModel)
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        m, d, t = cfg["model"], cfg["data"], cfg["train"]
        t0 = time.perf_counter()
        self.data = make_data(cfg, seed, self.device)
        t1 = time.perf_counter()
        meta = graph.meta
        graph.tensors = dataclasses.replace(graph.tensors, meta=meta,
                                            dense_nf=dict(self.data))
        self.graph = graph
        if m["flow"] == "sampled":
            flow = SageDataFlow(m["fanouts"], [(0,)] * len(m["fanouts"]))
        else:
            flow = WholeDataFlow(m["layers"], [(0,)])
        net = GNNNet(m["conv"], flow, m["dims"], ShallowEncoder(("feature",)),
                     in_dim=d["feature_dim"],
                     dtype=DTYPES[m["activation_dtype"]], device=self.device,
                     generator=torch.Generator().manual_seed(0))
        self.model = SuperviseModel(net, "label", d["classes"],
                                    device=self.device)
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
        self._kept: Optional[List[torch.Tensor]] = None
        self._keep_hook = None
        self.setup_parts = {"data": t1 - t0, "model": t2 - t1,
                            "weights, estimator": time.perf_counter() - t2}

    @property
    def loop(self):
        """The training cells' ``TrainLoop`` (Adam, the train generator,
        the roots feed), made at first use: an inference cell makes no
        optimizer (its first construction imports much of torch)."""
        if self._loop is None:
            from euler_tpu_torch.estimator import TrainLoop, get_optimizer
            t = self.cfg["train"]
            self.opt = get_optimizer(t["optimizer"], t["learning_rate"],
                                     self.model.parameters())
            self.gen = torch.Generator(device=self.device).manual_seed(
                sub_seed(self.seed, "train"))
            g, gen, est = self.graph.tensors, self.gen, self.est
            if self.cfg["model"]["flow"] == "sampled":
                def roots():
                    return est.train_batch(g, gen)
            else:
                # the first ``batch`` nodes, every node computed
                every = torch.arange(t["batch"], dtype=torch.int32,
                                     device=self.device)

                def roots():
                    return every
            self._loop = TrainLoop(est, self.opt, gen, self.steps_per_loop,
                                   roots)
        return self._loop

    # ---- the window's call -------------------------------------------------
    def run_loop(self) -> torch.Tensor:
        """One loop as users run it (bench.py's ``run_loop``): a redraw of
        the fan reservoir where the graph has fan rows, then the
        ``TrainLoop``'s steps. Returns the last step's loss."""
        from euler_tpu_torch.ops import sampling
        loop = self.loop
        g = self.graph.tensors
        if g.fan_pack is not None:
            sampling.refresh_fan_pack(g, self.gen)
        return loop()

    def serve(self, ids: np.ndarray, keep: bool = False):
        """One request through ``NodeEstimator.infer``: its embeddings in
        host memory and, where ``keep``, what the check needs of it (the
        deepest block's source ids of each batch it ran in, copied on the
        card as the forward runs; ``None`` otherwise)."""
        if self._keep_hook is None:
            def conv(mod, args, out):
                if self._kept is not None:
                    self._kept.append(args[1].n_id.detach().clone())
            self._keep_hook = \
                self.model.embedder.convs[0].register_forward_hook(conv)
        self._kept = [] if keep else None
        try:
            answer = self.est.infer(ids)
            kept = self._kept
        finally:
            self._kept = None
        return answer, (None if kept is None else {"n_ids": kept})

    # ---- records ------------------------------------------------------------
    def param(self, name: str) -> torch.Tensor:
        return dict(self.model.named_parameters())[self.names[name]]

    def record_draws(self) -> Tuple[List[dict], Callable[[], None]]:
        """Hooks that append, at each forward of the model, a dict with the
        roots it got, the deepest block's source ids (a sampled flow's
        draws of every hop) and its loss; returns (entries, remove)."""
        entries: List[dict] = []

        def pre(mod, args):
            entries.append({"roots": args[1]})

        def conv(mod, args, out):
            entries[-1]["n_id"] = args[1].n_id

        def post(mod, args, out):
            entries[-1]["loss"] = out["loss"]
        handles = [self.model.register_forward_pre_hook(pre),
                   self.model.embedder.convs[0].register_forward_hook(conv),
                   self.model.register_forward_hook(post)]

        def remove():
            for h in handles:
                h.remove()
        return entries, remove

    def first_steps(self, n: int) -> dict:
        """Drive the window's ``TrainLoop`` through its first ``n`` steps,
        one call a step (on the card: the eager warm-up step with the
        capture, then replays), after one reservoir redraw, and record
        for the reference: the weights before, each step's roots and draws
        (read by forward hooks: on the card the replays write the tensors
        that the capture's forward got), each step's loss (the first, an
        eager step, read by a hook, as the call that captures returns the
        captured loss before any replay; later ones the copy the loop
        returns), the first gradient as Adam holds it after step 1
        (``exp_avg / (1 - beta1)``) and the weights after step ``n``."""
        from euler_tpu_torch.ops import sampling
        loop = self.loop
        sampled = self.cfg["model"]["flow"] == "sampled"
        g = self.graph.tensors
        if g.fan_pack is not None:
            sampling.refresh_fan_pack(g, self.gen)
        entries, remove = self.record_draws()
        rec = {"roots": [], "n_id": [], "loss": []}
        loop.steps = 1
        try:
            for i in range(n):
                loss = loop()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                e = entries[0] if i == 0 else entries[-1]
                rec["roots"].append(e["roots"].detach().cpu().clone())
                rec["n_id"].append(e["n_id"].detach().cpu().clone()
                                   if sampled else None)
                rec["loss"].append(float(e["loss"].detach() if i == 0
                                         else loss))
                if i == 0:
                    beta1 = self.opt.defaults["betas"][0]
                    rec["grad1"] = {}
                    for name in self.names:
                        st = self.opt.state.get(self.param(name), {})
                        m1 = st.get("exp_avg")
                        rec["grad1"][name] = (
                            torch.zeros_like(self.param(name)).cpu()
                            if m1 is None else (m1 / (1 - beta1)).cpu())
        finally:
            loop.steps = self.steps_per_loop
            remove()
        rec["weights_after"] = {k: self.param(k).detach().cpu().clone()
                                for k in self.names}
        rec["weights0"] = {k: v.cpu() for k, v in self.weights0.items()}
        return rec

    def release(self) -> dict:
        """Drop the program's state, so that the reference can use the
        card's memory, and hand back the benchmark's own inputs: the
        edge arrays and the weights it made (on the host)."""
        handed = {"arrays": getattr(self, "arrays", None),
                  "weights0": {k: v.cpu() for k, v in self.weights0.items()}}
        if self._keep_hook is not None:
            self._keep_hook.remove()
        for k in ("_loop", "est", "opt", "model", "graph", "data",
                  "weights0", "_keep_hook"):
            setattr(self, k, None)
        return handed


def build_graph(cfg: dict, device):
    """(arrays, the port's graph) of a configuration."""
    arrays = graph_arrays(cfg["graph"])
    return arrays, program_graph(cfg, arrays, device)


def build(cfg: dict, seed: int, device) -> Supervised:
    """The system of a supervised GNN configuration for one run: its
    fixed graph (arrays kept for the reference), then ``seed``'s data,
    weights, model, estimator and loop."""
    t0 = time.perf_counter()
    arrays = graph_arrays(cfg["graph"])
    t1 = time.perf_counter()
    graph = program_graph(cfg, arrays, device)
    t2 = time.perf_counter()
    system = Supervised(cfg, seed, device, graph)
    system.arrays = arrays
    system.setup_parts = dict({"edge arrays": t1 - t0,
                               "program graph": t2 - t1},
                              **system.setup_parts)
    return system
