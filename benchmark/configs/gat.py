"""The ``gat`` configuration (``gat.json``): multi-head GAT over the whole
graph, the port's supervised GNN system of ``harness.supervised`` with
``GATConv(heads=H)`` convs, checked as ``harness.judge`` checks the gcn
configuration, against the plain reference in
``benchmark/reference/gat.py``.

The benchmark's weights are ``l<i>.fc`` [H * F, D_in] (every head's
W^k), ``l<i>.attn_l`` and ``l<i>.attn_r`` [H, F] (a_l^k, a_r^k), then
``out.w``, ``out.b`` and ``head.w``. The check compares every W^k as a
leaf of its own (``l<i>.fc.h<k>``) and a layer's attention vectors as two
leaves (``l<i>.attn_l``, ``l<i>.attn_r``, their H heads together), and
every leaf (``train_gaps``): none is left out as tiny. a_l's gradient
comes only through LeakyReLU's kink (the softmax over a node's edges does
not see a shift of el_i): it is the small rest of sums that cancel, one
head's down to 1e-5 of the median leaf's, so bfloat16 round-off turns its
direction by amounts with a heavy tail over seeds (PERF.md §2). The a_l
leaves are held by their norms (``grad_gap``, ``update_gap``) and not by
their direction (``grad_dir_gap``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import judge, supervised
from benchmark.harness.drive import sub_seed
from benchmark.reference import gat as ref_gat
from benchmark.reference.gnn import identity

__all__ = ["build", "check"]


def weight_shapes(cfg: dict) -> Dict[str, tuple]:
    """The model's weights by the benchmark's names (module docstring),
    [out, in] as ``nn.Linear`` holds them."""
    m, d = cfg["model"], cfg["data"]
    H = m["heads"]
    widths = [d["feature_dim"]] + list(m["dims"])
    out = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"l{i}.fc"] = (b, a)
        out[f"l{i}.attn_l"] = (H, b // H)
        out[f"l{i}.attn_r"] = (H, b // H)
    out["out.w"] = (m["dims"][-1], widths[-1])
    out["out.b"] = (m["dims"][-1],)
    out["head.w"] = (d["classes"], m["dims"][-1])
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights from ``seed`` on ``device`` in one draw, as
    ``supervised.make_weights`` draws them: lecun-normal over the last
    axis (fan-in F for the attention vectors), clipped at two deviations,
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
    out = {}
    for name in weight_shapes(cfg):
        if name.startswith("l"):
            layer, part = name[1:].split(".")
            out[name] = (f"embedder.convs.{layer}."
                         + ("fc.weight" if part == "fc" else part))
    out.update({"out.w": "embedder.out_fc.weight",
                "out.b": "embedder.out_fc.bias", "head.w": "head_fc.weight"})
    return out


def per_head(leaves: Dict[str, torch.Tensor], heads: int
             ) -> Dict[str, torch.Tensor]:
    """The compared leaves: ``l<i>.fc`` as H blocks of rows, W^k, each
    ``l<i>.fc.h<k>``; the rest as they are."""
    out = {}
    for name, v in leaves.items():
        if name.endswith(".fc"):
            for k, part in enumerate(v.chunk(heads, dim=0)):
                out[f"{name}.h{k}"] = part
        else:
            out[name] = v
    return out


class Gat(supervised.Supervised):
    """``supervised.Supervised`` with multi-head GAT convs
    (``GNNNet("gat", ..., conv_kwargs={"heads": H})``) over the whole
    graph's ELL blocks, and this configuration's weights."""

    def __init__(self, cfg: dict, seed: int, device, graph):
        from euler_tpu_torch.dataflow import WholeDataFlow
        from euler_tpu_torch.estimator import NodeEstimator, RunConfig
        from euler_tpu_torch.models import (GNNNet, ShallowEncoder,
                                            SuperviseModel)
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        m, d, t = cfg["model"], cfg["data"], cfg["train"]
        t0 = time.perf_counter()
        net = GNNNet("gat", WholeDataFlow(m["layers"], [(0,)]), m["dims"],
                     ShallowEncoder(("feature",)), in_dim=d["feature_dim"],
                     dtype=supervised.DTYPES[m["activation_dtype"]],
                     device=self.device,
                     generator=torch.Generator().manual_seed(0),
                     conv_kwargs={"heads": m["heads"]})
        self.model = SuperviseModel(net, "label", d["classes"],
                                    device=self.device)
        t1 = time.perf_counter()
        self.data = supervised.make_data(cfg, seed, self.device)
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


def build(cfg: dict, seed: int, device) -> Gat:
    """The system of one run: the fixed graph (arrays kept for the
    reference), then ``seed``'s model (a port without multi-head GAT
    fails there, a few seconds in), data, weights, estimator and loop."""
    t0 = time.perf_counter()
    arrays = supervised.graph_arrays(cfg["graph"])
    t1 = time.perf_counter()
    graph = supervised.program_graph(cfg, arrays, device)
    t2 = time.perf_counter()
    system = Gat(cfg, seed, device, graph)
    system.arrays = arrays
    system.setup_parts = dict({"edge arrays": t1 - t0,
                               "program graph": t2 - t1},
                              **system.setup_parts)
    return system


class GatReference(judge.Reference):
    """``judge.Reference`` with the GAT forward of
    ``reference/gat.py``; ``fault`` holds ``attend``'s options for the
    readings' planted faults (empty: the published layer). ``follow``
    returns the compared leaves (``per_head``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fault: dict = {}

    def embed(self, w, roots: torch.Tensor, n_id, q=identity
              ) -> torch.Tensor:
        m = self.cfg["model"]
        return ref_gat.gat_embed(w, self.data["feature"], self.graph.src,
                                 self.graph.dst, m["layers"], m["heads"], q,
                                 **self.fault)[roots.long()]

    def follow(self, rec: dict, q=identity, valid=None) -> dict:
        out = super().follow(rec, q, valid)
        H = self.cfg["model"]["heads"]
        return dict(out, **{k: per_head(out[k], H)
                            for k in ("grad1", "weights", "weights0")})


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``judge.train_gaps`` with ``grad_gap`` and ``update_gap`` over every
    leaf of ``ref["grad1"]``, the tiny ones too, and ``grad_dir_gap`` over
    every leaf but the a_l ones (module docstring)."""
    out = judge.train_gaps(prog, ref)
    keep = list(ref["grad1"])
    turned = [k for k in keep if not k.endswith(".attn_l")]

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


def check_train(ref: GatReference, rec: dict) -> Dict[str, float]:
    """``judge.check_train``'s numbers of a whole-graph cell, the leaves a
    head at a time, every leaf compared (``train_gaps``)."""
    H = ref.cfg["model"]["heads"]
    prog = dict(loss=rec["loss"], grad1=per_head(rec["grad1"], H),
                weights0=per_head(rec["weights0"], H),
                weights=per_head(rec["weights_after"], H))
    out = train_gaps(prog, ref.follow(rec))
    every = torch.arange(ref.cfg["train"]["batch"], dtype=torch.int32)
    out["root_misses"] = float(sum(
        every.shape[0] if r.shape != every.shape
        else int((r != every).sum()) for r in rec["roots"]))
    return out


def check(cfg: dict, seed: int, device, handed: dict, evidence: dict
          ) -> Dict[str, float]:
    """The compared numbers of one run: the reference over the
    benchmark's inputs (``handed`` by ``Gat.release``) follows the
    program's first steps (``evidence["steps"]``)."""
    ref = GatReference(cfg, handed["arrays"], seed, device,
                       handed["weights0"])
    return check_train(ref, evidence["steps"])
