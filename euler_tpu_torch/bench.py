"""The port's training benchmark: bench.py's sampled modes, its
whole-graph gcn mode and its transe mode.

    python -m euler_tpu_torch.bench [--model sage|gin|gat|rgcn|tag|sgcn|
                                     agnn|appnp|graph|arma|dna|gated|gcn|
                                     transe] [--gcn-layout ell|edge_list]
    python -m euler_tpu_torch.bench --device cpu    # off-chip sizes
    python -m euler_tpu_torch.bench --nodes 1000000 [--batch B] [--dedup]

Counterpart of bench.py:260-454 for ``EULER_BENCH_MODEL=sage`` (the
default), ``gin``, ``gat`` and ``rgcn``: ``random_graph(200_000, 25,
seed=0)`` with 128-wide features (bf16 on the card) and 16 one-hot labels
drawn on the device from a seeded generator, fanout [25, 10], dims
(128, 128), batch 1024, Adam at 1e-3, roots from ``sample_node`` each
step. sage, gin and gat sample one edge type from the ``fan`` pack and
redraw its reservoir rows at the start of each loop of 50 steps. rgcn
builds its graph with 4 edge types and the ``fanu`` pack only, samples
every hop over all four types from the union rows with
``SageDataFlow(typed=True)``, runs ``RelationConv`` with 4 relations fed
from the sampled types, and redraws nothing (bench.py:385-393 redraws
only ``fan_pack``). The eight modes of ``CONV_MODES`` run as sage with
their conv at its reference defaults (TAG K=3, SGCN K=1, APPNP K=10 and
alpha 0.1, ARMA K=2 and T=1, DNA one head, Gated two steps), as
bench.py's sampled branch builds ``GNNNet(conv=mode)`` for any registry
name. ``--device cpu`` takes bench.py's off-chip sizes
(5,000 nodes, batch 256, 5 steps per loop, f32) and exists for tests.

``--nodes`` and ``--batch`` are bench.py's ``EULER_BENCH_NODES`` and
``EULER_BENCH_BATCH`` (bench.py:262-270, :490-491, :599-606): the graph's
node count in every mode, the roots a step in the sampled modes and the
triples a step in transe (gcn's batch is every node). ``--dedup`` is
``EULER_BENCH_DEDUP=1`` (bench.py:352-353), sampled modes only:
``GNNNet(dedup_features=True)``. Left unset they take the mode's size in
``SIZES``, ``GCN_SIZES`` or ``TRANSE_SIZES``; the ``config`` string and
the count a step follow the sizes run.

``gcn`` is bench.py's ``_gcn_child`` (bench.py:478-588): full-batch GCN
on ``random_graph(100_000, 25, seed=0, packs=("ell",))``, the same
features and labels, ``GNNNet("gcn", WholeDataFlow(2, [(0,)]))`` at dims
(128, 128), every node a root each step, 20 steps per loop, metric
``fullgraph_spmm_edges_per_sec_per_chip`` over ``2 * (N*25 + N)`` edges a
step. ``--gcn-layout edge_list`` is bench.py's ``EULER_BENCH_GCN_ELL=0``:
the graph has no pack and every layer scatters over the edge list. Off
the card: 2,000 nodes, 2 steps per loop, f32. It samples nothing, and
its graph has no fan rows to redraw.

``transe`` is bench.py's ``_transe_child`` (bench.py:591-671): TransE
(``models/kg.py``) on ``random_graph(100_000, 25, seed=0,
num_edge_types=16, packs=())``, 100-wide entity and relation tables in
f32 (as bench.py: no bf16), 5 negatives, batch 4096 triples drawn each
step by ``sample_edge`` over every edge type, Adam at 1e-3, 50 steps per
loop; metric ``transx_triples_per_sec_per_chip``, ``value`` in triples/s
(batch x steps / seconds). It launches neither kernel. Off the card:
2,000 nodes, batch 256, 5 steps per loop.

A loop is the estimator's ``TrainLoop`` of the mode's steps per loop, as
bench.py's loop is one ``lax.scan`` (bench.py:378-403): on the card one
train step captured as a CUDA graph and replayed, off it eager steps.
Three phases, as bench.py's: ``warmup`` (the first loop, whose first step
runs eagerly and whose second is captured), ``single_loop`` (one loop,
waited for) and ``pipelined`` (4 loops, or 2 off the card, waited for
once). Each phase prints one line ``ms_per_step ...`` and then
bench.py's JSON line: metric ``sampled_aggregate_edges_per_sec_per_chip``,
``"model"`` the mode, ``value`` in edges/s with bench.py's per-step edge
count for every sampled mode (bench.py:409-410), ``"vs_baseline": null``
and ``"platform"`` the torch device type. Every time is a host clock
around work that ends in reading the loss, which waits for the card.
Without CUDA and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, List, Optional

import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import (BaseEstimator, EdgeEstimator,
                                       NodeEstimator, RunConfig, TrainLoop,
                                       get_optimizer)
from euler_tpu_torch.graph.meta import FeatureSpec
from euler_tpu_torch.models import (GNNNet, ShallowEncoder, SuperviseModel,
                                    TransE)
from euler_tpu_torch.ops import sampling

METRIC = "sampled_aggregate_edges_per_sec_per_chip"
GCN_METRIC = "fullgraph_spmm_edges_per_sec_per_chip"
TRANSE_METRIC = "transx_triples_per_sec_per_chip"
AVG_DEGREE, FEAT_DIM, N_CLASSES = 25, 128, 16
FANOUT, DIMS, LR = [25, 10], (128, 128), 1e-3
#: the sampled modes: bench.py's and, as its sampled branch builds
#: ``GNNNet(conv=mode)`` for any registry name (bench.py:342), the other
#: eight convs at their reference defaults
CONV_MODES = ("tag", "sgcn", "agnn", "appnp", "graph", "arma", "dna",
              "gated")
SAMPLED = ("sage", "gin", "gat", "rgcn") + CONV_MODES
GNN_MODELS = SAMPLED + ("gcn",)
MODELS = GNN_MODELS + ("transe",)
RGCN_TYPES = 4
GCN_LAYERS = 2
GCN_LAYOUTS = ("ell", "edge_list")
# (nodes, batch, steps per loop, pipelined loops) on the card and off it
SIZES = {"cuda": (200_000, 1024, 50, 4), "cpu": (5_000, 256, 5, 2)}
# gcn: (nodes, steps per loop, pipelined loops); every node is a root
GCN_SIZES = {"cuda": (100_000, 20, 4), "cpu": (2_000, 2, 2)}
# transe: relations, table width, negatives; and (nodes, batch, steps per
# loop, pipelined loops) on the card and off it
TRANSE_RELATIONS, TRANSE_DIM, TRANSE_NEGS = 16, 100, 5
TRANSE_SIZES = {"cuda": (100_000, 4096, 50, 4), "cpu": (2_000, 256, 5, 2)}


def edges_per_step(batch: int) -> int:
    """bench.py's count: hop 1 B*f1 + hop 2 B*f1*f2, plus self loops."""
    return (batch * FANOUT[0] + batch * FANOUT[0] * FANOUT[1]
            + batch + batch * FANOUT[0])


def gcn_edges_per_step(n_nodes: int) -> int:
    """bench.py's count for gcn: every layer reads all N*25 edges and N
    self loops."""
    return GCN_LAYERS * (n_nodes * AVG_DEGREE + n_nodes)


def make_model(model: str, dev, dtype=None,
               generator: Optional[torch.Generator] = None,
               dedup: bool = False) -> SuperviseModel:
    """The ``SuperviseModel`` of the bench's ``model`` mode: GNNNet at
    DIMS on the 128-wide ``feature``, 16 labels. The sampled modes run
    SageDataFlow(FANOUT); rgcn samples every hop over its RGCN_TYPES edge
    types with types (``typed=True``) and feeds them to ``RelationConv``
    as relations; gcn runs ``WholeDataFlow(GCN_LAYERS, [(0,)])``, on the
    ELL pack where the graph has one and on the edge list elsewhere.
    ``dedup``: the sampled modes' ``dedup_features``."""
    if model not in GNN_MODELS:
        raise ValueError(f"bench GNN model {model!r} not in {GNN_MODELS}")
    rgcn = model == "rgcn"
    n_et = RGCN_TYPES if rgcn else 1
    if model == "gcn":
        flow = WholeDataFlow(GCN_LAYERS, [(0,)])
    else:
        flow = SageDataFlow(FANOUT, [tuple(range(n_et))] * 2, typed=rgcn)
    net = GNNNet({"rgcn": "relation"}.get(model, model), flow,
                 DIMS, ShallowEncoder(("feature",)), in_dim=FEAT_DIM,
                 dtype=dtype, device=dev, generator=generator,
                 conv_kwargs={"num_relations": n_et} if rgcn else None,
                 relation_from_etype=rgcn, dedup_features=dedup)
    return SuperviseModel(net, "label", N_CLASSES, device=dev,
                          generator=generator)


def build(dev: torch.device, n_nodes: int, batch: int,
          steps_per_loop: int, model: str = "sage",
          gcn_layout: str = "ell", dedup: bool = False) -> NodeEstimator:
    """The graph, features, model and estimator of the bench's GNN
    ``model`` mode on ``dev``; activations are bf16 on CUDA and f32
    elsewhere; ``dedup`` as ``make_model``'s."""
    if model not in GNN_MODELS:
        raise ValueError(f"bench GNN model {model!r} not in {GNN_MODELS}")
    if gcn_layout not in GCN_LAYOUTS:
        raise ValueError(f"gcn layout {gcn_layout!r} not in {GCN_LAYOUTS}")
    rgcn = model == "rgcn"
    act = torch.bfloat16 if dev.type == "cuda" else None
    if model == "gcn":
        packs = ("ell",) if gcn_layout == "ell" else ()
    else:
        packs = ("fanu",) if rgcn else ("fan",)
    graph = random_graph(n_nodes, AVG_DEGREE, seed=0,
                         num_edge_types=RGCN_TYPES if rgcn else 1,
                         packs=packs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    feat = torch.randn((n_nodes, FEAT_DIM), generator=gen, device=dev,
                       dtype=act or torch.float32)
    cls = torch.randint(0, N_CLASSES, (n_nodes,), generator=gen, device=dev)
    lab = torch.nn.functional.one_hot(cls, N_CLASSES).to(torch.float32)
    meta = dataclasses.replace(
        graph.meta, node_features=(FeatureSpec("feature", "dense", FEAT_DIM),
                                   FeatureSpec("label", "dense", N_CLASSES)))
    graph.meta = meta
    graph.tensors = dataclasses.replace(
        graph.tensors, meta=meta, dense_nf={"feature": feat, "label": lab})
    sup = make_model(model, dev, act, torch.Generator().manual_seed(0),
                     dedup)
    cfg = RunConfig(batch_size=batch, optimizer="adam", learning_rate=LR,
                    log_steps=0, reservoir_refresh=steps_per_loop,
                    steps_per_loop=steps_per_loop)
    return NodeEstimator(sup, graph, cfg, device=dev)


def build_transe(dev: torch.device, n_nodes: int, batch: int,
                 steps_per_loop: int) -> EdgeEstimator:
    """bench.py's transe graph and model on ``dev``: TransE over
    ``n_nodes`` entities and TRANSE_RELATIONS edge types, f32 tables from
    seed 0, an ``EdgeEstimator`` that draws ``batch`` triples a step in
    loops of ``steps_per_loop``."""
    graph = random_graph(n_nodes, AVG_DEGREE, seed=0,
                         num_edge_types=TRANSE_RELATIONS, packs=(),
                         device=dev)
    model = TransE(n_entities=n_nodes, n_relations=TRANSE_RELATIONS,
                   ent_dim=TRANSE_DIM, rel_dim=TRANSE_DIM,
                   num_negs=TRANSE_NEGS, device=dev,
                   generator=torch.Generator().manual_seed(0))
    cfg = RunConfig(batch_size=batch, optimizer="adam", learning_rate=LR,
                    log_steps=0, reservoir_refresh=0,
                    steps_per_loop=steps_per_loop)
    return EdgeEstimator(model, graph, cfg, device=dev)


def train_loop(est: BaseEstimator, model: str,
               gen: torch.Generator) -> Callable[[], torch.Tensor]:
    """The bench's loop of the ``model`` mode on ``est``, drawing from
    ``gen``: one redraw of the fan reservoir where the graph has fan rows
    (every sampled mode but rgcn, as bench.py's run_loop, which has none
    for rgcn's union rows; the graphs of gcn and transe have no fan rows),
    then ``est.config.steps_per_loop`` Adam
    steps as one ``TrainLoop`` (on the card a captured step replayed), on
    every node as the roots (gcn), sampled triples (transe) or sampled
    roots. Returns the loop's last loss; the ``TrainLoop`` is the
    function's ``.loop``."""
    g = est.graph.tensors
    opt = get_optimizer("adam", LR, est.model.parameters())
    every_node = torch.arange(est.graph.meta.n_nodes, dtype=torch.int32,
                              device=est.device)

    def roots():
        return every_node if model == "gcn" else est.train_batch(g, gen)

    loop = TrainLoop(est, opt, gen, est.config.steps_per_loop, roots)

    def run_loop():
        if g.fan_pack is not None:
            sampling.refresh_fan_pack(g, gen)
        return loop()
    run_loop.loop = loop
    return run_loop


def run(device=None, log: Callable = print, model: str = "sage",
        gcn_layout: str = "ell", nodes: Optional[int] = None,
        batch: Optional[int] = None, dedup: bool = False) -> List[dict]:
    """Run the three phases of the ``model`` mode; ``log`` gets each
    output line. ``nodes``, ``batch`` and ``dedup`` are bench.py's
    ``EULER_BENCH_NODES``/``BATCH``/``DEDUP`` (None: the mode's size).
    Returns the JSON records, each with its ``ms_per_step`` added."""
    if model not in MODELS:
        raise ValueError(f"bench model {model!r} not in {MODELS}")
    if batch is not None and model == "gcn":
        raise ValueError("gcn's batch is every node: set nodes")
    if dedup and model not in SAMPLED:
        raise ValueError(f"dedup is a knob of the sampled modes {SAMPLED}")
    dev = resolve_device(device)
    where = "cuda" if dev.type == "cuda" else "cpu"
    # per step: the count the metric reads, and its unit
    if model == "gcn":
        n_nodes, spl, outer = GCN_SIZES[where]
        n_nodes = nodes or n_nodes
        batch = n_nodes
        count, metric = gcn_edges_per_step(n_nodes), GCN_METRIC
        unit = "edges/s"
        config = f"full_n{n_nodes}_e{n_nodes * AVG_DEGREE}_l{GCN_LAYERS}"
    elif model == "transe":
        n_nodes, size_batch, spl, outer = TRANSE_SIZES[where]
        n_nodes, batch = nodes or n_nodes, batch or size_batch
        count, metric, unit = batch, TRANSE_METRIC, "triples/s"
        config = (f"b{batch}_negs{TRANSE_NEGS}_n{n_nodes}"
                  f"_r{TRANSE_RELATIONS}")
    else:
        n_nodes, size_batch, spl, outer = SIZES[where]
        n_nodes, batch = nodes or n_nodes, batch or size_batch
        count, metric = edges_per_step(batch), METRIC
        unit = "edges/s"
        config = f"b{batch}_f{FANOUT[0]}x{FANOUT[1]}_n{n_nodes}"
    est = (build_transe(dev, n_nodes, batch, spl) if model == "transe"
           else build(dev, n_nodes, batch, spl, model, gcn_layout, dedup))
    run_loop = train_loop(est, model,
                          torch.Generator(device=dev).manual_seed(2))

    records = []

    def record(loops: int, seconds: float, phase: str):
        steps = loops * spl
        value = count * steps / seconds
        out = {"metric": metric, "model": model, "value": round(value, 1),
               "unit": unit, "vs_baseline": None,
               "platform": dev.type, "phase": phase, "config": config}
        ms = seconds / steps * 1e3
        log(f"ms_per_step {phase} {ms:.4f}")
        log(json.dumps(out))
        records.append(dict(out, ms_per_step=ms))

    for phase, loops in (("warmup", 1), ("single_loop", 1),
                         ("pipelined", outer)):
        t0 = time.perf_counter()
        for _ in range(loops):
            loss = run_loop()
        if not torch.isfinite(loss):
            raise RuntimeError(f"bench: loss {float(loss)} in {phase}")
        record(loops, time.perf_counter() - t0, phase)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--model", default="sage", choices=MODELS,
                    help="bench.py's EULER_BENCH_MODEL (default: sage)")
    ap.add_argument("--gcn-layout", default="ell", choices=GCN_LAYOUTS,
                    help="gcn only: the ELL pack (default) or the edge "
                         "list, bench.py's EULER_BENCH_GCN_ELL=0")
    ap.add_argument("--nodes", type=int, default=None,
                    help="graph nodes, bench.py's EULER_BENCH_NODES "
                         "(default: the mode's size)")
    ap.add_argument("--batch", type=int, default=None,
                    help="roots (sampled modes) or triples (transe) a "
                         "step, bench.py's EULER_BENCH_BATCH")
    ap.add_argument("--dedup", action="store_true",
                    help="sampled modes: unique-before-gather "
                         "(GNNNet(dedup_features=True)), bench.py's "
                         "EULER_BENCH_DEDUP=1")
    args = ap.parse_args(argv)
    run(args.device, model=args.model, gcn_layout=args.gcn_layout,
        nodes=args.nodes, batch=args.batch, dedup=args.dedup)
    return 0


if __name__ == "__main__":
    sys.exit(main())
