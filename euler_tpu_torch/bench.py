"""The port's training benchmark: bench.py's default ``sage`` mode.

    python -m euler_tpu_torch.bench                 # on the card
    python -m euler_tpu_torch.bench --device cpu    # off-chip sizes

Counterpart of bench.py:260-454 for ``EULER_BENCH_MODEL=sage``:
``random_graph(200_000, 25, seed=0)`` with 128-wide features (bf16 on the
card) and 16 one-hot labels drawn on the device from a seeded generator,
fanout [25, 10], dims (128, 128), batch 1024, Adam at 1e-3, roots from
``sample_node`` each step, and one reservoir redraw at the start of each
loop of 50 steps. ``--device cpu`` takes bench.py's off-chip sizes (5,000
nodes, batch 256, 5 steps per loop, f32) and exists for tests.

Three phases, as bench.py's: ``warmup`` (the first loop), ``single_loop``
(one loop, waited for) and ``pipelined`` (4 loops, or 2 off the card,
waited for once). Each phase prints one line ``ms_per_step ...`` and then
bench.py's JSON line: metric ``sampled_aggregate_edges_per_sec_per_chip``,
``value`` in edges/s with bench.py's per-step edge count (bench.py:
409-410), ``"vs_baseline": null`` and ``"platform"`` the torch device
type. Every time is a host clock around work that ends in reading the
loss, which waits for the card. Without CUDA and without ``--device cpu``
it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, List

import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import NodeEstimator, RunConfig, get_optimizer
from euler_tpu_torch.graph.meta import FeatureSpec
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.ops import sampling

METRIC = "sampled_aggregate_edges_per_sec_per_chip"
AVG_DEGREE, FEAT_DIM, N_CLASSES = 25, 128, 16
FANOUT, DIMS, LR = [25, 10], (128, 128), 1e-3
# (nodes, batch, steps per loop, pipelined loops) on the card and off it
SIZES = {"cuda": (200_000, 1024, 50, 4), "cpu": (5_000, 256, 5, 2)}


def edges_per_step(batch: int) -> int:
    """bench.py's count: hop 1 B*f1 + hop 2 B*f1*f2, plus self loops."""
    return (batch * FANOUT[0] + batch * FANOUT[0] * FANOUT[1]
            + batch + batch * FANOUT[0])


def build(dev: torch.device, n_nodes: int, batch: int,
          steps_per_loop: int) -> NodeEstimator:
    """The graph, features, model and estimator of the bench on ``dev``;
    activations are bf16 on CUDA and f32 elsewhere."""
    act = torch.bfloat16 if dev.type == "cuda" else None
    graph = random_graph(n_nodes, AVG_DEGREE, seed=0, packs=("fan",),
                         device=dev)
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
    wgen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow(FANOUT, [(0,), (0,)]), DIMS,
                 ShallowEncoder(("feature",)), in_dim=FEAT_DIM, dtype=act,
                 device=dev, generator=wgen)
    model = SuperviseModel(net, "label", N_CLASSES, device=dev,
                           generator=wgen)
    cfg = RunConfig(batch_size=batch, optimizer="adam", learning_rate=LR,
                    log_steps=0, reservoir_refresh=steps_per_loop)
    return NodeEstimator(model, graph, cfg, device=dev)


def run(device=None, log: Callable = print) -> List[dict]:
    """Run the three phases; ``log`` gets each output line. Returns the
    JSON records, each with its ``ms_per_step`` added."""
    dev = resolve_device(device)
    n_nodes, batch, spl, outer = SIZES["cuda" if dev.type == "cuda"
                                       else "cpu"]
    est = build(dev, n_nodes, batch, spl)
    g = est.graph.tensors
    opt = get_optimizer("adam", LR, est.model.parameters())
    gen = torch.Generator(device=dev).manual_seed(2)

    def run_loop():
        # one reservoir redraw per loop, as bench.py's run_loop
        sampling.refresh_fan_pack(g, gen)
        for _ in range(spl):
            loss = est.step(opt, est.train_batch(g, gen), generator=gen)
        return loss

    records = []

    def record(loops: int, seconds: float, phase: str):
        steps = loops * spl
        value = edges_per_step(batch) * steps / seconds
        out = {"metric": METRIC, "model": "sage", "value": round(value, 1),
               "unit": "edges/s", "vs_baseline": None,
               "platform": dev.type, "phase": phase,
               "config": f"b{batch}_f{FANOUT[0]}x{FANOUT[1]}_n{n_nodes}"}
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
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
