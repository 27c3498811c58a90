"""papers100M-shaped ingest drill at a chosen scale, over torch.distributed.

Counterpart of tools/ingest_drill.py: synthesize a ``src dst`` edge-list
text file, stream-convert it with the native parse, load the partitions
on the host, add a [N, 32] feature table, split the graph into shards
and write them, then train sharded DeepWalk and payload-sampled SAGE on
one rank a shard, recording wall time and peak host memory a stage.

    python -m euler_tpu_torch.tools.ingest_drill [--edges 200000000]
        [--nodes 10000000] [--dir build/euler_tpu_torch/drill]
        [--partitions 8] [--shards 8] [--steps 3] [--batch-per-dev 256]
        [--backend nccl|gloo] [--device cpu] [--out PATH] [--keep]

This process runs the reference's first stages under its names:
``generate`` (``gen_edge_file``, the reference's bytes from the same
seed), ``stream_convert`` (``graph.stream_convert.convert_edge_list``),
``load_store`` (``load_graph(packs=("group",), device="cpu")``, a host
load as the reference's ``device_put=False``) and ``shard_and_place``
(the ``feat`` table from ``default_rng(1).normal(0, 1, (N, 32))`` f32
injected before sharding, ``build_sharded`` and ``write_shards``). Then
``parallel.launch`` starts ``--shards`` ranks (``data=1``); each
``load_shard``s its shard onto its device (stage ``load_shard``) and
runs ``deepwalk_compile+first_step``/``deepwalk_steps``
(``DeepWalk(dim=32, walk_len=2, num_negs=2, shard_embeddings=True)``,
Adam 1e-3) and ``sage_compile+first_step``/``sage_steps`` (sage over
``SageDataFlow([5, 5], payload=True)``, dims (32, 32), ``ShallowEncoder``
over ``feat``, loss ``mean(emb * emb)``, Adam 1e-3). The first-step
stages hold no compile here: the names are the reference's, so that the
records line up. A stage's ``VmHWM`` is None where the kernel gives
none; ``VmRSS_peak_sampled`` is the largest VmRSS a thread read every
0.1 s since the process started. A rank stage's figures are rank 0's,
and ``VmHWM_by_rank``, ``VmRSS_peak_sampled_by_rank`` and
``device_peak_GB_by_rank`` (``max_memory_allocated`` over the stage, on
the card) every rank's.

The record (``build/euler_tpu_torch/DRILL_<E>M.json`` or ``--out``) has
every key of the reference's. NCCL takes a card a rank: more shards than
cards raises; ``--backend gloo`` runs ranks that share the card (or the
CPU with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from euler_tpu_torch._build import BUILD_DIR
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.estimator import get_optimizer
from euler_tpu_torch.graph import stream_convert
from euler_tpu_torch.graph.meta import FeatureSpec
from euler_tpu_torch.graph.store import load_graph
from euler_tpu_torch.models import DeepWalk, GNNNet, ShallowEncoder
from euler_tpu_torch.parallel import distributed, sharded
from euler_tpu_torch.parallel import train as sharded_train
from euler_tpu_torch.parallel.launch import launch

FEAT_DIM, LR = 32, 1e-3
RANK_TIMEOUT_S = 3600


def _mem_gb() -> dict:
    """This process's resident set and its peak, in GB, from
    /proc/self/status; the peak is None where the kernel gives no VmHWM
    there (some sandboxes; getrusage's ru_maxrss is no stand-in: a
    spawned rank inherits its parent's)."""
    out = {"VmHWM": None}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS", "VmHWM")):
                k, v = line.split(":")
                out[k] = round(int(v.split()[0]) / 1e6, 2)   # GB
    return out


class RssPeak:
    """The largest VmRSS (GB) a daemon thread reads from /proc every
    ``every`` seconds, since the start: a sampled peak where the kernel
    gives no VmHWM. ``close()`` stops it."""

    def __init__(self, every: float = 0.1):
        self.peak, self._every = _mem_gb()["VmRSS"], every
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._every):
            self.peak = max(self.peak, _mem_gb()["VmRSS"])

    def read(self) -> dict:
        now = _mem_gb()
        self.peak = max(self.peak, now["VmRSS"])
        return dict(now, VmRSS_peak_sampled=self.peak)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def gen_edge_file(path, n_edges, n_nodes, seed=0, chunk=5_000_000):
    """Fixed-width decimal edge lines via numpy digit math (a copy of
    tools/ingest_drill.py:44-66: the same bytes from the same seed)."""
    rng = np.random.default_rng(seed)
    width = len(str(n_nodes - 1))
    pows = (10 ** np.arange(width - 1, -1, -1,
                            dtype=np.int64))[None, :]
    with open(path, "wb", buffering=1 << 22) as f:
        done = 0
        while done < n_edges:
            c = min(chunk, n_edges - done)
            src = rng.integers(0, n_nodes, c)
            dst = rng.integers(0, n_nodes, c)
            row = np.empty((c, 2 * width + 2), np.uint8)
            row[:, :width] = (src[:, None] // pows) % 10 + 48
            row[:, width] = 32                       # space
            row[:, width + 1:2 * width + 1] = \
                (dst[:, None] // pows) % 10 + 48
            row[:, -1] = 10                          # newline
            f.write(row.tobytes())
            done += c
    return os.path.getsize(path)


def with_feature(graph, seed: int = 1):
    """``graph`` with the drill's dense ``feat`` table [N, FEAT_DIM] f32
    from ``default_rng(seed)``, added before sharding (the edge-list
    graph has no features; tools/ingest_drill.py:118-130)."""
    meta = dataclasses.replace(
        graph.meta, node_features=(FeatureSpec("feat", "dense", FEAT_DIM),))
    feat = np.random.default_rng(seed).normal(
        0, 1, (graph.meta.n_nodes, FEAT_DIM)).astype(np.float32)
    graph.meta = meta
    graph.tensors = dataclasses.replace(
        graph.tensors, meta=meta, dense_nf={"feat": torch.from_numpy(feat)})
    return graph


class Unsup(torch.nn.Module):
    """The drill's payload sage: the embedder's output and loss
    ``mean(emb * emb)``."""

    def __init__(self, embedder: torch.nn.Module):
        super().__init__()
        self.embedder = embedder

    def forward(self, g, roots, generator=None, uniforms=None) -> dict:
        emb = self.embedder(g, roots, generator=generator, uniforms=uniforms)
        return dict(loss=torch.mean(emb * emb), embedding=emb)


def _backend(args) -> str:
    return args.backend or ("gloo" if args.device == "cpu" else "nccl")


def drill_rank(args, shard_dir: str,
               probe: Optional[Callable] = None) -> dict:
    """One rank (the process group joined): load its shard, then the
    DeepWalk and the payload sage stages. ``probe(run_step)``, where
    given, gets a function that runs one sage step and its dict is
    returned under ``probe``."""
    mesh = distributed.make_global_mesh(1, args.shards, device=args.device,
                                        backend=_backend(args))
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    stages, out = {}, dict(rank=mesh.rank)
    rss = RssPeak()

    def start() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        return time.time()

    def stage(name: str, t0: float) -> None:
        rec = {"wall_s": round(time.time() - t0, 1), **rss.read()}
        if dev.type == "cuda":
            rec["device_peak_GB"] = round(
                torch.cuda.max_memory_allocated(dev) / 1e9, 3)
        stages[name] = rec

    t0 = start()
    view = sharded.load_shard(shard_dir, mesh.graph_index, dev, mesh)
    stage("load_shard", t0)
    n_nodes, bpd = view.meta.n_nodes, args.batch_per_dev

    t0 = start()
    dw = DeepWalk(n_nodes, FEAT_DIM, (0,), walk_len=2, num_negs=2,
                  shard_embeddings=True, device=dev,
                  generator=torch.Generator().manual_seed(0))
    sharded_train.init_sharded_params(dw, mesh, seed=0)
    step = sharded_train.make_sharded_train_step(
        dw, get_optimizer("adam", LR, dw.parameters()), mesh, bpd)
    float(step(view, seed=0))
    stage("deepwalk_compile+first_step", t0)
    t0 = start()
    for i in range(args.steps):
        loss = step(view, seed=1 + i)
    lval = float(loss)
    out["deepwalk_step_s"] = round((time.time() - t0) / args.steps, 3)
    out["deepwalk_loss"] = round(lval, 4)
    stage("deepwalk_steps", t0)
    del dw, step

    t0 = start()
    net = GNNNet("sage", SageDataFlow([5, 5], [(0,), (0,)], payload=True),
                 (FEAT_DIM, FEAT_DIM), ShallowEncoder(("feat",)),
                 in_dim=FEAT_DIM, device=dev,
                 generator=torch.Generator().manual_seed(0))
    model = Unsup(net)
    step2 = sharded_train.make_sharded_train_step(
        model, get_optimizer("adam", LR, model.parameters()), mesh, bpd)
    float(step2(view, seed=3))
    stage("sage_compile+first_step", t0)
    t0 = start()
    for i in range(args.steps):
        loss = step2(view, seed=4 + i)
    out["sage_loss"] = float(loss)
    out["sage_step_s"] = round((time.time() - t0) / args.steps, 3)
    stage("sage_steps", t0)
    if probe is not None:
        out["probe"] = probe(lambda: step2(view, seed=4 + args.steps))
    rss.close()
    out["stages"] = stages
    return out


def run(args, probe: Optional[Callable] = None, log=print) -> dict:
    """The drill of ``args`` (``parse``'s); returns and writes its
    record. ``probe`` as ``drill_rank``'s (it must pickle)."""
    backend = _backend(args)
    if backend == "nccl" and (args.device == "cpu"
                              or args.shards > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card a rank: {args.shards} shards, "
                         f"{torch.cuda.device_count()} cards; use "
                         f"--backend gloo to share them")
    os.makedirs(args.dir, exist_ok=True)
    rec = {"edges": args.edges, "nodes": args.nodes,
           "partitions": args.partitions, "shards": args.shards,
           "host_cpus": os.cpu_count(), "backend": backend, "stages": {}}

    rss = RssPeak()

    def stage(name, t0):
        rec["stages"][name] = {"wall_s": round(time.time() - t0, 1),
                               **rss.read()}
        log(f"[drill] {name}: {rec['stages'][name]}")

    edge_file = os.path.join(args.dir, "edges.txt")
    out_dir = os.path.join(args.dir, "parts")
    shard_dir = os.path.join(args.dir, "shards")
    try:
        t0 = time.time()
        size = gen_edge_file(edge_file, args.edges, args.nodes)
        rec["file_GB"] = round(size / 1e9, 2)
        stage("generate", t0)

        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        stream_convert.convert_edge_list(edge_file, out_dir,
                                         n_partitions=args.partitions)
        rec["lines_per_s"] = round(args.edges / (time.time() - t0) / 1e6, 2)
        stage("stream_convert", t0)
        if not args.keep:
            os.remove(edge_file)

        t0 = time.time()
        graph = load_graph(out_dir, packs=("group",), device="cpu")
        stage("load_store", t0)

        t0 = time.time()
        sg = sharded.build_sharded(with_feature(graph), args.shards)
        del graph
        sharded.write_shards(sg, shard_dir)
        del sg
        stage("shard_and_place", t0)

        ranks = launch(drill_rank, args.shards, backend, RANK_TIMEOUT_S,
                       args=(args, shard_dir, probe))
        for name, st in ranks[0]["stages"].items():
            rec["stages"][name] = dict(
                {k: st[k] for k in ("wall_s", "VmRSS", "VmHWM",
                                    "VmRSS_peak_sampled")},
                **{f"{k}_by_rank": [r["stages"][name][k] for r in ranks]
                   for k in ("VmHWM", "VmRSS_peak_sampled")})
            if "device_peak_GB" in st:
                rec["stages"][name]["device_peak_GB_by_rank"] = [
                    r["stages"][name]["device_peak_GB"] for r in ranks]
            log(f"[drill] {name}: {rec['stages'][name]}")
        for k in ("deepwalk_step_s", "deepwalk_loss", "sage_step_s"):
            rec[k] = ranks[0][k]
        rec["ranks"] = [{k: v for k, v in r.items() if k != "stages"}
                        for r in ranks]
    finally:
        rss.close()
        if not args.keep:
            for d in (out_dir, shard_dir):
                shutil.rmtree(d, ignore_errors=True)
            if os.path.exists(edge_file):
                os.remove(edge_file)

    out = args.out or os.path.join(
        BUILD_DIR, f"DRILL_{args.edges // 1_000_000}M.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    log(f"[drill] wrote {out}")
    return rec


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--edges", type=int, default=200_000_000)
    p.add_argument("--nodes", type=int, default=10_000_000)
    p.add_argument("--dir", default=os.path.join(BUILD_DIR, "drill"))
    p.add_argument("--partitions", type=int, default=8)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch-per-dev", type=int, default=256)
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", default=None,
                   help="cpu for ranks on the CPU (default: the cards)")
    p.add_argument("--out", default=None, help="JSON record path")
    p.add_argument("--keep", action="store_true",
                   help="keep the generated file, partitions and shards")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse(argv))


if __name__ == "__main__":
    main()
