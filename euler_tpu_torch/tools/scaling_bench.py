"""Scaling bench: edges/s of the sharded sage train step across mesh shapes.

Counterpart of tools/scaling_bench.py over torch.distributed ranks, one
process a rank. For each ``DxG`` shape the launcher
(``parallel.launch``) starts ``D*G`` ranks; each builds the mesh
(``distributed.make_global_mesh``) and the same ``SBMDataset(n_classes=8,
seed=0)`` graph, which this process converts once before any rank
starts, and trains ``SpmdNodeEstimator(SuperviseModel(GNNNet("sage",
SageDataFlow([f1, f2]), dims=(64, 64))))`` at a global batch of
``batch_per_dev * D * G`` with ``reservoir_refresh=0``: 2 warm steps, then
``--steps`` timed. Rank 0 prints one JSON line a shape with the
reference's keys and this process a summary line.

    python -m euler_tpu_torch.tools.scaling_bench [--nodes 50000]
        [--batch-per-dev 128] [--fanouts 25 10] [--steps 20]
        [--feat-dim 64] [--shapes 1x1,1x2,1x4] [--backend nccl|gloo]
        [--device cpu] [--chip-step-ms MS --link-gbs GBS]

``edges_per_sec`` is the reference's count, ``(bpd*ndev)*(f1 + f1*f2 + 1
+ f1)*steps`` over the timed seconds; ``scaling_efficiency`` is against
the first shape's rate a device. The reference counts collectives once a
compiled step at trace time, which covers the forward, the loss pmean
and the gradient sync and not the backward's transposes; here each call
counts as it runs, over the timed steps, divided by the steps:
``comm_MB_per_step_per_dev`` is the forward's (the number that compares
with the reference's, but for the root draw's sync: the reference
all_gathers an 8-byte key, the port member 0's type and shard uniforms,
two f32 [b * S]), ``comm_MB_backward_per_step_per_dev`` the
backward's, ``host_staged_MB_per_step_per_dev`` gloo's host copies (not a
collective). ``predicted_chip_efficiency`` (shapes of more than one
device) needs both ``--chip-step-ms`` (a measured one-device step) and
``--link-gbs`` (a rate measured on the machine): the reference's 90 GB/s
default is a TPU's ICI and says nothing of a GPU's link, so there is no
default. It counts the bytes of both directions.

NCCL moves device tensors, one card a rank: a shape of more ranks than
cards raises, and nothing switches backend on its own. ``--backend
gloo`` runs ranks that share the cards (or the CPU with ``--device
cpu``); such shapes measure no scaling. ``--avg-deg`` is accepted as the
reference accepts it and, as there, unused: the SBM graph's degree
follows from its block probabilities.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import torch

from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets.synthetic import SBMDataset
from euler_tpu_torch.estimator import RunConfig, SpmdNodeEstimator
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.ops import COUNTED
from euler_tpu_torch.parallel import comms, distributed
from euler_tpu_torch.parallel.launch import launch

N_CLASSES, DIMS, WARM_STEPS = 8, (64, 64), 2
RANK_TIMEOUT_S = 1200


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=50_000)
    p.add_argument("--avg-deg", type=int, default=25)
    p.add_argument("--batch-per-dev", type=int, default=128)
    p.add_argument("--fanouts", type=int, nargs=2, default=[25, 10])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--shapes", default=None,
                   help="comma list of DxG mesh shapes; default sweeps the "
                        "graph axis over powers of two up to the cards "
                        "(the CPU cores with --device cpu)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", default=None,
                   help="cpu for ranks on the CPU (default: the cards)")
    p.add_argument("--chip-step-ms", type=float, default=None,
                   help="a measured one-device step time of this "
                        "per-device workload; with --link-gbs enables the "
                        "predicted scaling efficiency")
    p.add_argument("--link-gbs", type=float, default=None,
                   help="a measured link rate a rank sends at (GB/s); no "
                        "default")
    return p.parse_args(argv)


def shapes_of(args) -> List[tuple]:
    if args.shapes:
        return [tuple(int(x) for x in s.split("x"))
                for s in args.shapes.split(",")]
    n = torch.cuda.device_count() if args.device is None \
        else os.cpu_count()
    out, g = [], 1
    while g <= n:
        out.append((1, g))
        g *= 2
    return out


def backend_of(args) -> str:
    return args.backend or ("gloo" if args.device == "cpu" else "nccl")


def dataset(args, root: str) -> SBMDataset:
    return SBMDataset(root, n_nodes=args.nodes, n_classes=N_CLASSES,
                      feat_dim=args.feat_dim, seed=0)


def edges_per_step(args, ndev: int) -> int:
    """The reference's count: hop 1, hop 2, self loops, hop-1 self
    loops, for every root of the global batch."""
    f1, f2 = args.fanouts
    return args.batch_per_dev * ndev * (f1 + f1 * f2 + 1 + f1)


def _counts() -> dict:
    return {k.__name__: k.launches for k in COUNTED}


def rank_shape(args, data: int, graph: int, root: str,
               base_rate: Optional[float],
               probe: Optional[Callable] = None) -> dict:
    """One rank's run of one shape (the process group joined): the
    estimator's warm and timed steps with the collectives counted over
    the timed ones. Rank 0 prints the shape's JSON line. Returns the
    rank's figures: ``record`` (rank 0's line), ``seconds``, the bytes a
    step by collective ``forward``/``backward`` and the kernel launches of
    the timed steps.
    ``probe(run_step)``, where given, gets a function that runs one more
    step after the timed ones; its dict is returned under ``probe``."""
    mesh = distributed.make_global_mesh(data, graph, device=args.device,
                                        backend=backend_of(args))
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    ds = dataset(args, root)
    g = ds.load_graph(device="cpu")
    et = g.meta.edge_type_id("link")
    f1, f2 = args.fanouts
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow([f1, f2], [(et,), (et,)]), DIMS,
                 ShallowEncoder((ds.feature_idx,)), in_dim=args.feat_dim,
                 device=dev, generator=gen)
    model = SuperviseModel(net, ds.label_idx, ds.label_dim, device=dev,
                           generator=gen)
    ndev = mesh.size
    cfg = RunConfig(batch_size=args.batch_per_dev * ndev,
                    total_steps=args.steps, log_steps=0,
                    steps_per_loop=max(1, args.steps // 2), save_steps=0,
                    reservoir_refresh=0)
    est = SpmdNodeEstimator(model, g, cfg,
                            train_node_type=ds.train_node_type, mesh=mesh)
    est.train(total_steps=WARM_STEPS)
    before = _counts()
    with comms.account() as acc:
        t0 = time.perf_counter()
        est.train(total_steps=args.steps)     # ends reading the loss
        dt = time.perf_counter() - t0
    steps = args.steps
    launches = {k: n - before[k] for k, n in _counts().items()}
    fwd = {k: v / steps for k, v in acc.totals(comms.FORWARD).items()}
    bwd = {k: v / steps for k, v in acc.totals(comms.BACKWARD).items()}
    rate = edges_per_step(args, ndev) * steps / dt
    rec = {"mesh": f"{data}x{graph}", "devices": ndev,
           "edges_per_sec": round(rate, 1),
           "scaling_efficiency": round(
               1.0 if base_rate is None else rate / (base_rate * ndev), 3),
           "comm_MB_per_step_per_dev": {
               k: round(v / 1e6, 3) for k, v in fwd.items()
               if k != comms.HOST_STAGED},
           "platform": dev.type,
           "comm_MB_backward_per_step_per_dev": {
               k: round(v / 1e6, 3) for k, v in bwd.items()
               if k != comms.HOST_STAGED},
           "host_staged_MB_per_step_per_dev": round(
               (fwd[comms.HOST_STAGED] + bwd[comms.HOST_STAGED]) / 1e6, 3),
           "launches_per_step": {k: n / steps
                                 for k, n in launches.items()}}
    if args.chip_step_ms and args.link_gbs and ndev > 1:
        # acc holds `steps` steps: the same ratio as one step's
        rec["predicted_chip_efficiency"] = round(acc.predicted_efficiency(
            args.chip_step_ms / 1e3 * steps, args.link_gbs * 1e9), 3)
    out = dict(rank=mesh.rank, seconds=dt, forward=fwd, backward=bwd,
               launches=launches, record=rec)
    if probe is not None:
        out["probe"] = probe(lambda: est.train(total_steps=1))
    if mesh.rank == 0:
        print(json.dumps(rec), flush=True)
    return out


def sweep(args, probe: Optional[Callable] = None) -> List[dict]:
    """Every shape of ``args`` in turn, its ranks started by ``launch``:
    for each, rank 0's record and every rank's figures (``ranks``).
    ``probe`` as ``rank_shape``'s (it must pickle)."""
    backend = backend_of(args)
    if backend == "nccl" and args.device == "cpu":
        raise ValueError("the NCCL backend moves CUDA tensors: --device cpu "
                         "takes --backend gloo")
    shapes = shapes_of(args)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        too_big = [s for s in shapes if s[0] * s[1] > cards]
        if too_big:
            raise ValueError(f"NCCL needs a card a rank: shapes {too_big} "
                             f"need more than the {cards} cards; use "
                             f"--backend gloo to share them")
    root = tempfile.mkdtemp(prefix="scaling_")
    try:
        dataset(args, root).load_graph(device="cpu")   # convert once
        base_rate, results = None, []
        for data, graph in shapes:
            ranks = launch(rank_shape, data * graph, backend,
                           RANK_TIMEOUT_S,
                           args=(args, data, graph, root, base_rate, probe))
            rec = ranks[0]["record"]
            if base_rate is None:
                base_rate = rec["edges_per_sec"] / rec["devices"]
            results.append(dict(record=rec, ranks=ranks))
        return results
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> List[dict]:
    results = [r["record"] for r in sweep(parse(argv))]
    print(json.dumps({"summary": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
