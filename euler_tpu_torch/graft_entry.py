"""The driver's entry points on the port.

Counterpart of __graft_entry__.py:

``entry(device=None) -> (forward, args)``
    one forward of the flagship model (GraphSAGE, supervised) on one
    device: ``forward(*args) -> (loss, logit)``.
``dryrun_multichip(n, backend=None, device=None)``
    the full sharded training step on an n-rank (data, graph) mesh, one
    process a rank started by ``parallel.launch``: one step under
    ``comms.account()``, a reservoir redraw, a loop of 2 steps, then one
    DeepWalk step over graph-sharded tables.

Both build the reference's small model: ``SBMDataset(n_nodes=256,
n_classes=4, feat_dim=16, seed=0)`` (converted into a temporary
directory of the port's own), sage over ``SageDataFlow([5, 5])``, dims
(32, 32), a ``ShallowEncoder`` over the dense feature and
``SuperviseModel``. Where the reference takes a ``PRNGKey``, the port
takes the hop uniforms (drawn from a seeded ``torch.Generator``) or a
step's seed. Both run on the card unless the caller passes
``device="cpu"``.

    python -m euler_tpu_torch.graft_entry

runs ``entry()``'s forward on the card, then ``dryrun_multichip`` over
NCCL with a rank a card.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets.synthetic import SBMDataset
from euler_tpu_torch.estimator import get_optimizer
from euler_tpu_torch.models import (DeepWalk, GNNNet, ShallowEncoder,
                                    SuperviseModel)
from euler_tpu_torch.ops import COUNTED
from euler_tpu_torch.parallel import comms, distributed, sharded, train
from euler_tpu_torch.parallel.launch import launch

N_NODES, N_CLASSES, FEAT_DIM, SEED = 256, 4, 16, 0
FANOUTS, DIMS, ROOTS = [5, 5], (32, 32), 32
BATCH_PER_RANK, LR = 8, 1e-2
RANK_TIMEOUT_S = 600
PREFIX = "[euler_tpu_torch]"


def _dataset(root: str) -> SBMDataset:
    return SBMDataset(root, n_nodes=N_NODES, n_classes=N_CLASSES,
                      feat_dim=FEAT_DIM, seed=SEED)


def _build_small(device, root: str, graph_device=None):
    """(dataset, graph, model): the SBM graph under ``root`` (converted
    on first use) loaded on ``graph_device`` (``device`` where None), and
    the sage model on ``device``, its weights drawn from a generator
    seeded 0 (__graft_entry__.py:16-33)."""
    ds = _dataset(root)
    graph = ds.load_graph(device=device if graph_device is None
                          else graph_device)
    et = graph.meta.edge_type_id("link")
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow(FANOUTS, [(et,), (et,)]), DIMS,
                 ShallowEncoder((ds.feature_idx,)), in_dim=ds.feature_dim,
                 device=device, generator=gen)
    model = SuperviseModel(net, ds.label_idx, ds.label_dim, device=device,
                           generator=gen)
    return ds, graph, model


def forward(model: SuperviseModel, g, roots: torch.Tensor, uniforms: list):
    """One forward of ``model`` over ``roots`` from the hop ``uniforms``:
    (loss, logit) (__graft_entry__.py:46-48)."""
    out = model(g, roots, uniforms=uniforms)
    return out["loss"], out["logit"]


def entry(device=None):
    """``(forward, args)``: ``forward(*args) -> (loss, logit)`` is one
    forward of the flagship model over the roots ``arange(32)``, ``args``
    = (model, graph tensors, roots, hop uniforms drawn from a generator
    seeded 2) (__graft_entry__.py:36-51)."""
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="graft_entry_")
    try:
        _, graph, model = _build_small(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    model.eval()
    roots = torch.arange(ROOTS, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    uniforms = model.embedder.flow.draw_uniforms(graph.tensors, roots, gen)
    return forward, (model, graph.tensors, roots, uniforms)


def pick_mesh(n: int) -> tuple:
    """(data, graph) for ``n`` devices: ``graph`` the largest of 8, 4, 2,
    1 that divides ``n``, ``data`` the rest (__graft_entry__.py:62-67)."""
    if n < 1:
        raise ValueError(f"pick_mesh: {n} devices")
    graph = next(c for c in (8, 4, 2, 1) if n % c == 0)
    return n // graph, graph


def _counts() -> dict:
    return {k.__name__: k.launches for k in COUNTED}


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _counts().items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dryrun_rank(root: str, data: int, graph: int, device,
                 probe: Optional[Callable]) -> dict:
    """One rank of ``dryrun_multichip`` (the process group joined): the
    reference's sequence (__graft_entry__.py:68-112) over this rank's
    shard. Returns the rank's figures; rank 0 prints the reference's two
    lines."""
    mesh = distributed.make_global_mesh(data, graph, device=device,
                                        backend=dist.get_backend())
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    t0 = time.perf_counter()
    _, g, model = _build_small(dev, root, graph_device="cpu")
    view = train.place_sharded_graph(sharded.build_sharded(g, graph), mesh)
    train.init_sharded_params(model, mesh)
    opt = get_optimizer("adam", LR, model.parameters())
    step = train.make_sharded_train_step(model, opt, mesh, BATCH_PER_RANK)
    _sync(dev)
    out = dict(rank=mesh.rank, mesh=(data, graph),
               seconds={"build": time.perf_counter() - t0})

    # one step, its collectives counted (the reference's account() covers
    # this step only)
    before = _counts()
    t0 = time.perf_counter()
    with comms.account() as acc:
        loss = step(view, seed=0)
        _sync(dev)
    out["seconds"]["first_step"] = time.perf_counter() - t0
    out["launches"] = _since(before)
    out["first_loss"] = float(loss)
    out["forward"] = acc.totals(comms.FORWARD)
    out["backward"] = acc.totals(comms.BACKWARD)

    # the sharded reservoir redraw, then a loop of 2 steps
    view = sharded.refresh_fan_pack_sharded(view, 7)
    loop = train.make_sharded_train_step(model, opt, mesh, BATCH_PER_RANK,
                                         steps_per_loop=2)
    before = _counts()
    t0 = time.perf_counter()
    loss = loop(view, seed=1)
    _sync(dev)
    out["seconds"]["loop"] = time.perf_counter() - t0
    out["step_ms"] = out["seconds"]["loop"] / 2 * 1e3
    out["loop_launches"] = _since(before)
    out["loss"] = float(loss)

    # one DeepWalk step over tables split along the graph axis
    et = g.meta.edge_type_id("link")
    dw = DeepWalk(g.meta.n_nodes, 8, (et,), walk_len=2, num_negs=2,
                  shard_embeddings=True, device=dev,
                  generator=torch.Generator().manual_seed(1))
    train.init_sharded_params(dw, mesh)
    specs = train.param_specs(dw)
    dstep = train.make_sharded_train_step(
        dw, get_optimizer("adam", LR, dw.parameters()), mesh,
        BATCH_PER_RANK)
    before = _counts()
    t0 = time.perf_counter()
    dloss = dstep(view, seed=2)
    _sync(dev)
    out["seconds"]["walk_step"] = time.perf_counter() - t0
    out["walk_launches"] = _since(before)
    out["walk_loss"] = float(dloss)
    out["graph_sharded"] = sorted(k for k, v in specs.items()
                                  if v == "graph")
    if probe is not None:
        out["probe"] = probe(lambda: step(view, seed=3))
    if mesh.rank == 0:
        print("\n".join(report_lines(out)), flush=True)
    return out


def report_lines(res: dict) -> list:
    """The reference's two lines (__graft_entry__.py:114-117) of a rank's
    figures: the mesh and losses, then the first step's forward bytes a
    rank by collective, in KB."""
    (data, graph), fwd = res["mesh"], res["forward"]
    return [f"{PREFIX} dryrun_multichip ok: mesh=({data},{graph}) "
            f"loss={res['loss']:.4f} walk_loss={res['walk_loss']:.4f}",
            f"{PREFIX} bytes/step/rank (counted, forward): " + ", ".join(
                f"{k}={v / 1e3:.1f}KB" for k, v in sorted(fwd.items())
                if k != comms.HOST_STAGED)]


def dryrun_multichip(n: int, backend: Optional[str] = None, device=None,
                     probe: Optional[Callable] = None) -> dict:
    """The full sharded train step on ``n`` ranks of a ``pick_mesh(n)``
    mesh (__graft_entry__.py:54-116). ``device`` None means the cards
    and NCCL, a card a rank; ``backend="gloo"`` lets the ranks share the
    cards, and ``device="cpu"`` runs gloo ranks on the CPU.
    ``probe(run_step)``, where given (it must pickle), runs in each rank
    after the sequence with a function that runs one more sage step; its
    result is the rank's ``probe``.

    Returns rank 0's figures, ``mesh``, ``loss`` (the loop's last),
    ``walk_loss`` and ``bytes`` (the first step's forward by collective,
    ``host_staged`` apart), and every rank's under ``ranks``."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend moves CUDA tensors: pass a CUDA "
                         "device or backend='gloo'")
    data, graph = pick_mesh(n)
    root = tempfile.mkdtemp(prefix="graft_dryrun_")
    try:
        _dataset(root).load_graph(device="cpu")      # convert once
        ranks = launch(_dryrun_rank, n, backend, RANK_TIMEOUT_S,
                       args=(root, data, graph, device, probe))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first = ranks[0]
    return dict(mesh=first["mesh"], loss=first["loss"],
                walk_loss=first["walk_loss"], bytes=first["forward"],
                ranks=ranks)


def main() -> None:
    fn, args = entry()
    with torch.no_grad():
        loss, _ = fn(*args)
    print(f"{PREFIX} forward: {float(loss)}", flush=True)
    dryrun_multichip(torch.cuda.device_count())


if __name__ == "__main__":
    main()
