"""The (data, graph) mesh as torch.distributed process groups.

Counterpart of euler_tpu/parallel/mesh.py. The reference runs one SPMD
program over ``Mesh(("data", "graph"))``; the port runs one process per
device of that mesh. Rank ``r`` sits at data index ``r // graph`` and
graph index ``r % graph`` (row order, as the reference's device array
``reshape(data, graph)``). Its graph group is the ``graph`` ranks that
share its data index: they hold the shards of one graph, and the sharded
verbs run their collectives over it. Its data group is the ``data``
ranks that share its graph index (the reference's "data" axis): they
hold the same shard, and a graph-sharded parameter's gradient is
averaged over it.

The transport follows the backend: NCCL moves device tensors, one card
a rank; gloo is the CPU backend, and ``comms`` stages every tensor of a
gloo collective through the host, explicitly. Nothing tries one backend
and falls back to another.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

from euler_tpu_torch._device import resolve_device

#: seconds a collective (and the rendezvous) waits before it raises
TIMEOUT_S = 120


@dataclasses.dataclass
class Mesh:
    """One rank's place in the (data, graph) mesh and its groups."""

    data: int
    graph: int
    rank: int
    backend: str
    device: torch.device
    graph_group: object        # the ranks that share this data index
    world_group: object        # every rank
    data_group: object = None  # the ranks that share this graph index

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph

    @property
    def data_index(self) -> int:
        return self.rank // self.graph


def make_mesh(data: int = 1, graph: int = 1, backend: Optional[str] = None,
              device=None, init_method: Optional[str] = None,
              rank: Optional[int] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join (or use) the default process group and build the mesh's
    groups; every rank must call it with the same ``data`` and ``graph``.

    ``device`` None means the card (it raises without one), and then the
    backend defaults to NCCL; ``device="cpu"`` means gloo. Several ranks
    may share one card over gloo. ``init_method`` (e.g.
    ``"tcp://localhost:29500"`` or ``"file:///path"``) and ``rank`` are
    passed to ``init_process_group`` when the process has not joined a
    group yet, with world size ``data * graph``.
    """
    need = data * graph
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend moves CUDA tensors: pass a CUDA "
                         "device or backend='gloo'")
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if rank is None:
            raise ValueError("make_mesh: pass rank (and init_method) to "
                             "join the process group")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=need, timeout=timeout)
    if dist.get_world_size() != need:
        raise ValueError(f"the mesh needs {need} ranks, the process group "
                         f"has {dist.get_world_size()}")
    me = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", me % torch.cuda.device_count())
    world = dist.group.WORLD

    def group(ranks):
        # a group of every rank is the world's (no second communicator);
        # every rank creates every other group, in one order (new_group's
        # rule): the graph groups, then the data groups
        if len(ranks) == need:
            return world
        return dist.new_group(ranks, timeout=timeout, backend=backend)
    graph_groups = [group([d * graph + g for g in range(graph)])
                    for d in range(data)]
    data_groups = [group([d * graph + g for d in range(data)])
                   for g in range(graph)]
    return Mesh(data=data, graph=graph, rank=me, backend=backend, device=dev,
                graph_group=graph_groups[me // graph],
                data_group=data_groups[me % graph], world_group=world)


#: the attribute that marks a parameter or buffer split over the graph
#: axis (the reference's ``nn.with_partitioning(("graph", None))`` box):
#: (graph index, graph axis size) of the block it holds
GRAPH_SHARDED = "graph_sharded"


def mark_graph_sharded(t: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
    """Mark ``t`` (a parameter or buffer) as this rank's block of a table
    split over the graph axis: ``train._sync_grads`` averages its
    gradient over the data group only, checkpoints save it per shard and
    ``models.load_flax_params`` loads its rows of an assembled table.
    Returns ``t``."""
    setattr(t, GRAPH_SHARDED, (mesh.graph_index, mesh.graph))
    return t


def graph_shard_of(t: torch.Tensor):
    """(graph index, graph axis size) of a marked block, else None."""
    return getattr(t, GRAPH_SHARDED, None)


def is_graph_sharded(t: torch.Tensor) -> bool:
    return graph_shard_of(t) is not None


def rank_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of an n-row batch split in row order over every
    rank of the mesh (data index major); ``n`` must divide evenly."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def close() -> None:
    """Leave the process group (each rank, at its end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
