"""Many processes: the process group, the global mesh, per-rank graph
loading and a liveness probe.

Counterpart of euler_tpu/parallel/distributed.py (reference: N shard
servers behind gRPC, each calling ``Graph::Init(shard_idx, shard_num,
...)`` on only its own partition files, grpc_server.h:38,
graph_builder.cc:57-157). One process a rank:

  * ``initialize`` joins the process group (``init_process_group``;
    ``env://`` by default, as a launcher such as torchrun sets it);
  * ``make_global_mesh`` is the (data, graph) mesh over every rank;
  * ``load_graph_sharded`` reads ONLY the partition files of this rank's
    shard and returns its ``ShardView``: no rank ever holds the whole
    graph;
  * ``sync_hosts`` is a barrier, ``health_check`` a small psum with a
    deadline.
"""
from __future__ import annotations

import datetime
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph import convert as _convert
from euler_tpu_torch.graph.meta import BINARY, DENSE, SPARSE, GraphMeta
from euler_tpu_torch.graph.store import string_hash32
from euler_tpu_torch.parallel import comms
from euler_tpu_torch.parallel.mesh import TIMEOUT_S, Mesh, make_mesh
from euler_tpu_torch.parallel.sharded import (ShardedGraphTensors, ShardView,
                                              _build_shard_core, _flat_shard,
                                              _pad_shard_fields, _stack,
                                              _view)
from euler_tpu_torch.utils import io as _io


def initialize(init_method: str = "env://", world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group, once a process (the reference's
    ``jax.distributed.initialize``). ``backend`` defaults to NCCL on the
    card and gloo with ``device="cpu"``; ``world_size`` and ``rank`` come
    from the environment under ``env://``."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def make_global_mesh(data: int = 1, graph: Optional[int] = None,
                     device=None, backend: Optional[str] = None) -> Mesh:
    """The (data, graph) mesh over every rank of the group: rank ``r`` at
    data index ``r // graph``, so each graph group's ranks are
    consecutive, on one host first where a launcher numbers a host's
    ranks together."""
    if not dist.is_initialized():
        raise ValueError("make_global_mesh: call initialize first")
    total = dist.get_world_size()
    if graph is None:
        graph = total // data
    if data * graph != total:
        raise ValueError(f"mesh ({data}, {graph}) != {total} ranks")
    return make_mesh(data, graph, backend=backend, device=device)


def sync_hosts(mesh: Optional[Mesh] = None) -> None:
    """A barrier over every rank (reference: SyncExitHook,
    tf_euler/python/utils/hooks.py:26-40)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=None if mesh is None else mesh.world_group)


def _my_shard_ids(mesh: Mesh) -> List[int]:
    """The shards this rank holds: its graph index (a rank holds one)."""
    return [mesh.graph_index]


def _part_fields(meta: GraphMeta, S: int, n_max: int, e_max: int,
                 part: Dict[str, np.ndarray]):
    """One shard's rows, re-routed from the partition files -> its core
    and padded fields (a copy of distributed.py:92-119)."""
    own_type = part["node_type"]
    own_w = part["node_w"]
    core = _build_shard_core(
        meta, own_type, own_w, part["src"] // S, part["dst"],
        part["etype"], part["ew"], part["eid"])
    perm = core["perm"]

    dense_nf, sparse_nf, binary_hash = {}, {}, {}
    for spec in meta.node_features:
        if spec.kind == DENSE:
            dense_nf[spec.name] = part[f"nf_d:{spec.name}"]
        elif spec.kind == SPARSE:
            sparse_nf[spec.name] = (part[f"nf_sp:{spec.name}"],
                                    part[f"nf_splen:{spec.name}"])
        elif spec.kind == BINARY:
            binary_hash[spec.name] = np.asarray(
                [string_hash32(v) for v in part[f"nf_bin:{spec.name}"]],
                np.int32)
    dense_ef, sparse_ef = {}, {}
    for spec in meta.edge_features:
        if spec.kind == DENSE:
            dense_ef[spec.name] = part[f"ef_d:{spec.name}"][perm]
        elif spec.kind == SPARSE:
            sparse_ef[spec.name] = (part[f"ef_sp:{spec.name}"][perm],
                                    part[f"ef_splen:{spec.name}"][perm])
    return core, _pad_shard_fields(
        meta, core, n_max, e_max, own_type, own_w,
        dense_nf, sparse_nf, binary_hash, dense_ef, sparse_ef)


def _shard_part(path: str, meta: GraphMeta, s: int, S: int
                ) -> Dict[str, np.ndarray]:
    """Shard s's raw rows, re-routed from the partition files (a copy of
    distributed.py:122-180).

    Partitioning is ``local_id % n_partitions`` and shard ownership is
    ``local_id % S``; when P != S, shard s's nodes live exactly in the
    partitions ``p = s (mod gcd(P, S))``, so only those files are read
    and their rows filtered (the reference's double modulo
    ``(id % partition_number) % shard_num``, id_split_op.cc:46-48).
    """
    P_ = meta.n_partitions

    def rd(p):
        with _io.open_file(_io.join(path, f"part_{p}.npz"), "rb") as fh:
            return dict(np.load(fh, allow_pickle=False))

    if P_ == S:
        return rd(s)
    g = math.gcd(P_, S)
    chunks = []
    for p in range(s % g, P_, g):
        part = rd(p)
        nsel = (part["node_local"] % S) == s
        esel = (part["src"] % S) == s
        out = {}
        for k, v in part.items():
            if k.startswith(("ef_", "src", "dst", "etype", "ew", "eid")):
                out[k] = v[esel]
            else:
                out[k] = v[nsel]
        chunks.append(out)
    merged = {k: np.concatenate([c[k] for c in chunks])
              for k in chunks[0]}
    # node rows are positional (local row = v // S): restore ascending
    # global-id order after the partition-major concatenation
    order = np.argsort(merged["node_local"], kind="stable")
    edge_keys = ("src", "dst", "etype", "ew", "eid")
    for k in merged:
        if not (k.startswith("ef_") or k in edge_keys):
            merged[k] = merged[k][order]
    return merged


def load_graph_sharded(path: str, mesh: Mesh) -> ShardView:
    """This rank's shard read from the converter's partition files, on
    its device (distributed.py:183-240): only the partitions that hold
    its rows are read. The partition count need NOT equal the graph
    axis: rows re-route by ``local_id % S``. Every rank must call it.

    ``e_max`` (one edge padding for every shard) is the converter's
    where P == S, else the max of the shards' counts over every rank;
    the replicated per-shard weight tables combine with a max over every
    rank, not a sum: data replicas of a shard hold the same row."""
    with _io.open_file(_io.join(path, _convert.META_FILE), "r") as f:
        meta = GraphMeta.from_json(f.read())
    S, s = mesh.graph, _my_shard_ids(mesh)[0]
    part = _shard_part(path, meta, s, S)
    if meta.n_partitions == S and meta.part_edge_counts:
        e_max = max(1, *meta.part_edge_counts)
    else:
        e_max = int(comms.pmax(torch.tensor([max(1, len(part["eid"]))]),
                               mesh.world_group))
    core, fields = _part_fields(meta, S, -(-meta.n_nodes // S), e_max, part)
    tabs = {}
    for key, row, n in (("shard_node_w", "node_w_row", meta.num_node_types),
                        ("shard_edge_w", "edge_w_row", meta.num_edge_types)):
        tab = torch.zeros((S, n))
        tab[s] = torch.from_numpy(core[row])
        tabs[key] = comms.pmax(tab, mesh.world_group).numpy()
    one = ShardedGraphTensors(meta=meta, num_shards=S, **tabs,
                              **{k: _stack([v]) for k, v in fields.items()})
    return _view(meta, S, s, _flat_shard(one, 0), mesh.device, mesh)


def health_check(mesh: Mesh, timeout_s: float = 60.0) -> dict:
    """A liveness probe of the mesh (distributed.py:243-286): one small
    psum over every rank on a worker thread, with a deadline, so that a
    dead rank cannot block the caller past ``timeout_s``. Every rank
    must call it. Returns {"ok": bool, "latency_s": float | None,
    "devices": int, "error": str | None}. On a wedged group the worker
    thread may linger after the deadline: treat ok=False as "abort the
    job", not "retry"."""
    result = {"ok": False, "latency_s": None, "devices": mesh.size,
              "error": None}
    done = threading.Event()

    def probe():
        try:
            t0 = time.monotonic()
            x = torch.ones(1, device=mesh.device)
            total = float(comms.psum(x, mesh.world_group))
            if total != mesh.size:
                raise RuntimeError(f"psum of ones gave {total}, not "
                                   f"{mesh.size}")
            result["latency_s"] = round(time.monotonic() - t0, 3)
            result["ok"] = True
        except Exception as e:  # noqa: BLE001 -- reported, not raised
            result["error"] = repr(e)
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True).start()
    if not done.wait(timeout_s):
        result["error"] = f"mesh unresponsive after {timeout_s}s"
    return result
