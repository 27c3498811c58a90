"""The estimator API over the (data, graph) mesh, one process a rank.

Counterpart of euler_tpu/estimator/spmd.py (reference: between-graph TF
replication with PS variables, dist_tf_euler.sh and
base_estimator.py:164-166): ``SpmdEstimator`` and its node, edge and
graph variants (node_estimator.py:26, edge_estimator.py:27,
graph_estimator.py:26). Every rank builds the same estimator over its
own shard and calls the same methods; the graph group's collectives run
inside the ops, the gradient sync inside ``parallel.train``'s step.

``graph`` may be a one-device ``Graph`` (split into the mesh's graph
shards on the host here; every rank builds them all and keeps its own),
a ``ShardedGraphTensors`` (e.g. from
``parallel.distributed.load_graph_sharded``, which reads only this
rank's partitions) or a ``ShardView`` already on the rank's device.
``batch_size`` is the GLOBAL batch and must divide by the rank count.

``train`` keeps the reference's rules: the reservoir redraw every
``reservoir_refresh`` steps (``refresh_fan_pack_sharded``, the same
rows on every data replica of a shard), the log rule ``i % log_steps <
steps_per_loop`` (rank 0 logs), the save rule and a save at the end.
Each step's seed comes from ``seed + 1``'s stream, as the reference's
keys come from ``PRNGKey(seed + 1)``'s splits, and every rank draws the
same seeds.

A mesh checkpoint is a directory ``model_dir/ckpt/<step>/``: rank 0
writes the replicated parameters and buffers (``replicated.pt``) and
``mesh.json``, and the data-index-0 member of each graph group its
blocks of the graph-sharded tables (``shard_<g>.pt``); ``latest`` names
the step. It restores on a mesh of the same graph axis only: its tables
are laid out by shard, which a one-card checkpoint is not (the
reference's note, euler_tpu/models/layers.py:79).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch.estimator.estimator import (BaseEstimator, RunConfig,
                                                 get_optimizer,
                                                 make_graph_batch)
from euler_tpu_torch.graph.store import Graph
from euler_tpu_torch.models.kg import rank_all_entities
from euler_tpu_torch.parallel import mesh as mesh_lib
from euler_tpu_torch.parallel import sharded as sharded_lib
from euler_tpu_torch.parallel import train as train_lib
from euler_tpu_torch.utils import metrics as metrics_lib
from euler_tpu_torch.utils.hooks import LoggingHook


def _as_view(graph, mesh) -> sharded_lib.ShardView:
    if isinstance(graph, Graph):
        graph = sharded_lib.build_sharded(graph, mesh.graph)
    if graph.num_shards != mesh.graph:
        raise ValueError(f"graph has {graph.num_shards} shards; mesh graph "
                         f"axis is {mesh.graph}")
    if isinstance(graph, sharded_lib.ShardedGraphTensors):
        graph = train_lib.place_sharded_graph(graph, mesh)
    return graph


def default_mesh(model: torch.nn.Module,
                 graph_shards: int = 0) -> mesh_lib.Mesh:
    """The mesh an estimator builds when it is given none (the
    reference's rule, euler_tpu/estimator/spmd.py:51-55): over the
    process group this rank has joined, ``graph_shards`` graph shards
    (every rank where 0) and the rest of the ranks on the data axis, on
    the model's device and the group's backend. Raises outside a process
    group, and where ``graph_shards`` does not divide the ranks."""
    if not dist.is_initialized():
        raise ValueError(
            "mesh=None builds the mesh over the process group, and this "
            "process has joined none: call parallel.distributed.initialize "
            "first (or start the ranks with parallel.launch), or pass mesh=")
    world = dist.get_world_size()
    gs = graph_shards or world
    if gs < 1 or world % gs:
        raise ValueError(f"graph_shards={gs} does not divide the {world} "
                         f"ranks of the process group")
    return mesh_lib.make_mesh(data=world // gs, graph=gs,
                              backend=dist.get_backend(),
                              device=next(model.parameters()).device)


class SpmdEstimator(BaseEstimator):
    """The mesh estimators' shared machinery; subclasses give the batch
    hooks (``_ids_fn``, ``_expand_fn``). ``mesh`` is this rank's
    ``parallel.mesh.Mesh`` (``parallel.mesh.make_mesh``); without one the
    estimator builds ``default_mesh(model, graph_shards)``."""

    def __init__(self, model: torch.nn.Module, graph, config: RunConfig,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 graph_shards: int = 0):
        if mesh is None:
            mesh = default_mesh(model, graph_shards)
        self.mesh, self.device = mesh, mesh.device
        self.model, self.config = model, config
        dev = next(model.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"the model is on {dev}, the mesh on "
                             f"{self.device}")
        self.view = _as_view(graph, mesh)
        # ``graph`` for the code that reads the estimator's graph's meta
        self.graph = self.view
        if config.batch_size % mesh.size:
            raise ValueError(f"global batch {config.batch_size} must divide "
                             f"by the rank count {mesh.size}")
        self.batch_per_rank = config.batch_size // mesh.size
        self._restore_checked = False
        train_lib.init_sharded_params(model, mesh, config.seed)

    # ---- batch hooks (subclass contract) ----------------------------------
    def _ids_fn(self) -> Callable:
        raise NotImplementedError

    def _expand_fn(self) -> Optional[Callable]:
        return None

    @property
    def pspecs(self) -> Dict[str, str]:
        """Each parameter's and buffer's layout: "graph" for a block of a
        graph-sharded table, "replicated" for the rest."""
        return train_lib.param_specs(self.model)

    # ---- training ----------------------------------------------------------
    def train(self, total_steps: Optional[int] = None,
              log_fn: Callable = print) -> Dict[str, float]:
        cfg = self.config
        total = total_steps or cfg.total_steps
        self._restore()
        spl = max(1, int(cfg.steps_per_loop))
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate,
                            self.model.parameters())
        kw = dict(ids_fn=self._ids_fn(), expand_fn=self._expand_fn())
        step = train_lib.make_sharded_train_step(
            self.model, opt, self.mesh, self.batch_per_rank, **kw)
        loop = step if spl == 1 else train_lib.make_sharded_train_step(
            self.model, opt, self.mesh, self.batch_per_rank,
            steps_per_loop=spl, **kw)
        logger = LoggingHook(
            cfg.log_steps, log_fn if self.mesh.rank == 0 else
            (lambda _msg: None), steps_per_call=spl, total=total)
        draws = 0

        def next_seed() -> int:
            nonlocal draws
            draws += 1
            return sharded_lib.fold_seed(cfg.seed + 1, draws)

        loss = torch.tensor(float("nan"))
        i = 0
        next_refresh = cfg.reservoir_refresh or float("inf")
        while i < total:
            if i >= next_refresh:
                self.view = sharded_lib.refresh_fan_pack_sharded(
                    self.view, next_seed())
                next_refresh += cfg.reservoir_refresh
            if spl > 1 and i + spl <= total:
                loss = loop(self.view, next_seed())
                i += spl
            else:
                loss = step(self.view, next_seed())
                i += 1
            logger(i, loss, cfg.batch_size)
            if cfg.save_steps and i % cfg.save_steps < spl \
                    and i >= cfg.save_steps:
                self._save(i)
        self._save(total)
        return {"loss": float(loss), "steps": total}

    # ---- checkpoints -------------------------------------------------------
    def _save(self, step: int) -> None:
        if self.config.model_dir is None:
            return
        m = self.mesh
        d = self._ckpt_dir()
        at = os.path.join(d, str(step))
        os.makedirs(at, exist_ok=True)
        specs = self.pspecs
        state = self.model.state_dict()
        mine = {}
        if m.rank == 0:
            mine["replicated.pt"] = {k: v for k, v in state.items()
                                     if specs.get(k) != "graph"}
        if m.data_index == 0:
            shard = {k: v for k, v in state.items()
                     if specs.get(k) == "graph"}
            if shard:
                mine[f"shard_{m.graph_index}.pt"] = shard
        for name, part in mine.items():
            tmp = os.path.join(at, name + ".tmp")
            torch.save(part, tmp)
            os.replace(tmp, os.path.join(at, name))
        dist.barrier(group=m.world_group)
        if m.rank == 0:
            with open(os.path.join(at, "mesh.json"), "w") as f:
                json.dump({"data": m.data, "graph": m.graph}, f)
            with open(os.path.join(d, "latest"), "w") as f:
                f.write(str(step))
            keep = self.config.keep_checkpoints
            if keep > 0:
                older = sorted((int(n) for n in os.listdir(d)
                                if n.isdigit() and int(n) != step),
                               reverse=True)
                for old in older[keep - 1:]:
                    old_dir = os.path.join(d, str(old))
                    for name in os.listdir(old_dir):
                        os.remove(os.path.join(old_dir, name))
                    os.rmdir(old_dir)
        dist.barrier(group=m.world_group)

    def _restore(self) -> None:
        if self._restore_checked:
            return
        self._restore_checked = True
        if self.config.model_dir is None:
            return
        latest = os.path.join(self._ckpt_dir(), "latest")
        if not os.path.exists(latest):
            return
        with open(latest) as f:
            at = os.path.join(self._ckpt_dir(), f.read().strip())
        if not os.path.isdir(at):
            raise ValueError(f"{at} is a one-card checkpoint; a mesh "
                             f"estimator restores a mesh checkpoint")
        with open(os.path.join(at, "mesh.json")) as f:
            saved = json.load(f)
        if saved["graph"] != self.mesh.graph:
            raise ValueError(f"the checkpoint's tables are split over "
                             f"{saved['graph']} shards, the mesh's over "
                             f"{self.mesh.graph}")
        state = torch.load(os.path.join(at, "replicated.pt"),
                           map_location=self.device, weights_only=True)
        shard = os.path.join(at, f"shard_{self.mesh.graph_index}.pt")
        if os.path.exists(shard):
            state.update(torch.load(shard, map_location=self.device,
                                    weights_only=True))
        self.model.load_state_dict(state)

    # ---- evaluation and inference -----------------------------------------
    def _batched_outs(self, ids: np.ndarray
                      ) -> Tuple[List[dict], int, List[int]]:
        """The sharded apply over ``ids`` padded with -1 rows to a
        multiple of the global batch: (the batches' outputs, the live
        count, each batch's live rows)."""
        cfg = self.config
        self._restore()
        fn = train_lib.make_sharded_apply(self.model, self.mesh,
                                          expand_fn=self._expand_fn())
        ids = np.asarray(ids, np.int32)
        B, n = cfg.batch_size, len(ids)
        if n == 0:
            raise ValueError(
                "evaluate/infer called with an empty id sequence; pass at "
                "least one id (padding rows are added automatically)")
        pad = (-n) % B
        padded = np.concatenate(
            [ids, np.full((pad,) + ids.shape[1:], -1, ids.dtype)])
        outs, counts = [], []
        for j, i in enumerate(range(0, len(padded), B)):
            chunk = padded[i:i + B]
            outs.append(fn(self.view, torch.from_numpy(chunk),
                           seed=sharded_lib.fold_seed(cfg.seed + 2, j)))
            first = chunk if chunk.ndim == 1 else chunk[:, 0]
            counts.append(int((first >= 0).sum()))
        return outs, n, counts

    @staticmethod
    def _mean_loss(outs, counts) -> float:
        """Each batch's loss weighted by its live rows (pad rows excluded)."""
        num = sum(float(o["loss"]) * c for o, c in zip(outs, counts))
        return num / max(1, sum(counts))

    def evaluate(self, ids: Sequence[int]) -> Dict[str, float]:
        name = self.config.metric
        metric = metrics_lib.get(name)
        outs, n, counts = self._batched_outs(ids)
        if "logit" in outs[0]:
            logits = torch.cat([o["logit"] for o in outs])[:n]
            labels = torch.cat([o["label"] for o in outs])[:n]
            val = metric(labels, torch.sigmoid(logits) if name == "f1"
                         else logits)
        else:
            pos = torch.cat([o["logits"] for o in outs])[:n]
            neg = torch.cat([o["neg_logits"] for o in outs])[:n]
            val = metric(pos, neg)
        return {name: float(val), "loss": self._mean_loss(outs, counts)}

    def infer(self, ids: Sequence[int], out_dir: Optional[str] = None,
              worker: int = 0) -> np.ndarray:
        """Embeddings of ``ids`` on every rank; rank 0 writes them where
        ``out_dir`` is given (embedding_{worker}.npy, ids_{worker}.npy)."""
        outs, n, _ = self._batched_outs(ids)
        emb = torch.cat([o["embedding"] for o in outs])[:n].cpu().numpy()
        if out_dir and self.mesh.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"embedding_{worker}.npy"), emb)
            np.save(os.path.join(out_dir, f"ids_{worker}.npy"),
                    np.asarray(ids, np.int32))
        return emb


class SpmdNodeEstimator(SpmdEstimator):
    """Train source: the sharded ``sample_node`` (node_estimator.py:31-51)."""

    def __init__(self, model, graph, config, train_node_type=-1,
                 mesh=None, graph_shards: int = 0):
        super().__init__(model, graph, config, mesh, graph_shards)
        self.train_node_type = train_node_type

    def _ids_fn(self):
        return train_lib.node_ids_fn(self.train_node_type)


class SpmdEdgeEstimator(SpmdEstimator):
    """Train source: the sharded ``sample_edge`` triples
    (edge_estimator.py:32-72); KG training over the mesh."""

    def __init__(self, model, graph, config, train_edge_type=-1,
                 mesh=None, graph_shards: int = 0):
        super().__init__(model, graph, config, mesh, graph_shards)
        self.train_edge_type = train_edge_type

    def _ids_fn(self):
        return train_lib.edge_ids_fn(self.train_edge_type)

    def _batched_outs(self, ids):
        if np.asarray(ids).ndim == 1:
            raise ValueError(
                "SpmdEdgeEstimator.evaluate needs [T,3] (src,dst,etype) "
                "triples, not node ids (the EdgeEstimator contract)")
        return super()._batched_outs(ids)

    def evaluate_ranking(self, triples, corrupt: str = "both",
                         filter_known=None, hit_ks=(1, 3, 10)
                         ) -> Dict[str, float]:
        """Full-entity MR/MRR/Hit@k with the mesh-trained model: every
        rank ranks every triple over its view (a graph-sharded entity
        table answers the candidates' rows through its owners)."""
        self._restore()
        return rank_all_entities(self.model, self.view, triples,
                                 batch_size=self.config.batch_size,
                                 corrupt=corrupt, filter_known=filter_known,
                                 hit_ks=hit_ks)


class SpmdGraphEstimator(SpmdEstimator):
    """Graph classification over the mesh: the replicated graph-label
    table feeds the sharded feature and neighbor verbs
    (graph_estimator.py:32-77); ``make_graph_batch`` is the expand
    hook."""

    def __init__(self, model, graph, config, label_name: str = "label",
                 num_classes: int = 2, mesh=None, graph_shards: int = 0):
        self.label_name, self.num_classes = label_name, num_classes
        super().__init__(model, graph, config, mesh, graph_shards)

    def _ids_fn(self):
        return train_lib.graph_ids_fn()

    def _expand_fn(self):
        label_name, num_classes = self.label_name, self.num_classes

        def expand(view, gidx):
            return make_graph_batch(view, gidx, label_name, num_classes)
        return expand

    def evaluate(self, graph_ids: Sequence[int]) -> Dict[str, float]:
        outs, n, counts = self._batched_outs(graph_ids)
        logits = torch.cat([o["logit"] for o in outs])[:n]
        labels = torch.cat([o["label"] for o in outs])[:n]
        return {"accuracy": float(metrics_lib.accuracy(labels, logits)),
                "loss": self._mean_loss(outs, counts)}
