"""Training, evaluation and inference loops over a model and a graph.

Counterpart of euler_tpu/estimator/estimator.py (reference:
euler_estimator/python/base_estimator.py:28-188, node_estimator.py:26):
``RunConfig``, ``get_optimizer``, ``BaseEstimator.train``/``evaluate``/
``infer``, ``NodeEstimator`` and ``EdgeEstimator`` (edge_estimator.py:27).
The reference's jitted step with optax becomes an eager step with
autograd and a torch.optim optimizer. Not ported yet: ``steps_per_loop``,
checkpoints and the profiler hook.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import Graph
from euler_tpu_torch.models.kg import rank_all_entities
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.utils import metrics as metrics_lib


def get_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    """reference: tf_euler/python/utils/optimizers.py:23-31, as optax
    builds them. Adagrad takes optax's accumulator start (0.1) and eps
    (1e-7), where torch's defaults are 0 and 1e-10."""
    params = list(params)
    return {
        "sgd": lambda: torch.optim.SGD(params, lr),
        "momentum": lambda: torch.optim.SGD(params, lr, momentum=0.9),
        "adagrad": lambda: torch.optim.Adagrad(
            params, lr, initial_accumulator_value=0.1, eps=1e-7),
        "adam": lambda: torch.optim.Adam(params, lr),
    }[name]()


@dataclasses.dataclass
class RunConfig:
    batch_size: int = 512
    total_steps: int = 1000
    optimizer: str = "adam"
    learning_rate: float = 0.01
    log_steps: int = 100
    seed: int = 0
    metric: str = "f1"
    reservoir_refresh: int = 100  # redraw the fan_pack reservoir rows
    # every N steps (0 = never): groups with degree > FAN_D hold
    # pre-drawn neighbors, exact per draw but repeated until redrawn
    # (ops/sampling.refresh_fan_pack)


class BaseEstimator:
    """Generic run loops; subclasses provide the batch source.

    The model is an ``nn.Module`` whose ``forward(g, batch, generator=,
    uniforms=)`` returns a dict with at least ``loss``.
    """

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.graph = graph
        self.config = config
        for what, dev in (("graph", graph.tensors.device),
                          ("model", next(model.parameters()).device)):
            if dev.type != self.device.type:
                raise ValueError(f"the {what} is on {dev}, the estimator "
                                 f"on {self.device}")

    # ---- batch source (subclass hook) -------------------------------------
    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        """Return the per-step model input."""
        raise NotImplementedError

    # ---- training ----------------------------------------------------------
    def step(self, optimizer: torch.optim.Optimizer, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             uniforms: Optional[Sequence] = None) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss as a 0-d
        tensor on the device (reading it waits for the card)."""
        self.model.train()
        optimizer.zero_grad(set_to_none=True)
        out = self.model(self.graph.tensors, batch, generator=generator,
                         uniforms=uniforms)
        out["loss"].backward()
        optimizer.step()
        return out["loss"].detach()

    def train(self, total_steps: Optional[int] = None,
              log_fn: Callable = print) -> Dict[str, float]:
        """``total_steps`` optimizer steps from a fresh optimizer state,
        as the reference's ``train`` (base_estimator.py:160-254); the
        reservoir redraws stay in ``graph.tensors`` afterwards."""
        cfg = self.config
        total = total_steps or cfg.total_steps
        g = self.graph.tensors
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate,
                            self.model.parameters())
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + 1)
        t0 = time.time()
        loss = last_loss = None
        next_refresh = cfg.reservoir_refresh or float("inf")
        for i in range(1, total + 1):
            if i - 1 >= next_refresh:
                sampling.refresh_fan_pack(g, gen)
                next_refresh += cfg.reservoir_refresh
            loss = self.step(opt, self.train_batch(g, gen), generator=gen)
            if cfg.log_steps and i % cfg.log_steps == 0:
                last_loss = float(loss)
                rate = i * cfg.batch_size / (time.time() - t0)
                log_fn(f"[euler_tpu_torch] step {i}/{total} "
                       f"loss={last_loss:.4f} ({rate:.0f} ex/s)")
        if last_loss is None or last_loss != last_loss:
            last_loss = float(loss)
        return {"loss": last_loss, "steps": total}

    # ---- evaluation and inference -----------------------------------------
    def _batched_apply(self, ids: np.ndarray, fn: Callable
                       ) -> Tuple[List, int]:
        """Pad ids with -1 to batch multiples, run fn per batch with one
        generator seeded from ``seed + 2``; the caller strips the padding
        with the returned count."""
        B = self.config.batch_size
        n = len(ids)
        pad = (-n) % B
        padded = np.concatenate(
            [ids, np.full((pad,) + ids.shape[1:], -1, ids.dtype)])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed + 2)
        g = self.graph.tensors
        outs = []
        for i in range(0, len(padded), B):
            batch = torch.from_numpy(padded[i:i + B]).to(self.device)
            outs.append(fn(g, batch, gen))
        return outs, n

    def _check_ids(self, ids: np.ndarray) -> None:
        """Raise if ``ids`` is not what the model takes."""

    def evaluate(self, ids: Sequence[int]) -> Dict[str, float]:
        """The config's metric and the mean batch loss over ``ids``
        (reference: estimator.py:273-314): f1 or accuracy of the logits
        against the labels for a supervised model, and for a model without
        ``logit`` (the unsupervised and KG heads) the metric of the
        positives' ``logits`` against their ``neg_logits``."""
        name = self.config.metric
        metric = metrics_lib.get(name)
        ids = np.asarray(ids, np.int32)
        self._check_ids(ids)

        def run(g, batch, gen):
            return self.model(g, batch, generator=gen)

        self.model.eval()
        with torch.no_grad():
            outs, n = self._batched_apply(ids, run)
            if "logit" in outs[0]:
                logits = torch.cat([o["logit"] for o in outs])[:n]
                labels = torch.cat([o["label"] for o in outs])[:n]
                if name == "f1":
                    val = metric(labels, torch.sigmoid(logits))
                else:
                    val = metric(labels, logits)
            else:
                pos = torch.cat([o["logits"] for o in outs])[:n]
                neg = torch.cat([o["neg_logits"] for o in outs])[:n]
                val = metric(pos, neg)
            loss = float(np.mean([float(o["loss"]) for o in outs]))
        return {name: float(val), "loss": loss}

    def infer(self, ids: Sequence[int], out_dir: Optional[str] = None,
              worker: int = 0) -> np.ndarray:
        """Embeddings for ids (for an ``EdgeEstimator``, [T, 3] triples,
        whose node columns are checked); optionally written as
        embedding_{worker}.npy + ids_{worker}.npy."""
        ids = np.asarray(ids, np.int32)
        self._check_ids(ids)
        nodes = ids[:, :2] if ids.ndim == 2 else ids
        n_nodes = self.graph.meta.n_nodes
        if nodes.size and (nodes.min() < -1 or nodes.max() >= n_nodes):
            raise ValueError(f"ids must lie in [0, {n_nodes}) (or be -1)")

        def embed(g, batch, gen):
            return self.model(g, batch, generator=gen)["embedding"]

        self.model.eval()
        with torch.no_grad():
            outs, n = self._batched_apply(ids, embed)
            emb = torch.cat(outs)[:n].cpu().numpy()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"embedding_{worker}.npy"), emb)
            np.save(os.path.join(out_dir, f"ids_{worker}.npy"), ids)
        return emb


class NodeEstimator(BaseEstimator):
    """Train source = sample_node(batch, node_type)
    (reference: node_estimator.py:31-51)."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, train_node_type=-1, device=None):
        super().__init__(model, graph, config, device=device)
        self.train_node_type = train_node_type

    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        return sampling.sample_node(g, self.config.batch_size,
                                    self.train_node_type, generator)


class EdgeEstimator(BaseEstimator):
    """Train source = sample_edge(batch, edge_type); the model receives
    (src, dst, etype) stacked int32 [B, 3] (reference:
    edge_estimator.py:32-72)."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, train_edge_type=-1, device=None):
        super().__init__(model, graph, config, device=device)
        self.train_edge_type = train_edge_type

    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        src, dst, ty, _ = sampling.sample_edge(
            g, self.config.batch_size, self.train_edge_type, generator)
        return torch.stack([src, dst, ty], dim=1)

    def _check_ids(self, ids: np.ndarray) -> None:
        if ids.ndim == 1:
            raise ValueError(
                "EdgeEstimator needs [T,3] (src,dst,etype) test triples, "
                "not node ids (the reference evaluates from triple id "
                "files); use sample_edge to build a triple set or "
                "evaluate_ranking for full-entity MR/Hit@k")

    def evaluate_ranking(self, triples, corrupt: str = "both",
                         filter_known=None, hit_ks=(1, 3, 10)
                         ) -> Dict[str, float]:
        """Full-entity ranking (MeanRank, MRR, Hit@k) of [T, 3] test
        triples in batches of ``config.batch_size``, which bounds the
        [batch, n_entities, dim] scores; needs a TransX-family model."""
        return rank_all_entities(self.model, self.graph.tensors, triples,
                                 batch_size=self.config.batch_size,
                                 corrupt=corrupt, filter_known=filter_known,
                                 hit_ks=hit_ks)
