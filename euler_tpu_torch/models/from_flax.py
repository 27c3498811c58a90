"""Load a flax parameter tree of the JAX package into the port's modules.

The tree is numpy arrays (for example ``jax.tree.map(np.asarray,
variables)``), with or without the top-level ``"params"`` key. Names:

  embedder/conv_i/<name>           -> embedder.convs[i].<attribute>, by
                                      conv (``_conv_tree``):
    gcn       Dense_0 -> fc
    sage      Dense_0 -> self_fc, Dense_1 -> neigh_fc
    gat       Dense_0 -> fc, Dense_1 -> a1, Dense_2 -> a2
    gin       Dense_0 -> fc, eps -> eps (when trainable)
    relation  Dense_0 -> self_fc, matrix -> matrix (both [R, dim, D_in])
    tag, sgcn Dense_0 -> fc
    agnn      beta -> beta (appnp has no parameters)
    graph     Dense_0 -> src_fc, Dense_1 -> self_fc
    arma      Dense_0..nW-1 -> ws[0..], Dense_nW..2nW-1 -> vs[0..]
    dna       Dense_0 -> in_fc, Dense_1..3 -> q, k, v
    gated     Dense_0 -> proj (where D_in != dim), the next Denses ->
              fcs[0..], GRUCell_0/{ir,iz,in,hr,hz,hn} -> gru.gates[...]
  embedder/out_fc/{kernel, bias}   -> embedder.out_fc.{weight, bias}
                                      (GNNNet and JKGNNNet)
  embedder/feature/id_embedding/embedding
                                   -> the encoder's id_embedding.weight
  embedder/feature/sparse_<name>/embedding
                                   -> the encoder's sparse[<name>].weight
  head_fc/kernel                   -> head_fc.weight
  Embed_0/embedding                -> EmbedOnly.embed.weight
  {embedder, context_embedder}/... -> UnsuperviseModel's towers, each a
                                      GNNNet or an EmbedOnly tree
  <table>/embedding                -> TransX.<table>.weight, for
                                      entity_encoder, relation_encoder,
                                      hyper_vector, transfer_matrix,
                                      entity_transfer, relation_transfer;
                                      DeepWalk's, Node2Vec's and LINE's
                                      .<table>.weight, for target_emb and
                                      context_emb (none in LINE order 1)

The models of this slice (each net may stand as an ``embedder``):
  GeniePathLazyNet  in_fc, OptimizedLSTMCell_0/{ii,if,ig,io,hi,hf,hg,ho}
                    -> lstm.gates[...], {w_src,w_dst,att,b_fc}_i ->
                    layers[i][...], out_fc
  LGCNNet           fc_i -> fcs[i], out_fc
  ScalableGNNNet    agg_i -> aggs[i]: Dense_0 -> fc (gcn), else self_fc,
                    neigh_fc and pool_fc; the whole variables dict's
                    cache/<module path>/store_layer_i -> the store buffers
  GroupGNNNet       gnns_i -> gnns[i]
  SharedGroupGNNNet conv_i, out_fc
  GAE, VGAE, DGI    embedder; log_var_fc (VGAE), disc (DGI)
  GraphModel        embedder, pool (AttentionPool: Dense_0 -> gate;
                    Set2SetPool: Dense_0 -> proj, OptimizedLSTMCell_0 ->
                    lstm), head_fc
  SolutionModel     embedder, DenseLogits_0/Dense_0 -> logits.fc
  SampleSolutionModel  group
  layers            embeddings (Embedding, SparseEmbedding,
                    HashEmbedding), embedding (ShardedEmbedding),
                    att_i_j/val_i_j/mix_i/ctx_i (AttLayer),
                    ScanOptimizedLSTMCell_0 (LSTMLayer)
  aggregators       Dense_0 (gcn), self_fc, neigh_fc, pool_fc

A flax kernel is [in, out] and loads as ``Linear.weight = kernel.T``; any
other parameter, an embedding [rows, features] included, loads as it is.
A bare net, layer, aggregator or pool takes its own tree, without the
``embedder`` level. A shape that does not fit raises.

A mesh model's tree (unboxed: ``flax.linen.meta.unbox``) loads into each
rank's modules after ``parallel.train.init_sharded_params``: replicated
leaves as they are, and a P('graph') table, assembled [S * n_local, d],
gives graph index ``g``'s block its rows [g * n_local, (g + 1) *
n_local).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.models.convs import (AGNNConv, APPNPConv, ARMAConv,
                                         DNAConv, GATConv, GatedConv,
                                         GCNConv, GINConv, GraphConv,
                                         GRUCell, RelationConv, SAGEConv,
                                         SGCNConv, TAGConv)
from euler_tpu_torch.models.aggregators import GCNAggregator, _BaseAggregator
from euler_tpu_torch.models.autoencoders import DGI, GAE, VGAE
from euler_tpu_torch.models.encoders import Embed, ShallowEncoder
from euler_tpu_torch.models.extra_nets import GeniePathLazyNet, LGCNNet
from euler_tpu_torch.models.gnn import (EmbedOnly, GNNNet, JKGNNNet,
                                        SuperviseModel, UnsuperviseModel)
from euler_tpu_torch.models.graph_model import GraphModel
from euler_tpu_torch.models.group_gnn import GroupGNNNet, SharedGroupGNNNet
from euler_tpu_torch.models.kg import TransX
from euler_tpu_torch.models.layers import (AttLayer, Embedding,
                                           HashEmbedding, LSTMCell,
                                           LSTMLayer, ShardedEmbedding,
                                           SparseEmbedding)
from euler_tpu_torch.models.pooling import (AttentionPool, SegmentPool,
                                            Set2SetPool)
from euler_tpu_torch.models.scalable import ScalableGNNNet
from euler_tpu_torch.models.solution import (SampleSolutionModel,
                                             SolutionModel)
from euler_tpu_torch.models.walk_models import LINE, DeepWalk
from euler_tpu_torch.parallel.mesh import graph_shard_of

#: flax name inside conv_i -> attribute of the port's conv
_CONV_TREES = {
    GCNConv: {"Dense_0": "fc"},
    SAGEConv: {"Dense_0": "self_fc", "Dense_1": "neigh_fc"},
    GATConv: {"Dense_0": "fc", "Dense_1": "a1", "Dense_2": "a2"},
    GINConv: {"Dense_0": "fc", "eps": "eps"},
    RelationConv: {"Dense_0": "self_fc", "matrix": "matrix"},
    TAGConv: {"Dense_0": "fc"},
    SGCNConv: {"Dense_0": "fc"},
    AGNNConv: {"beta": "beta"},
    APPNPConv: {},
    GraphConv: {"Dense_0": "src_fc", "Dense_1": "self_fc"},
    DNAConv: {"Dense_0": "in_fc", "Dense_1": "q", "Dense_2": "k",
              "Dense_3": "v"},
}


def _conv_tree(conv: nn.Module) -> dict:
    """flax name inside conv_i -> the port's module or parameter. Flax
    numbers the Denses of a conv in the order it creates them: ARMA's
    every ``ws`` before every ``vs``, Gated's optional projection before
    its per-step Denses (its GRU cell is ``GRUCell_0``)."""
    if isinstance(conv, ARMAConv):
        dense = list(conv.ws) + list(conv.vs)
    elif isinstance(conv, GatedConv):
        dense = ([conv.proj] if conv.proj is not None else []) \
            + list(conv.fcs)
    else:
        return {k: getattr(conv, a)
                for k, a in _CONV_TREES[type(conv)].items()}
    tree = {f"Dense_{i}": m for i, m in enumerate(dense)}
    if isinstance(conv, GatedConv):
        tree["GRUCell_0"] = conv.gru
    return tree


def _set(param: torch.Tensor, value, name: str) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    shard = graph_shard_of(param)
    if shard is not None and value.shape[0] == shard[1] * param.shape[0]:
        # a P('graph') table assembled [S * n_local, ...]: this rank's
        # block is rows [g * n_local, (g + 1) * n_local)
        n = param.shape[0]
        value = value[shard[0] * n:(shard[0] + 1) * n]
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: flax shape {tuple(value.shape)} does not "
                         f"fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _load_dense(lin: nn.Linear, tree: Mapping, name: str) -> None:
    _set(lin.weight, np.asarray(tree["kernel"]).T, f"{name}/kernel")
    if lin.bias is not None:
        _set(lin.bias, tree["bias"], f"{name}/bias")


def load_conv(conv: nn.Module, tree: Mapping, prefix: str = "") -> None:
    """Copy one conv's flax tree (the contents of ``conv_i``) into
    ``conv``; ``prefix`` names it in errors."""
    for flax_name, target in _conv_tree(conv).items():
        name = f"{prefix}{flax_name}"
        if isinstance(target, nn.Linear):
            _load_dense(target, tree[flax_name], name)
        elif isinstance(target, GRUCell):
            for gate, lin in target.gates.items():
                _load_dense(lin, tree[flax_name][gate], f"{name}/{gate}")
        elif isinstance(target, torch.Tensor):          # not a fixed eps
            _set(target, tree[flax_name], name)


def _load_encoder(enc: nn.Module, tree: Mapping, prefix: str) -> None:
    """The tables of a ``ShallowEncoder`` (none for a dense-only one)."""
    if not isinstance(enc, ShallowEncoder):
        return
    if enc.id_embedding is not None:
        _load_embed(enc.id_embedding, tree["id_embedding"],
                    f"{prefix}id_embedding")
    for name, table in enc.sparse.items():
        _load_embed(table, tree[f"sparse_{name}"], f"{prefix}sparse_{name}")


def _load_gnn(net: nn.Module, tree: Mapping, prefix: str) -> None:
    """A ``GNNNet`` or a ``JKGNNNet``."""
    for i, conv in enumerate(net.convs):
        # a conv without parameters (APPNP) has no entry
        load_conv(conv, tree.get(f"conv_{i}", {}), f"{prefix}conv_{i}/")
    _load_dense(net.out_fc, tree["out_fc"], f"{prefix}out_fc")
    _load_encoder(net.feature, tree.get("feature", {}), f"{prefix}feature/")


def _load_embed(emb: Embed, tree: Mapping, name: str) -> None:
    _set(emb.weight, tree["embedding"], f"{name}/embedding")


def _load_lstm(cell: LSTMCell, tree: Mapping, name: str) -> None:
    """flax's OptimizedLSTMCell: ``ii``..``io`` kernels, ``hi``..``ho``
    kernels and biases."""
    for gate, lin in cell.gates.items():
        _load_dense(lin, tree[gate], f"{name}/{gate}")


def _load_aggregator(agg: nn.Module, tree: Mapping, name: str) -> None:
    if isinstance(agg, GCNAggregator):
        _load_dense(agg.fc, tree["Dense_0"], f"{name}/Dense_0")
        return
    for sub in ("self_fc", "neigh_fc", "pool_fc"):
        if hasattr(agg, sub):
            _load_dense(getattr(agg, sub), tree[sub], f"{name}/{sub}")


def _load_pool(pool: nn.Module, tree: Mapping, name: str) -> None:
    if isinstance(pool, AttentionPool):
        _load_dense(pool.gate, tree["Dense_0"], f"{name}/Dense_0")
    elif isinstance(pool, Set2SetPool):
        _load_dense(pool.proj, tree["Dense_0"], f"{name}/Dense_0")
        _load_lstm(pool.lstm, tree["OptimizedLSTMCell_0"],
                   f"{name}/OptimizedLSTMCell_0")


def _load_layer(layer: nn.Module, tree: Mapping, name: str) -> None:
    """A module of models/layers.py."""
    if isinstance(layer, (Embedding, SparseEmbedding, HashEmbedding)):
        _load_embed(layer.embeddings, tree["embeddings"],
                    f"{name}/embeddings")
    elif isinstance(layer, ShardedEmbedding):
        _set(layer.embedding, tree["embedding"], f"{name}/embedding")
    elif isinstance(layer, AttLayer):
        for k, lin in layer.fcs.items():
            _load_dense(lin, tree[k], f"{name}/{k}")
    elif isinstance(layer, LSTMLayer):
        _load_lstm(layer.cell, tree["ScanOptimizedLSTMCell_0"],
                   f"{name}/ScanOptimizedLSTMCell_0")
    elif isinstance(layer, LSTMCell):
        _load_lstm(layer, tree, name)


def _load_net(net: nn.Module, tree: Mapping, prefix: str) -> None:
    """A node-level net: a ``GNNNet``, ``JKGNNNet``, ``EmbedOnly``,
    ``GeniePathLazyNet``, ``LGCNNet``, ``ScalableGNNNet`` or a group
    net."""
    if isinstance(net, EmbedOnly):
        _load_embed(net.embed, tree["Embed_0"], f"{prefix}Embed_0")
    elif isinstance(net, (GNNNet, JKGNNNet)):
        _load_gnn(net, tree, prefix)
    elif isinstance(net, GeniePathLazyNet):
        _load_dense(net.in_fc, tree["in_fc"], f"{prefix}in_fc")
        _load_lstm(net.lstm, tree["OptimizedLSTMCell_0"],
                   f"{prefix}OptimizedLSTMCell_0")
        for i, layer in enumerate(net.layers):
            for k, lin in layer.items():
                _load_dense(lin, tree[f"{k}_{i}"], f"{prefix}{k}_{i}")
        _load_dense(net.out_fc, tree["out_fc"], f"{prefix}out_fc")
    elif isinstance(net, LGCNNet):
        for i, fc in enumerate(net.fcs):
            _load_dense(fc, tree[f"fc_{i}"], f"{prefix}fc_{i}")
        _load_dense(net.out_fc, tree["out_fc"], f"{prefix}out_fc")
    elif isinstance(net, ScalableGNNNet):
        for i, agg in enumerate(net.aggs):
            _load_aggregator(agg, tree[f"agg_{i}"], f"{prefix}agg_{i}")
    elif isinstance(net, GroupGNNNet):
        for i, tower in enumerate(net.gnns):
            _load_net(tower, tree[f"gnns_{i}"], f"{prefix}gnns_{i}/")
        return
    elif isinstance(net, SharedGroupGNNNet):
        for i, conv in enumerate(net.convs):
            load_conv(conv, tree.get(f"conv_{i}", {}), f"{prefix}conv_{i}/")
        _load_dense(net.out_fc, tree["out_fc"], f"{prefix}out_fc")
    else:
        raise TypeError(f"no flax mapping for {type(net).__name__}")
    if hasattr(net, "feature") and not isinstance(net, (GNNNet, JKGNNNet)):
        _load_encoder(net.feature, tree.get("feature", {}),
                      f"{prefix}feature/")


def _load_stores(model: nn.Module, cache: Mapping) -> None:
    """The scalable stores of flax's ``cache`` collection (``cache`` /
    <module path> / ``store_layer_i``) into the buffers of every
    ``ScalableGNNNet`` in ``model``."""
    for path, mod in model.named_modules():
        if not isinstance(mod, ScalableGNNNet):
            continue
        tree = cache
        for part in filter(None, path.split(".")):
            tree = tree[part]
        for i, store in enumerate(mod.stores(), start=1):
            _set(store, tree[f"store_layer_{i}"],
                 f"cache/{path}/store_layer_{i}")


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the flax tree ``params`` into ``model`` in place; returns it.
    With the whole variables dict, a ``cache`` collection (the scalable
    stores) is loaded too."""
    tree = params.get("params", params)
    if isinstance(model, SuperviseModel):
        _load_net(model.embedder, tree["embedder"], "embedder/")
        _load_dense(model.head_fc, tree["head_fc"], "head_fc")
    elif isinstance(model, UnsuperviseModel):
        for name in ("embedder", "context_embedder"):
            _load_net(getattr(model, name), tree[name], f"{name}/")
    elif isinstance(model, (GAE, DGI)):
        _load_net(model.embedder, tree["embedder"], "embedder/")
        if isinstance(model, VGAE):
            _load_dense(model.log_var_fc, tree["log_var_fc"], "log_var_fc")
        if isinstance(model, DGI):
            _load_dense(model.disc, tree["disc"], "disc")
    elif isinstance(model, GraphModel):
        _load_net(model.embedder, tree["embedder"], "embedder/")
        if not isinstance(model.pool, SegmentPool):
            _load_pool(model.pool, tree["pool"], "pool")
        _load_dense(model.head_fc, tree["head_fc"], "head_fc")
    elif isinstance(model, SolutionModel):
        _load_net(model.embedder, tree["embedder"], "embedder/")
        _load_dense(model.logits.fc, tree["DenseLogits_0"]["Dense_0"],
                    "DenseLogits_0/Dense_0")
    elif isinstance(model, SampleSolutionModel):
        _load_net(model.group, tree["group"], "group/")
    elif isinstance(model, (TransX, DeepWalk, LINE)):
        for name, table in model.named_children():
            if isinstance(table, ShardedEmbedding):
                _load_layer(table, tree[name], name)
            else:
                _load_embed(table, tree[name], name)
    elif isinstance(model, (GCNAggregator, _BaseAggregator)):
        _load_aggregator(model, tree, "")
    elif isinstance(model, (SegmentPool, AttentionPool, Set2SetPool)):
        _load_pool(model, tree, "")
    elif isinstance(model, (Embedding, SparseEmbedding, HashEmbedding,
                            ShardedEmbedding, AttLayer, LSTMLayer,
                            LSTMCell)):
        _load_layer(model, tree, "")
    else:
        _load_net(model, tree, "")
    if "cache" in params:
        _load_stores(model, params["cache"])
    return model
