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

A flax kernel is [in, out] and loads as ``Linear.weight = kernel.T``; any
other parameter, an embedding [rows, features] included, loads as it is.
A bare ``GNNNet``, ``JKGNNNet`` or ``EmbedOnly`` takes the tree without
the ``embedder`` level. A shape that does not fit raises.
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
from euler_tpu_torch.models.encoders import Embed, ShallowEncoder
from euler_tpu_torch.models.gnn import (EmbedOnly, GNNNet, JKGNNNet,
                                        SuperviseModel, UnsuperviseModel)
from euler_tpu_torch.models.kg import TransX
from euler_tpu_torch.models.walk_models import LINE, DeepWalk

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


def _load_net(net: nn.Module, tree: Mapping, prefix: str) -> None:
    """A tower: a ``GNNNet``, a ``JKGNNNet`` or an ``EmbedOnly``."""
    if isinstance(net, EmbedOnly):
        _load_embed(net.embed, tree["Embed_0"], f"{prefix}Embed_0")
    elif isinstance(net, (GNNNet, JKGNNNet)):
        _load_gnn(net, tree, prefix)
    else:
        raise TypeError(f"no flax mapping for {type(net).__name__}")


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the flax tree ``params`` into ``model`` in place; returns it."""
    tree = params.get("params", params)
    if isinstance(model, SuperviseModel):
        _load_net(model.embedder, tree["embedder"], "embedder/")
        _load_dense(model.head_fc, tree["head_fc"], "head_fc")
    elif isinstance(model, UnsuperviseModel):
        for name in ("embedder", "context_embedder"):
            _load_net(getattr(model, name), tree[name], f"{name}/")
    elif isinstance(model, (TransX, DeepWalk, LINE)):
        for name, table in model.named_children():
            _load_embed(table, tree[name], name)
    else:
        _load_net(model, tree, "")
    return model
