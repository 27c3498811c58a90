"""Shared example runner: the port's counterpart of examples/common.py.

flags -> ``get_dataset(...).load_graph(device=)`` -> model ->
``NodeEstimator``/``EdgeEstimator``/``GraphEstimator`` -> train,
evaluate, infer or train_and_evaluate (reference: examples/common.py;
examples/gcn/run_gcn.py:45-89 of tf_euler). Every example script builds
its model from the port's pieces and hands it to ``run_node_model``,
``run_edge_model`` or ``run_graph_model``. ``--device`` picks the card
(default ``cuda``, which must exist) or ``cpu``. ``--mesh`` trains over
a (data, graph) mesh of ranks with ``SpmdNode/Edge/GraphEstimator``, as
the reference's ``_make_mesh`` does (examples/common.py:28-100): each
rank runs the script, joined by a launcher's ``env://`` variables
(``torchrun --nproc-per-node 4 -m ... --mesh 1x4``); ``auto`` (1 x the
rank count) and ``1x1`` without a launcher run in this process as a
one-rank group, which the runner leaves at its end. The graph loads on
the host and each rank places its own shard on its device. Model
weights come from a CPU generator seeded with 0.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.dataflow import flows
from euler_tpu_torch.datasets import get_dataset
from euler_tpu_torch.estimator import (EdgeEstimator, GraphEstimator,
                                       NodeEstimator, RunConfig,
                                       SpmdEdgeEstimator, SpmdGraphEstimator,
                                       SpmdNodeEstimator)
from euler_tpu_torch.models import (AttentionPool, GNNNet, GraphModel,
                                    JKGNNNet, SegmentPool, Set2SetPool,
                                    ShallowEncoder, SuperviseModel)
from euler_tpu_torch.parallel import distributed, mesh as mesh_lib
from euler_tpu_torch.utils.config import (apply_defaults, define_run_flags,
                                          parse_mesh_flag)

__all__ = ["build_gnn", "edge_type_ids", "feature_dim", "get_dataset",
           "kg_test_triples", "kg_test_triples_meta", "load_dataset",
           "make_config", "parse_flags", "run_conv_example",
           "run_edge_model", "run_graph_conv_example", "run_graph_model",
           "run_node_model", "sampled_parts", "weights"]


def parse_flags(argv=None, **defaults):
    """The flag kit's flags, then ``defaults`` where a flag was left at
    its default."""
    p = define_run_flags()
    args = apply_defaults(p.parse_args(argv))
    for k, v in defaults.items():
        if getattr(args, k, None) in (None, p.get_default(k)):
            setattr(args, k, v)
    return args


def mesh_of(args):
    """None without ``--mesh``; else this rank's ``Mesh``, made once a run
    (and its process group, where none exists: a launcher's ``env://``
    for more than one rank, a one-rank group in this process for one)."""
    if getattr(args, "mesh", None) is None:
        return None
    if getattr(args, "_mesh", None) is None:
        dev = resolve_device(args.device)
        d, g = parse_mesh_flag(args.mesh)
        if not dist.is_initialized():
            if d * g == 1:
                args._rendezvous = tempfile.mkdtemp(prefix="mesh_")
                distributed.initialize(
                    "file://" + os.path.join(args._rendezvous, "store"),
                    world_size=1, rank=0, device=dev)
            else:
                distributed.initialize(device=dev)
        args._mesh = mesh_lib.make_mesh(d, g, device=dev)
    return args._mesh


def close_mesh(args) -> None:
    """Leave the one-rank group that ``mesh_of`` made, if it made one."""
    where = getattr(args, "_rendezvous", None)
    if where is not None:
        mesh_lib.close()
        shutil.rmtree(where, ignore_errors=True)
        args._rendezvous = args._mesh = None


def device_of(args) -> torch.device:
    """``--device``; under ``--mesh``, this rank's device."""
    mesh = mesh_of(args)
    return resolve_device(args.device) if mesh is None else mesh.device


def load_dataset(args):
    """(dataset, graph): ``args.dataset`` under ``args.data_dir``, loaded
    onto ``--device`` (on the host under ``--mesh``: each rank then
    places its own shard)."""
    dev = torch.device("cpu") if mesh_of(args) is not None \
        else device_of(args)
    ds = get_dataset(args.dataset, args.data_dir)
    return ds, ds.load_graph(device=dev)


def weights() -> torch.Generator:
    """The generator the examples draw their weights from."""
    return torch.Generator().manual_seed(0)


def feature_dim(graph, name: str) -> int:
    """The width of dense node feature ``name`` in ``graph``: the
    encoder's input width (flax infers it at the first call)."""
    return graph.meta.node_feature(name).dim


def make_config(args, ds, metric="f1"):
    total = args.total_steps or max(
        1, (getattr(ds, "total_size", 0) + 1) // args.batch_size *
        args.num_epochs)
    return RunConfig(model_dir=args.model_dir,
                     batch_size=args.batch_size,
                     total_steps=total,
                     optimizer=args.optimizer,
                     learning_rate=args.learning_rate,
                     log_steps=args.log_steps,
                     metric=metric,
                     profile=args.profile)


def run_node_model(args, ds, graph, model, metric="f1",
                   train_node_type=None):
    cfg = make_config(args, ds, metric)
    tnt = train_node_type if train_node_type is not None \
        else ds.train_node_type
    if isinstance(tnt, str):
        tnt = graph.meta.node_type_id(tnt)
    mesh = mesh_of(args)
    if mesh is not None:
        est = SpmdNodeEstimator(model, graph, cfg, train_node_type=tnt,
                                mesh=mesh)
    else:
        est = NodeEstimator(model, graph, cfg, train_node_type=tnt,
                            device=device_of(args))
    return _dispatch(args, ds, est)


def run_edge_model(args, ds, graph, model, metric="mrr",
                   train_edge_type=-1):
    cfg = make_config(args, ds, metric)
    mesh = mesh_of(args)
    if mesh is not None:
        est = SpmdEdgeEstimator(model, graph, cfg,
                                train_edge_type=train_edge_type, mesh=mesh)
    else:
        est = EdgeEstimator(model, graph, cfg,
                            train_edge_type=train_edge_type,
                            device=device_of(args))
    return _dispatch(args, ds, est)


def run_graph_model(args, ds, graph, model, label_name="label",
                    num_classes=2):
    cfg = make_config(args, ds, "accuracy")
    mesh = mesh_of(args)
    if mesh is not None:
        est = SpmdGraphEstimator(model, graph, cfg, label_name=label_name,
                                 num_classes=num_classes, mesh=mesh)
    else:
        est = GraphEstimator(model, graph, cfg, label_name=label_name,
                             num_classes=num_classes,
                             device=device_of(args))
    return _dispatch(args, ds, est)


def kg_test_triples(ds, graph) -> np.ndarray:
    """(head, rel, tail) dataset triples -> [T,3] (src, dst, etype) model
    batches, mapping raw relation indices through the graph's type table."""
    return kg_test_triples_meta(ds, graph.meta)


def kg_test_triples_meta(ds, meta) -> np.ndarray:
    hrt = np.asarray(ds.test_triples, np.int64)
    rel_to_type = np.asarray([meta.edge_type_id(f"r{r}")
                              for r in range(meta.num_edge_types)])
    return np.stack([hrt[:, 0], hrt[:, 2], rel_to_type[hrt[:, 1]]],
                    axis=1).astype(np.int32)


def _eval_ids(ds, est):
    """The evaluation input: test triples for edge models with a KG
    dataset, node or graph ids otherwise."""
    if isinstance(est, (EdgeEstimator, SpmdEdgeEstimator)) and \
            hasattr(ds, "test_triples"):
        return kg_test_triples(ds, est.graph)
    return ds.test_ids


def _dispatch(args, ds, est):
    try:
        return _run_mode(args, ds, est)
    finally:
        close_mesh(args)


def _run_mode(args, ds, est):
    if args.run_mode == "train":
        out = est.train()
    elif args.run_mode == "evaluate":
        out = est.evaluate(_eval_ids(ds, est))
    elif args.run_mode == "infer":
        out_dir = args.infer_dir or args.model_dir
        emb = est.infer(ds.test_ids, out_dir=out_dir)
        out = {"embeddings": emb.shape}
    else:
        out = est.train_and_evaluate(_eval_ids(ds, est))
    if args.run_mode in ("evaluate", "train_and_evaluate") and \
            isinstance(est, (EdgeEstimator, SpmdEdgeEstimator)) and \
            hasattr(ds, "test_triples"):
        # full-entity ranking: the protocol behind the reference's FB15k
        # MeanRank/Hit@10 table (examples/TransX/README.md)
        out.update(est.evaluate_ranking(kg_test_triples(ds, est.graph)))
    print(f"[euler_tpu_torch] {args.run_mode} done: {out}")
    return out


def edge_type_ids(graph, names):
    return tuple(graph.meta.edge_type_id(n) for n in names)


def build_gnn(args, ds, graph, conv: str, flow_name: str = "sage",
              conv_kwargs=None, jk: bool = False):
    """conv-based supervised GNN on the dataset contract (the
    SupervisedGCN/SAGE/... pattern of every reference example)."""
    ets = edge_type_ids(graph, ds.train_edge_type)
    layers = args.layers
    fanouts = args.fanouts or [10] * layers
    flow_cls = flows.get_flow_class(flow_name)
    if flow_name in ("full", "gcn", "sage", "sample"):
        flow = flow_cls(fanouts[:layers], [ets] * layers)
    elif flow_name == "whole":
        flow = flow_cls(layers, [ets] * layers)
    else:  # layerwise / fast / adapt
        flow = flow_cls([max(64, args.batch_size)] * layers, [ets] * layers)
    dev, gen = device_of(args), weights()
    feat = ShallowEncoder(dense_names=(ds.feature_idx,))
    dims = tuple([args.hidden_dim] * layers + [args.hidden_dim])
    in_dim = feature_dim(graph, ds.feature_idx)
    if jk:
        net = JKGNNNet(conv, flow, dims, feat, in_dim, device=dev,
                       generator=gen, conv_kwargs=conv_kwargs or {})
    else:
        net = GNNNet(conv, flow, dims, feat, in_dim, device=dev,
                     generator=gen, conv_kwargs=conv_kwargs or {})
    return SuperviseModel(net, ds.label_idx, ds.label_dim, device=dev,
                          generator=gen)


def sampled_parts(args, ds, graph, gen: torch.Generator,
                  default_fanout: int = 10) -> dict:
    """The keyword arguments of a net over sampled neighborhoods, as the
    reference's scripts build them: ``SageDataFlow`` of ``--fanouts``
    (``default_fanout`` a layer without it) over the dataset's train edge
    types, ``--hidden_dim`` at every layer and the output, a
    ``ShallowEncoder`` of the dataset's feature (its width from the
    graph), ``--device`` and the weights' generator ``gen`` (towers of
    one model share it)."""
    ets = edge_type_ids(graph, ds.train_edge_type)
    fanouts = args.fanouts or [default_fanout] * args.layers
    return dict(flow=flows.SageDataFlow(fanouts, [ets] * args.layers),
                dims=tuple([args.hidden_dim] * (args.layers + 1)),
                feature=ShallowEncoder(dense_names=(ds.feature_idx,)),
                in_dim=feature_dim(graph, ds.feature_idx),
                device=device_of(args), generator=gen)


def run_conv_example(conv: str, flow_name: str = "sage", conv_kwargs=None,
                     argv=None, **flag_defaults):
    args = parse_flags(argv, **flag_defaults)
    ds, graph = load_dataset(args)
    model = build_gnn(args, ds, graph, conv, flow_name, conv_kwargs)
    return run_node_model(args, ds, graph, model)


def run_graph_conv_example(conv: str, pool_name: str = "mean", argv=None,
                           **flag_defaults):
    """Graph-classification runner (the GIN/set2set/gated_graph pattern,
    reference: examples/gin, examples/set2set)."""
    flag_defaults.setdefault("dataset", "mutag")
    args = parse_flags(argv, **flag_defaults)
    ds, graph = load_dataset(args)
    dev, gen = device_of(args), weights()
    ets = (0,)
    fanouts = args.fanouts or [5] * args.layers
    h = args.hidden_dim
    net = GNNNet(conv, flows.SageDataFlow(fanouts[:args.layers],
                                          [ets] * args.layers),
                 tuple([h] * (args.layers + 1)),
                 ShallowEncoder(dense_names=(ds.feature_idx,)),
                 feature_dim(graph, ds.feature_idx), device=dev,
                 generator=gen)
    # the pool's segments are the graphs of one rank's batch: under
    # --mesh each rank pools its own slice
    mesh = mesh_of(args)
    pool_graphs = args.batch_size // (1 if mesh is None else mesh.size)
    if pool_name == "set2set":
        pool = Set2SetPool(h, pool_graphs, h, generator=gen)
    elif pool_name == "attention":
        pool = AttentionPool(h, pool_graphs, generator=gen)
    else:
        pool = SegmentPool(h, pool_graphs, pool_name)
    model = GraphModel(net, pool, ds.num_classes, device=dev, generator=gen)
    return run_graph_model(args, ds, graph, model, label_name=ds.label_idx,
                           num_classes=ds.num_classes)
