"""Supervised and unsupervised GraphSAGE (reference:
examples/graphsage/run_graphsage.py; tf_euler's graphsage.py:56-115).

    python -m euler_tpu_torch.examples.graphsage.run_graphsage \\
        [--unsupervised] [--dataset cora] [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.dataflow.flows import SageDataFlow
from euler_tpu_torch.examples.common import (build_gnn, device_of,
                                             edge_type_ids, feature_dim,
                                             load_dataset, parse_flags,
                                             run_node_model, weights)
from euler_tpu_torch.models import GNNNet, ShallowEncoder, UnsuperviseModel


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--unsupervised", action="store_true")
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest)
    ds, graph = load_dataset(args)
    if known.unsupervised:
        dev, gen = device_of(args), weights()
        ets = edge_type_ids(graph, ds.train_edge_type)
        fanouts = args.fanouts or [10] * args.layers

        def tower():
            return GNNNet("sage", SageDataFlow(fanouts, [ets] * args.layers),
                          tuple([args.hidden_dim] * (args.layers + 1)),
                          ShallowEncoder(dense_names=(ds.feature_idx,)),
                          feature_dim(graph, ds.feature_idx), device=dev,
                          generator=gen)
        model = UnsuperviseModel(tower(), tower(), ets, device=dev)
        return run_node_model(args, ds, graph, model, metric="mrr")
    model = build_gnn(args, ds, graph, "sage", "sage")
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
