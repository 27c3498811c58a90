"""Relational GCN over every edge type of the graph, one weight matrix a
relation, drawn through the payload flow (reference:
examples/rgcn/run_rgcn.py).

    python -m euler_tpu_torch.examples.rgcn.run_rgcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.dataflow.flows import SageDataFlow
from euler_tpu_torch.examples.common import (device_of, feature_dim,
                                             load_dataset, parse_flags,
                                             run_node_model, weights)
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    dev, gen = device_of(args), weights()
    n_rel = graph.meta.num_edge_types
    ets = tuple(range(n_rel))                       # all relations
    fanouts = args.fanouts or [10] * args.layers
    net = GNNNet("relation",
                 SageDataFlow(fanouts, [ets] * args.layers, payload=True),
                 tuple([args.hidden_dim] * (args.layers + 1)),
                 ShallowEncoder(dense_names=(ds.feature_idx,)),
                 feature_dim(graph, ds.feature_idx), device=dev,
                 generator=gen, conv_kwargs={"num_relations": n_rel},
                 relation_from_etype=True)
    model = SuperviseModel(net, ds.label_idx, ds.label_dim, device=dev,
                           generator=gen)
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
