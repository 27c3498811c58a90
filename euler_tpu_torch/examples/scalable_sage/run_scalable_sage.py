"""Scalable GraphSAGE with per-layer historical-embedding stores, one hop
drawn a layer (reference: examples/scalable_sage/run_scalable_sage.py;
tf_euler's ScalableSageEncoder, utils/encoders.py:629-749).

    python -m euler_tpu_torch.examples.scalable_sage.run_scalable_sage
        [--dataset cora] [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, edge_type_ids,
                                             feature_dim, load_dataset,
                                             parse_flags, run_node_model,
                                             weights)
from euler_tpu_torch.models import (ScalableGNNNet, ShallowEncoder,
                                    SuperviseModel)


def main(argv=None):
    args = parse_flags(argv, num_epochs=5)
    ds, graph = load_dataset(args)
    dev, gen = device_of(args), weights()
    net = ScalableGNNNet(
        edge_types=edge_type_ids(graph, ds.train_edge_type),
        num_layers=args.layers, dim=args.hidden_dim,
        feature=ShallowEncoder(dense_names=(ds.feature_idx,)),
        in_dim=feature_dim(graph, ds.feature_idx),
        n_nodes=graph.meta.n_nodes, fanout=(args.fanouts or [10])[0],
        device=dev, generator=gen)
    model = SuperviseModel(net, ds.label_idx, ds.label_dim, device=dev,
                           generator=gen)
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
