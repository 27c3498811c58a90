"""Supervised and unsupervised GraphSAGE (reference:
examples/graphsage/run_graphsage.py; tf_euler's graphsage.py:56-115).

    python -m euler_tpu_torch.examples.graphsage.run_graphsage \\
        [--unsupervised] [--dataset cora] [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.examples.common import (build_gnn, device_of,
                                             edge_type_ids, load_dataset,
                                             parse_flags, run_node_model,
                                             sampled_parts, weights)
from euler_tpu_torch.models import GNNNet, UnsuperviseModel


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--unsupervised", action="store_true")
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest)
    ds, graph = load_dataset(args)
    if known.unsupervised:
        gen = weights()
        model = UnsuperviseModel(
            *(GNNNet("sage", **sampled_parts(args, ds, graph, gen))
              for _ in range(2)),
            edge_types=edge_type_ids(graph, ds.train_edge_type),
            device=device_of(args))
        return run_node_model(args, ds, graph, model, metric="mrr")
    model = build_gnn(args, ds, graph, "sage", "sage")
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
