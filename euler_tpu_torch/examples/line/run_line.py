"""LINE first- and second-order embeddings (reference:
examples/line/run_line.py).

    python -m euler_tpu_torch.examples.line.run_line [--order 1|2]
        [--embedding_dim 64] [--num_negs 8] [--dataset cora]
        [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.examples.common import (device_of, edge_type_ids,
                                             load_dataset, parse_flags,
                                             run_node_model, weights)
from euler_tpu_torch.models import LINE


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--order", type=int, default=2, choices=[1, 2])
    pre.add_argument("--embedding_dim", type=int, default=64)
    pre.add_argument("--num_negs", type=int, default=8)
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest)
    ds, graph = load_dataset(args)
    model = LINE(n_nodes=graph.meta.n_nodes, dim=known.embedding_dim,
                 edge_types=edge_type_ids(graph, ds.train_edge_type),
                 order=known.order, num_negs=known.num_negs,
                 device=device_of(args), generator=weights())
    return run_node_model(args, ds, graph, model, metric="mrr",
                          train_node_type=-1)


if __name__ == "__main__":
    main()
