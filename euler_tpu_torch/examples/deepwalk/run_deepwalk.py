"""DeepWalk: truncated random walks and skip-gram (reference:
examples/deepwalk/run_deepwalk.py; tf_euler's deepwalk.py:28-90).

    python -m euler_tpu_torch.examples.deepwalk.run_deepwalk
        [--walk_len 5] [--num_negs 8] [--embedding_dim 64]
        [--dataset cora] [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.examples.common import (device_of, edge_type_ids,
                                             load_dataset, parse_flags,
                                             run_node_model, weights)
from euler_tpu_torch.models import DeepWalk


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--walk_len", type=int, default=5)
    pre.add_argument("--num_negs", type=int, default=8)
    pre.add_argument("--embedding_dim", type=int, default=64)
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest)
    ds, graph = load_dataset(args)
    model = DeepWalk(n_nodes=graph.meta.n_nodes, dim=known.embedding_dim,
                     edge_types=edge_type_ids(graph, ds.train_edge_type),
                     walk_len=known.walk_len, num_negs=known.num_negs,
                     device=device_of(args), generator=weights())
    return run_node_model(args, ds, graph, model, metric="mrr",
                          train_node_type=-1)


if __name__ == "__main__":
    main()
