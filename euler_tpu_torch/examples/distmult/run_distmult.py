"""DistMult, the bilinear diagonal knowledge-graph score (reference:
examples/distmult/run_distmult.py).

    python -m euler_tpu_torch.examples.distmult.run_distmult
        [--embedding_dim 64] [--num_negs 8] [--dataset fb15k]
        [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_edge_model,
                                             weights)
from euler_tpu_torch.models import DistMult


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--embedding_dim", type=int, default=64)
    pre.add_argument("--num_negs", type=int, default=8)
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest, dataset="fb15k")
    ds, graph = load_dataset(args)
    model = DistMult(n_entities=graph.meta.n_nodes,
                     n_relations=graph.meta.num_edge_types,
                     ent_dim=known.embedding_dim,
                     rel_dim=known.embedding_dim, num_negs=known.num_negs,
                     device=device_of(args), generator=weights())
    return run_edge_model(args, ds, graph, model, metric="mrr")


if __name__ == "__main__":
    main()
