"""TransE, TransH, TransR and TransD knowledge-graph embeddings (reference:
examples/TransX/run_transX.py; tf_euler's transX.py:24-130).

    python -m euler_tpu_torch.examples.TransX.run_transX
        [--model transe|transh|transr|transd] [--embedding_dim 64]
        [--num_negs 8] [--margin 1.0] [--dataset fb15k]
        [--device cuda|cpu] [flags]

``run_transE``, ``run_transH``, ``run_transR`` and ``run_transD`` run it
with their model.
"""
import argparse

from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_edge_model,
                                             weights)
from euler_tpu_torch.models import kg

MODELS = {"transe": kg.TransE, "transh": kg.TransH, "transr": kg.TransR,
          "transd": kg.TransD}


def main(model_name="transe", argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", default=model_name, choices=sorted(MODELS))
    pre.add_argument("--embedding_dim", type=int, default=64)
    pre.add_argument("--num_negs", type=int, default=8)
    pre.add_argument("--margin", type=float, default=1.0)
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest, dataset="fb15k")
    ds, graph = load_dataset(args)
    model = MODELS[known.model](
        n_entities=graph.meta.n_nodes, n_relations=graph.meta.num_edge_types,
        ent_dim=known.embedding_dim, rel_dim=known.embedding_dim,
        num_negs=known.num_negs, margin=known.margin,
        device=device_of(args), generator=weights())
    return run_edge_model(args, ds, graph, model, metric="mrr")


if __name__ == "__main__":
    main()
