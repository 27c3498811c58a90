"""Graph autoencoder, and with --variational its variational form, over
a GCN of sampled neighborhoods (reference: examples/gae/run_gae.py).

    python -m euler_tpu_torch.examples.gae.run_gae [--variational]
        [--dataset cora] [--device cuda|cpu] [flags]
"""
import argparse

from euler_tpu_torch.examples.common import (device_of, edge_type_ids,
                                             load_dataset, parse_flags,
                                             run_node_model, sampled_parts,
                                             weights)
from euler_tpu_torch.models import GAE, VGAE, GNNNet


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--variational", action="store_true")
    known, rest = pre.parse_known_args(argv)
    args = parse_flags(rest)
    ds, graph = load_dataset(args)
    gen = weights()
    net = GNNNet("gcn", **sampled_parts(args, ds, graph, gen))
    cls = VGAE if known.variational else GAE
    model = cls(net, edge_types=edge_type_ids(graph, ds.train_edge_type),
                device=device_of(args), generator=gen)
    return run_node_model(args, ds, graph, model, metric="mrr")


if __name__ == "__main__":
    main()
