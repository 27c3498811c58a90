"""Deep Graph Infomax over a GCN of sampled neighborhoods (reference:
examples/dgi/run_dgi.py).

    python -m euler_tpu_torch.examples.dgi.run_dgi [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_node_model,
                                             sampled_parts, weights)
from euler_tpu_torch.models import DGI, GNNNet


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    gen = weights()
    net = GNNNet("gcn", **sampled_parts(args, ds, graph, gen))
    model = DGI(net, device=device_of(args), generator=gen)
    return run_node_model(args, ds, graph, model, metric="mrr")


if __name__ == "__main__":
    main()
