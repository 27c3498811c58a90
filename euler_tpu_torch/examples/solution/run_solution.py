"""The solution kit's supervised head: GraphSAGE, DenseLogits and the
sigmoid loss (reference: examples/solution/run_solution.py).

    python -m euler_tpu_torch.examples.solution.run_solution
        [--dataset cora] [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_node_model,
                                             sampled_parts, weights)
from euler_tpu_torch.models import GNNNet, SolutionModel


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    gen = weights()
    net = GNNNet("sage", **sampled_parts(args, ds, graph, gen))
    model = SolutionModel(net, ds.label_idx, ds.label_dim,
                          device=device_of(args), generator=gen)
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
