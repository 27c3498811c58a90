"""The solution kit's unsupervised form: two GraphSAGE towers as one
GroupGNNNet, PosNegLogits, xent_loss and the typed samplers, 5 negatives
a root (reference: examples/sample_solution/run_sample_solution.py).

    python -m euler_tpu_torch.examples.sample_solution.run_sample_solution
        [--dataset cora] [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, edge_type_ids,
                                             load_dataset, parse_flags,
                                             run_node_model, sampled_parts,
                                             weights)
from euler_tpu_torch.models import (GNNNet, GroupGNNNet,
                                    SampleSolutionModel)


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    dev, gen = device_of(args), weights()
    towers = [GNNNet("sage", **sampled_parts(args, ds, graph, gen))
              for _ in range(2)]
    model = SampleSolutionModel(
        GroupGNNNet(towers, device=dev),
        edge_types=edge_type_ids(graph, ds.train_edge_type), num_negs=5,
        device=dev)
    return run_node_model(args, ds, graph, model, metric="mrr")


if __name__ == "__main__":
    main()
