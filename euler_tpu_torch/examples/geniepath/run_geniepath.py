"""GeniePath's adaptive receptive field, supervised (reference:
examples/geniepath/run_geniepath.py).

    python -m euler_tpu_torch.examples.geniepath.run_geniepath
        [--dataset cora] [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_node_model,
                                             sampled_parts, weights)
from euler_tpu_torch.models import GeniePathLazyNet, SuperviseModel


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    gen = weights()
    net = GeniePathLazyNet(**sampled_parts(args, ds, graph, gen))
    model = SuperviseModel(net, ds.label_idx, ds.label_dim,
                           device=device_of(args), generator=gen)
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
