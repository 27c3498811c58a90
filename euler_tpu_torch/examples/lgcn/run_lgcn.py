"""LGCN's ranked top-k channel pooling, supervised (reference:
examples/lgcn/run_lgcn.py).

    python -m euler_tpu_torch.examples.lgcn.run_lgcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import (device_of, load_dataset,
                                             parse_flags, run_node_model,
                                             sampled_parts, weights)
from euler_tpu_torch.models import LGCNNet, SuperviseModel


def main(argv=None):
    args = parse_flags(argv)
    ds, graph = load_dataset(args)
    gen = weights()
    net = LGCNNet(**sampled_parts(args, ds, graph, gen, default_fanout=6))
    model = SuperviseModel(net, ds.label_idx, ds.label_dim,
                           device=device_of(args), generator=gen)
    return run_node_model(args, ds, graph, model)


if __name__ == "__main__":
    main()
