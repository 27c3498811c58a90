"""Graph classification with GCN and mean pooling (reference:
examples/graphgcn/run_graphgcn.py).

    python -m euler_tpu_torch.examples.graphgcn.run_graphgcn [--dataset mutag]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_graph_conv_example


def main(argv=None):
    return run_graph_conv_example("gcn", pool_name="mean", argv=argv)


if __name__ == "__main__":
    main()
