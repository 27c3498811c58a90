"""Graph classification with the gated conv and mean pooling
(reference: examples/gated_graph/run_gated_graph.py).

    python -m euler_tpu_torch.examples.gated_graph.run_gated_graph [--dataset mutag]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_graph_conv_example


def main(argv=None):
    return run_graph_conv_example("gated", pool_name="mean", argv=argv)


if __name__ == "__main__":
    main()
