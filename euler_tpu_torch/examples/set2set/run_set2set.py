"""Graph classification with GIN and set2set pooling (reference:
examples/set2set/run_set2set.py).

    python -m euler_tpu_torch.examples.set2set.run_set2set [--dataset mutag]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_graph_conv_example


def main(argv=None):
    return run_graph_conv_example("gin", pool_name="set2set", argv=argv)


if __name__ == "__main__":
    main()
