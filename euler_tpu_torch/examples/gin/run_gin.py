"""Graph classification with GIN and mean pooling (reference:
examples/gin/run_gin.py).

    python -m euler_tpu_torch.examples.gin.run_gin [--dataset mutag]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_graph_conv_example


def main(argv=None):
    return run_graph_conv_example("gin", pool_name="mean", argv=argv)


if __name__ == "__main__":
    main()
