"""GAT over the whole graph (reference: examples/gat/run_gat.py).

    python -m euler_tpu_torch.examples.gat.run_gat [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("gat", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
