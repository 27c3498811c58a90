"""AGNN over the whole graph (reference: examples/agnn/run_agnn.py).

    python -m euler_tpu_torch.examples.agnn.run_agnn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("agnn", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
