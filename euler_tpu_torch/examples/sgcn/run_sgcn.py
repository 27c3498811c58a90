"""SGCN over the whole graph (reference: examples/sgcn/run_sgcn.py).

    python -m euler_tpu_torch.examples.sgcn.run_sgcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("sgcn", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
