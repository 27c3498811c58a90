"""ARMA over the whole graph (reference: examples/arma/run_arma.py).

    python -m euler_tpu_torch.examples.arma.run_arma [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("arma", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
