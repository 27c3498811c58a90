"""APPNP over the whole graph (reference: examples/appnp/run_appnp.py).

    python -m euler_tpu_torch.examples.appnp.run_appnp [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("appnp", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
