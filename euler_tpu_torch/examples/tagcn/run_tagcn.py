"""TAGCN over the whole graph (reference: examples/tagcn/run_tagcn.py).

    python -m euler_tpu_torch.examples.tagcn.run_tagcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("tag", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
