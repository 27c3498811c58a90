"""FastGCN importance sampling over shared layers
(reference: examples/fastgcn/run_fastgcn.py).

    python -m euler_tpu_torch.examples.fastgcn.run_fastgcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("gcn", flow_name="fast", argv=argv)


if __name__ == "__main__":
    main()
