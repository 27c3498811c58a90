"""GCN over the whole graph (reference: examples/gcn/run_gcn.py).

    python -m euler_tpu_torch.examples.gcn.run_gcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("gcn", flow_name="whole", argv=argv)


if __name__ == "__main__":
    main()
