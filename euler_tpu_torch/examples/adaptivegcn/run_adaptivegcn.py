"""Adaptive (layerwise) GCN over shared sampled layers
(reference: examples/adaptivegcn/run_adaptivegcn.py).

    python -m euler_tpu_torch.examples.adaptivegcn.run_adaptivegcn [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("gcn", flow_name="layerwise", argv=argv)


if __name__ == "__main__":
    main()
