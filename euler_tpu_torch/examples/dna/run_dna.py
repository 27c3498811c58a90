"""DNA over sampled neighborhoods (reference: examples/dna/run_dna.py).

    python -m euler_tpu_torch.examples.dna.run_dna [--dataset cora]
        [--device cuda|cpu] [flags]
"""
from euler_tpu_torch.examples.common import run_conv_example


def main(argv=None):
    return run_conv_example("dna", flow_name="sage", argv=argv)


if __name__ == "__main__":
    main()
