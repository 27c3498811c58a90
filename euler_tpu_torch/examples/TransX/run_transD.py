"""TransD (reference: examples/TransX/run_transD.py): run_transX with
--model transd as its default.

    python -m euler_tpu_torch.examples.TransX.run_transD [flags]
"""
from euler_tpu_torch.examples.TransX import run_transX


def main(argv=None):
    return run_transX.main("transd", argv)


if __name__ == "__main__":
    main()
