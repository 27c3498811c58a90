"""TransR (reference: examples/TransX/run_transR.py): run_transX with
--model transr as its default.

    python -m euler_tpu_torch.examples.TransX.run_transR [flags]
"""
from euler_tpu_torch.examples.TransX import run_transX


def main(argv=None):
    return run_transX.main("transr", argv)


if __name__ == "__main__":
    main()
