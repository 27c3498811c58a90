"""TransH (reference: examples/TransX/run_transH.py): run_transX with
--model transh as its default.

    python -m euler_tpu_torch.examples.TransX.run_transH [flags]
"""
from euler_tpu_torch.examples.TransX import run_transX


def main(argv=None):
    return run_transX.main("transh", argv)


if __name__ == "__main__":
    main()
