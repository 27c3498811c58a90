"""TransE (reference: examples/TransX/run_transE.py): run_transX with
--model transe as its default.

    python -m euler_tpu_torch.examples.TransX.run_transE [flags]
"""
from euler_tpu_torch.examples.TransX import run_transX


def main(argv=None):
    return run_transX.main("transe", argv)


if __name__ == "__main__":
    main()
