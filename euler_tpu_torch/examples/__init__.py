"""The example runners, each run as ``python -m
euler_tpu_torch.examples.<name>.run_<name> [flags]``: the port's
counterparts of the scripts under examples/."""
