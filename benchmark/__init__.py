"""The port's benchmark: one cell a run (``run.py``), driven by the
entries of ``BENCHMARK.json`` and the files they name."""
