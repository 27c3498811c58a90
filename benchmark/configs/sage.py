"""The ``sage`` configuration (``sage.json``): the port's supervised GNN
system, built by ``harness.supervised.build`` from the configuration's
sizes and the run's seed, and checked by ``harness.judge.check``
against the plain reference in ``benchmark/reference/gnn.py``."""
from benchmark.harness.judge import check
from benchmark.harness.supervised import build

__all__ = ["build", "check"]
