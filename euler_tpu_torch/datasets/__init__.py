"""Synthetic graphs."""
from euler_tpu_torch.datasets.random_graph import random_graph
from euler_tpu_torch.datasets.synthetic import motif_graph

__all__ = ["motif_graph", "random_graph"]
