"""Datasets: the synthetic graphs and the named datasets of the
reference's registry."""
from euler_tpu_torch.datasets.random_graph import random_graph
from euler_tpu_torch.datasets.registry import (ML1M, PPI, WN18, FB15K,
                                               FB15K237, Citeseer, Cora,
                                               Mutag, NamedDataset, Pubmed,
                                               Reddit, get_dataset)
from euler_tpu_torch.datasets.synthetic import (MotifDataset, SBMDataset,
                                                motif_graph)

__all__ = ["Citeseer", "Cora", "FB15K", "FB15K237", "ML1M", "MotifDataset",
           "Mutag", "NamedDataset", "PPI", "Pubmed", "Reddit", "SBMDataset",
           "WN18", "get_dataset", "motif_graph", "random_graph"]
