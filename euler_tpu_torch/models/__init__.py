"""Models of the port: encoder, convolution, GNN net and heads."""
from euler_tpu_torch.models.convs import (GATConv, GCNConv, GINConv,
                                         RelationConv, SAGEConv,
                                         get_conv_class)
from euler_tpu_torch.models.encoders import ShallowEncoder
from euler_tpu_torch.models.from_flax import load_flax_params
from euler_tpu_torch.models.gnn import GNNNet, SuperviseModel

__all__ = ["GATConv", "GCNConv", "GINConv", "GNNNet", "RelationConv", "SAGEConv",
           "ShallowEncoder", "SuperviseModel", "get_conv_class",
           "load_flax_params"]
