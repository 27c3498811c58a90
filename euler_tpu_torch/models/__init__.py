"""Models of the port: encoders, convolutions, GNN nets, heads, the
knowledge-graph models and the walk models."""
from euler_tpu_torch.models.convs import (AGNNConv, APPNPConv, ARMAConv,
                                         DNAConv, GATConv, GatedConv,
                                         GCNConv, GINConv, GraphConv,
                                         GRUCell, RelationConv, SAGEConv,
                                         SGCNConv, TAGConv, get_conv_class)
from euler_tpu_torch.models.encoders import Embed, ShallowEncoder
from euler_tpu_torch.models.from_flax import load_flax_params
from euler_tpu_torch.models.gnn import (EmbedOnly, GNNNet, JKGNNNet,
                                        SuperviseModel, UnsuperviseModel)
from euler_tpu_torch.models.kg import (DistMult, TransD, TransE, TransH,
                                       TransR, TransX, entity_ranks,
                                       rank_all_entities)
from euler_tpu_torch.models.walk_models import LINE, DeepWalk, Node2Vec

__all__ = ["AGNNConv", "APPNPConv", "ARMAConv", "DNAConv", "DeepWalk",
           "DistMult", "Embed", "EmbedOnly", "GATConv", "GCNConv", "GINConv",
           "GNNNet", "GRUCell", "GatedConv", "GraphConv", "JKGNNNet", "LINE",
           "Node2Vec", "RelationConv", "SAGEConv", "SGCNConv",
           "ShallowEncoder", "SuperviseModel", "TAGConv", "TransD",
           "TransE", "TransH", "TransR", "TransX", "UnsuperviseModel",
           "entity_ranks", "get_conv_class", "load_flax_params",
           "rank_all_entities"]
