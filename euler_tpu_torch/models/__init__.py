"""Models of the port: encoders, convolutions, GNN nets, heads, the
knowledge-graph models, the walk models, and the layers, aggregators,
pooling, group nets, graph classifier, autoencoders, GeniePath and LGCN,
the scalable nets and the solution kit."""
from euler_tpu_torch.models.convs import (AGNNConv, APPNPConv, ARMAConv,
                                         DNAConv, GATConv, GatedConv,
                                         GCNConv, GINConv, GraphConv,
                                         GRUCell, RelationConv, SAGEConv,
                                         SGCNConv, TAGConv, get_conv_class)
from euler_tpu_torch.models.encoders import (Embed, ShallowEncoder,
                                             TypedEncoder)
from euler_tpu_torch.models.from_flax import load_flax_params
from euler_tpu_torch.models.gnn import (EmbedOnly, GNNNet, JKGNNNet,
                                        SuperviseModel, UnsuperviseModel)
from euler_tpu_torch.models.kg import (DistMult, TransD, TransE, TransH,
                                       TransR, TransX, entity_ranks,
                                       rank_all_entities)
from euler_tpu_torch.models.walk_models import LINE, DeepWalk, Node2Vec
from euler_tpu_torch.models.autoencoders import DGI, GAE, VGAE
from euler_tpu_torch.models.extra_nets import GeniePathLazyNet, LGCNNet
from euler_tpu_torch.models.graph_model import GraphModel
from euler_tpu_torch.models.group_gnn import GroupGNNNet, SharedGroupGNNNet
from euler_tpu_torch.models.layers import (AttLayer, Embedding,
                                           HashEmbedding, LSTMCell,
                                           LSTMLayer, ShardedEmbedding,
                                           SparseEmbedding)
from euler_tpu_torch.models.pooling import (AttentionPool, SegmentPool,
                                            Set2SetPool, get_pool_class)
from euler_tpu_torch.models.scalable import ScalableGNNNet, ScalableSageNet
from euler_tpu_torch.models.solution import (CosineLogits, DenseLogits,
                                             PosNegLogits,
                                             SampleSolutionModel,
                                             SolutionModel)

__all__ = ["AGNNConv", "APPNPConv", "ARMAConv", "AttLayer", "AttentionPool",
           "CosineLogits", "DGI", "DNAConv", "DeepWalk", "DenseLogits",
           "DistMult", "Embed", "EmbedOnly", "Embedding", "GAE", "GATConv",
           "GCNConv", "GINConv", "GNNNet", "GRUCell", "GatedConv",
           "GeniePathLazyNet", "GraphConv", "GraphModel", "GroupGNNNet",
           "HashEmbedding", "JKGNNNet", "LGCNNet", "LINE", "LSTMCell",
           "LSTMLayer", "Node2Vec", "PosNegLogits", "RelationConv",
           "SAGEConv", "SGCNConv", "SampleSolutionModel", "ScalableGNNNet",
           "ScalableSageNet", "SegmentPool", "Set2SetPool",
           "ShallowEncoder", "ShardedEmbedding", "SharedGroupGNNNet",
           "SolutionModel", "SparseEmbedding", "SuperviseModel", "TAGConv",
           "TransD", "TransE", "TransH", "TransR", "TransX", "TypedEncoder",
           "UnsuperviseModel", "VGAE", "entity_ranks", "get_conv_class",
           "get_pool_class", "load_flax_params", "rank_all_entities"]
