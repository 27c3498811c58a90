"""Blocks and dataflows: sampled, capped-full, whole-graph and layerwise."""
from euler_tpu_torch.dataflow.block import (Block, fanout_block,
                                            full_graph_block)
from euler_tpu_torch.dataflow.flows import (FastDataFlow, GCNDataFlow,
                                            LayerwiseDataFlow, SageDataFlow,
                                            WholeDataFlow, get_flow_class)

__all__ = ["Block", "FastDataFlow", "GCNDataFlow", "LayerwiseDataFlow",
           "SageDataFlow", "WholeDataFlow", "fanout_block",
           "full_graph_block", "get_flow_class"]
