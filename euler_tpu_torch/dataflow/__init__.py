"""Blocks and dataflows: sampled, capped-full and whole-graph."""
from euler_tpu_torch.dataflow.block import (Block, fanout_block,
                                            full_graph_block)
from euler_tpu_torch.dataflow.flows import (GCNDataFlow, SageDataFlow,
                                            WholeDataFlow)

__all__ = ["Block", "GCNDataFlow", "SageDataFlow", "WholeDataFlow",
           "fanout_block", "full_graph_block"]
