"""Graph metadata, the converters, the device graph store and loading."""
from euler_tpu_torch.graph.convert import (build_csr, convert_json_file,
                                           convert_json_graph)
from euler_tpu_torch.graph.meta import (BINARY, DENSE, SPARSE, FeatureSpec,
                                        GraphMeta)
from euler_tpu_torch.graph.store import (AliasTables, Graph, GraphTensors,
                                         default_graph, initialize_graph,
                                         load_graph)
from euler_tpu_torch.graph.stream_convert import (StreamWriter,
                                                  convert_edge_list,
                                                  convert_ndjson)

__all__ = ["BINARY", "DENSE", "SPARSE", "AliasTables", "FeatureSpec",
           "Graph", "GraphMeta", "GraphTensors", "StreamWriter", "build_csr",
           "convert_edge_list", "convert_json_file", "convert_json_graph",
           "convert_ndjson", "default_graph", "initialize_graph",
           "load_graph"]
