"""euler_tpu_torch — the PyTorch/CUDA port of euler_tpu.

A second package beside the JAX reference ``euler_tpu``, with the same
layout (graph/, ops/, dataflow/, models/, estimator/, knn.py, serving.py,
native/) so each module has an obvious counterpart. It imports torch and
numpy, never jax or euler_tpu. Plain tensor code is PyTorch; each TPU
kernel of the reference becomes a hand-written Hopper kernel under csrc/
(built with nvcc on first use, bound with ctypes), with a plain PyTorch
version beside it that runs for CPU tensors.

Every entry point puts its state on ``torch.device("cuda")`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit
device it raises.
"""

__version__ = "0.1.0"

from euler_tpu_torch.graph import (Graph, GraphMeta, GraphTensors,
                                   convert_json_file, convert_json_graph,
                                   default_graph, initialize_graph,
                                   load_graph)
from euler_tpu_torch.query import (Query, register_udf, udf, udf_max,
                                   udf_mean, udf_min)
