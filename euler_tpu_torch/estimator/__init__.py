"""Run loops of the port: train (with its TrainLoop), evaluate and infer,
on one device and over the mesh (``spmd``)."""
from euler_tpu_torch.estimator.estimator import (BaseEstimator, EdgeEstimator,
                                                 GaeEstimator, GraphEstimator,
                                                 NodeEstimator, RunConfig,
                                                 SampleEstimator, TrainLoop,
                                                 get_optimizer,
                                                 make_graph_batch)
from euler_tpu_torch.estimator.spmd import (SpmdEdgeEstimator, SpmdEstimator,
                                            SpmdGraphEstimator,
                                            SpmdNodeEstimator)

__all__ = ["BaseEstimator", "EdgeEstimator", "GaeEstimator",
           "GraphEstimator", "NodeEstimator", "RunConfig", "SampleEstimator",
           "SpmdEdgeEstimator", "SpmdEstimator", "SpmdGraphEstimator",
           "SpmdNodeEstimator", "TrainLoop", "get_optimizer", "make_graph_batch"]
