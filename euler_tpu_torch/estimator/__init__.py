"""Run loops of the port: train (with its TrainLoop), evaluate and infer."""
from euler_tpu_torch.estimator.estimator import (BaseEstimator, EdgeEstimator,
                                                 GaeEstimator, GraphEstimator,
                                                 NodeEstimator, RunConfig,
                                                 SampleEstimator, TrainLoop,
                                                 get_optimizer,
                                                 make_graph_batch)

__all__ = ["BaseEstimator", "EdgeEstimator", "GaeEstimator",
           "GraphEstimator", "NodeEstimator", "RunConfig", "SampleEstimator",
           "TrainLoop", "get_optimizer", "make_graph_batch"]
