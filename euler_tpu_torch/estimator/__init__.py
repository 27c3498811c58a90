"""Run loops of the port: train (with its TrainLoop), evaluate and infer."""
from euler_tpu_torch.estimator.estimator import (BaseEstimator, EdgeEstimator,
                                                 NodeEstimator, RunConfig,
                                                 TrainLoop, get_optimizer)

__all__ = ["BaseEstimator", "EdgeEstimator", "NodeEstimator", "RunConfig",
           "TrainLoop", "get_optimizer"]
