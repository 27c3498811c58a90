"""Run loops of the port: train, evaluate and infer."""
from euler_tpu_torch.estimator.estimator import (BaseEstimator, EdgeEstimator,
                                                 NodeEstimator, RunConfig,
                                                 get_optimizer)

__all__ = ["BaseEstimator", "EdgeEstimator", "NodeEstimator", "RunConfig",
           "get_optimizer"]
