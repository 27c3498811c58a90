"""Config/flag plumbing.

A copy of euler_tpu/utils/config.py (reference:
euler/client/graph_config.{h,cc} — "k=v;k=v" string or dict with typed
getters, parsed on the python side at
tf_euler/python/euler_ops/base.py:50-60; tf_euler/python/utils/flags.py
``set_defaults``); stdlib only but for ``parse_mesh_flag``, which counts
the ranks of the process group (one a device) where the reference
counts jax's devices. ``--device`` (the port's own) picks the card or
the CPU.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Union


class GraphConfig:
    """Typed k=v config ('a=1;b=x' string or dict)."""

    def __init__(self, conf: Union[str, Dict[str, Any], None] = None):
        self._kv: Dict[str, str] = {}
        if isinstance(conf, str):
            for item in conf.split(";"):
                item = item.strip()
                if not item:
                    continue
                if "=" not in item:
                    raise ValueError(f"bad config item {item!r}")
                k, v = item.split("=", 1)
                self._kv[k.strip()] = v.strip()
        elif isinstance(conf, dict):
            self._kv = {str(k): str(v) for k, v in conf.items()}

    def get_string(self, key: str, default: str = "") -> str:
        return self._kv.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._kv.get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._kv.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._kv.get(key)
        if v is None:
            return default
        return v.lower() in ("1", "true", "yes")

    def add(self, key: str, value: Any) -> "GraphConfig":
        self._kv[str(key)] = str(value)
        return self

    def __contains__(self, key):
        return key in self._kv

    def __str__(self):
        return ";".join(f"{k}={v}" for k, v in sorted(self._kv.items()))


def define_run_flags(parser: Optional[argparse.ArgumentParser] = None
                     ) -> argparse.ArgumentParser:
    """The common example-runner flag set
    (reference: run_gcn.py:30-42 define_network_flags)."""
    p = parser or argparse.ArgumentParser()
    p.add_argument("--dataset", default="sbm")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--hidden_dim", type=int, default=32)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--fanouts", type=int, nargs="*", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--total_steps", type=int, default=0,
                   help="overrides num_epochs when > 0")
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--model_dir", default="ckpt")
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adagrad", "sgd", "momentum"])
    p.add_argument("--run_mode", default="train",
                   choices=["train", "evaluate", "infer",
                            "train_and_evaluate"])
    p.add_argument("--infer_dir", default=None)
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of training")
    p.add_argument("--mesh", default=None,
                   help="train over a (data, graph) mesh of ranks, one "
                        "process a rank: 'data=D,graph=G', 'DxG', or "
                        "'auto' (graph axis = every rank). Requires D*G "
                        "== the rank count (a launcher's WORLD_SIZE; 1 "
                        "runs in this process); the reference's "
                        "equivalent is dist_tf_euler.sh PS/worker launch")
    p.add_argument("--device", default="cuda",
                   help="the device to run on: cuda (default; it must "
                        "exist) or cpu")
    return p


def parse_mesh_flag(spec):
    """'data=D,graph=G' | 'DxG' | 'auto' -> (data, graph) axis sizes,
    whose product must be the rank count (one rank a device): the
    process group's size, else the launcher's ``WORLD_SIZE``, else 1.
    'auto' is 1 x the rank count."""
    import os

    import torch.distributed as dist
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if spec in ("auto", ""):
        return 1, n
    if "=" in spec:
        kv = dict(part.split("=") for part in spec.split(","))
        d, g = int(kv.get("data", 1)), int(kv.get("graph", 1))
    else:
        d, g = (int(x) for x in spec.lower().split("x"))
    if d * g != n:
        raise ValueError(f"--mesh {spec}: {d}x{g} != rank count {n}")
    return d, g


_DEFAULTS: Dict[str, Any] = {}


def set_defaults(**kwargs):
    """reference: tf_euler/python/utils/flags.py set_defaults."""
    _DEFAULTS.update(kwargs)


def apply_defaults(args: argparse.Namespace) -> argparse.Namespace:
    for k, v in _DEFAULTS.items():
        if hasattr(args, k):
            setattr(args, k, v)
    return args
