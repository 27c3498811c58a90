"""The ShardView predicate shared by every op module.

Each graph verb routes to its sharded implementation when it is handed
a ``euler_tpu_torch.parallel.sharded.ShardView`` (one rank's shard and
its process groups) instead of a one-device ``GraphTensors``. One
isinstance-based predicate lives here, so that the check cannot drift
between op modules.

The sharded module is looked up lazily, as the reference's
(euler_tpu/ops/dispatch.py:17-19): it imports the op modules, so a
top-level import here would be circular, and where it was never
imported no ShardView can exist.
"""
import sys


def is_shard_view(g) -> bool:
    mod = sys.modules.get("euler_tpu_torch.parallel.sharded")
    return mod is not None and isinstance(g, mod.ShardView)
