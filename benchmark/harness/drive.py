"""What every traffic generator shares, and how a mix finds its
generator: a mix file (``traffic/<name>.json``) names its ``kind``, and
``drives/<kind>.py`` is the one generator of that kind, general over the
mix's parameters. A generator's ``Drive(mix, system, seed)`` has
``setup()`` (the first steps or warm requests, counted as set-up),
``window(seconds)`` (the measured window: its end-to-end ``metrics``,
``attempted``, ``failed``, ``seconds`` and ``notes`` for standard
error), ``traced()`` (a short run of the same work under the profiler;
returns the units it ran) and ``evidence()`` (what the configuration's
check reads, on the host).
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Sequence

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for stream ``tag`` of run seed ``seed`` (any int)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], p: float) -> float:
    """The ``p``-th percentile by nearest rank: the smallest value with at
    least p% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(p / 100 * len(s)) - 1)]


def fifths(values: Sequence[float]) -> List[Sequence[float]]:
    """``values`` cut into five runs of about equal length, in order (to
    show on standard error how a window moved from its start to its
    end)."""
    n = len(values)
    return [values[i * n // 5:(i + 1) * n // 5] for i in range(5)]


def make(spec, mix: dict, system, seed: int):
    """The drive of ``mix`` over ``system``: ``drives/<kind>.py``'s
    ``Drive``."""
    return spec.drive_module(mix["kind"]).Drive(mix, system, seed)
