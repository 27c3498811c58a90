"""The traced window: torch.profiler over a short run of the cell's own
work, reduced to the device's busy time, its operations by time and its
idle gaps by what the host was doing.

Busy time is the union of the device's kernel and copy intervals inside
the window (overlapping operations count once), so the idle share is
``1 - busy / window``.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "benchmark.window"
TOP = 10


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Tuple[float, float]], w0: float, w1: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [w0, w1) outside the merged ``busy``."""
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def host_at(cpu: List[Tuple[float, float, str]], starts: List[float],
            t: float, look: int = 256) -> str:
    """The innermost host operation running at time ``t`` (the one that
    started last among those still open), or ``"host idle"``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        a, b, name = cpu[j]
        if b > t:
            return name
    return "host idle"


def reduce_events(dev: List[Tuple[float, float, str]],
                  cpu: List[Tuple[float, float, str]],
                  w0: float, w1: float) -> Dict:
    """Busy and window seconds, device operations by summed time and idle
    gaps by host operation, from device and host intervals (in us) and
    the window's bounds (in us)."""
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in dev
               if b > w0 and a < w1]
    busy = merge(clipped)
    busy_us = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = {}
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    cpu = sorted(cpu)
    starts = [a for a, _, _ in cpu]
    by_host: Dict[str, float] = {}
    for a, b in gaps(busy, w0, w1):
        name = host_at(cpu, starts, a)
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    kernels = sum(1 for _, _, n in dev
                  if not n.startswith(("Memcpy", "Memset")))
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                device_ops=[[n, us / 1e6] for n, us in top],
                idle_gaps=[[n, us / 1e6] for n, us in idle],
                kernels=kernels, device_events=len(dev))


def profile_window(fn: Callable[[], int]) -> Dict:
    """Run ``fn`` (which returns how many steps or requests it ran) under
    torch.profiler, waiting for the card inside the window; returns
    ``reduce_events``' figures and ``units``, ``fn``'s count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            units = fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    dev, cpu, win = [], [], None
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW and not getattr(e, "is_user_annotation",
                                                False):
                dev.append(r)
        elif e.name == WINDOW:
            win = r
        else:
            cpu.append(r)
    if win is None:
        raise RuntimeError("the profiler kept no window annotation")
    out = reduce_events(dev, cpu, win[0], win[1])
    out.update(units=units, host_s=host_s)
    return out
