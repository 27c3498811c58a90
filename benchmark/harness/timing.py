"""Device time of one call, by CUDA events: a warm-up, then ``iters``
launches each after a rewrite of a 64 MiB buffer (so each starts with a
cold 50 MB L2, as the step finds the tables), queued behind a sleep
kernel so that the events time the card's work and not the host's."""
from __future__ import annotations

import statistics
from typing import Callable

import torch


def device_ms(fn: Callable[[], object], iters: int = 50) -> float:
    """Median ms of ``fn`` on the card over ``iters`` launches."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)
