"""Generator of the ``requests`` kind: requests of node ids sent to the
system's ``serve`` (for the supervised GNNs ``NodeEstimator.infer``, the
answer in host memory), one at a time, in the order they arrive.

The mix's parameters:

- ``loop``: ``closed`` (``clients`` = 1: each request is sent when the
  last is answered; its latency is its call) or ``open`` (requests
  arrive on their own, at ``rate_per_s``, ``arrivals`` ``poisson``, or
  ``bursty``: ``burst`` requests at once, the bursts Poisson at
  ``rate_per_s / burst``; a request waits behind those before it, and its
  latency runs from its arrival to its answer; every request that arrives
  in the window is answered, also after its close);
- ``ids_per_request``: a number, or ``[lo, hi]`` for sizes uniform in
  that range; ``ids``: ``uniform`` over the system's ``id_range``;
- ``warm_requests`` (set-up), ``check_requests`` (the answers kept for the
  check, drawn from the seed among all the window's by reservoir
  sampling, each with the evidence the system copies as it serves it)
  and ``trace_requests`` (the traced run).

``infer_p95_ms`` is the 95th percentile of every latency in the window;
a request whose call raises counts as failed.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from benchmark.harness.drive import fifths, percentile, sub_seed


class Drive:
    def __init__(self, mix: dict, system, seed: int):
        self.open = mix["loop"] == "open"
        if not self.open and (mix["loop"] != "closed"
                              or mix.get("clients", 1) != 1):
            raise ValueError("a closed requests mix has one client")
        if mix["ids"] != "uniform":
            raise ValueError(f"ids {mix['ids']!r}: only uniform ids")
        if self.open and mix["arrivals"] not in ("poisson", "bursty"):
            raise ValueError(f"arrivals {mix['arrivals']!r}")
        self.mix, self.system, self.seed = mix, system, seed
        self.rng = np.random.default_rng(sub_seed(seed, "requests"))
        self.pick = np.random.default_rng(sub_seed(seed, "check"))
        self.arrive = np.random.default_rng(sub_seed(seed, "arrivals"))
        self.n_sent = 0
        self.samples: List[dict] = []
        self.latencies: List[float] = []

    def next_ids(self) -> np.ndarray:
        size = self.mix["ids_per_request"]
        if not isinstance(size, int):
            size = int(self.rng.integers(size[0], size[1] + 1))
        return self.rng.integers(0, self.system.id_range, size,
                                 dtype=np.int32)

    def next_gap(self) -> float:
        """Seconds from the last arrival to the next."""
        m = self.mix
        if m["arrivals"] == "poisson":
            return float(self.arrive.exponential(1.0 / m["rate_per_s"]))
        burst = m["burst"]
        if self.n_sent % burst:
            return 0.0
        return float(self.arrive.exponential(burst / m["rate_per_s"]))

    def _slot(self, i: int) -> Optional[int]:
        """Where request i of the window goes in the sample of
        ``check_requests``, or None (reservoir sampling, decided before
        the request is served)."""
        k = self.mix["check_requests"]
        if i < k:
            return i
        j = int(self.pick.integers(0, i + 1))
        return j if j < k else None

    def _run(self, seconds: Optional[float] = None,
             count: Optional[int] = None, sample: bool = False) -> dict:
        lat, failed, i = [], 0, 0
        t0 = arrival = time.perf_counter()
        while count is None or i < count:
            if self.open:
                arrival += self.next_gap()
                if seconds is not None and arrival - t0 >= seconds:
                    break
                while time.perf_counter() < arrival:
                    left = arrival - time.perf_counter()
                    if left > 1e-3:
                        time.sleep(left - 5e-4)
            elif seconds is not None and \
                    time.perf_counter() - t0 >= seconds:
                break
            ids = self.next_ids()
            self.n_sent += 1
            slot = self._slot(i) if sample else None
            start = arrival if self.open else time.perf_counter()
            try:
                ans, ev = self.system.serve(ids, keep=slot is not None)
            except RuntimeError:
                ans, ev = None, None
                failed += 1
            lat.append((time.perf_counter() - start) * 1e3)
            if slot is not None:
                s = dict(ids=ids, answer=ans, **(ev or {}))
                if slot < len(self.samples):
                    self.samples[slot] = s
                else:
                    self.samples.append(s)
            i += 1
        return dict(lat=lat, failed=failed,
                    seconds=time.perf_counter() - t0)

    def setup(self) -> None:
        self._run(count=self.mix["warm_requests"])

    def window(self, seconds: float) -> dict:
        run = self._run(seconds=seconds, sample=True)
        lat = self.latencies = run["lat"]
        notes = "p50 ms by fifths of the window: " + ", ".join(
            f"{percentile(list(part), 50):.4f}" for part in fifths(lat)
            if part)
        return dict(metrics={"infer_p95_ms": percentile(lat, 95)},
                    attempted=len(lat), failed=run["failed"],
                    seconds=run["seconds"], notes=notes)

    def traced(self) -> int:
        n = self.mix["trace_requests"]
        self._run(count=n)
        return n

    def evidence(self) -> dict:
        answers = []
        for s in self.samples:
            s = dict(s)
            if "n_ids" in s:
                s["n_ids"] = [t.cpu() for t in s["n_ids"]]
            answers.append(s)
        return {"answers": answers}
