"""Generator of the ``train_loop`` kind: a closed loop of one client
calling the system's loop (``run_loop``, for the supervised GNNs a
reservoir redraw and then a ``TrainLoop`` of replayed steps) back to
back, waiting for each.

Set-up takes ``check_steps`` steps through the same call for the
correctness check (``first_steps``) and then ``warm_loops`` whole loops.
``train_step_ms`` is the window's time over every step it completed; a
step whose loss is not finite counts as failed. The traced run is
``trace_loops`` loops.
"""
from __future__ import annotations

import math
import time

from benchmark.harness.drive import fifths, sync


class Drive:
    def __init__(self, mix: dict, system, seed: int):
        if mix.get("loop", "closed") != "closed" or \
                mix.get("clients", 1) != 1:
            raise ValueError("a train_loop mix is one closed-loop client")
        self.mix, self.system, self.seed = mix, system, seed
        self.record = None

    def setup(self) -> None:
        self.record = self.system.first_steps(self.mix["check_steps"])
        for _ in range(self.mix["warm_loops"]):
            self.system.run_loop()
        sync(self.system.device)

    def window(self, seconds: float) -> dict:
        spl = self.system.steps_per_loop
        steps = failed = 0
        ends = []
        t0 = time.perf_counter()
        while True:
            loss = float(self.system.run_loop())     # waits for the card
            ends.append(time.perf_counter())
            steps += spl
            if not math.isfinite(loss):
                failed += spl
            if ends[-1] - t0 >= seconds:
                break
        dt = ends[-1] - t0
        loop_ms = [(b - a) * 1e3 for a, b in zip([t0] + ends, ends)]
        by_fifth = [sum(part) / (len(part) * spl) for part in
                    fifths(loop_ms) if part]
        notes = "step ms by fifths of the window: " + ", ".join(
            f"{v:.4f}" for v in by_fifth)
        return dict(metrics={"train_step_ms": dt * 1e3 / steps},
                    attempted=steps, failed=failed, seconds=dt, notes=notes)

    def traced(self) -> int:
        for _ in range(self.mix["trace_loops"]):
            self.system.run_loop()
        return self.mix["trace_loops"] * self.system.steps_per_loop

    def evidence(self) -> dict:
        return {"steps": self.record}
