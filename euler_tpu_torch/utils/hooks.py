"""Run hooks: logging, profiling, and the exit barrier of a multi-process
run.

Counterpart of euler_tpu/utils/hooks.py (reference: the
tf.train.LoggingTensorHook use of base_estimator.py:90-95, ProfilerHook
base_estimator.py:130-134, SyncExitHook utils/hooks.py:26-40). The trace
is torch.profiler's, written as a Chrome trace; the barrier is
torch.distributed's.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

from euler_tpu_torch.utils import trace


class LoggingHook:
    """Call ``log_fn`` with step/loss/rate at the steps ``every`` picks.

    Called with the number of steps done after every ``steps_per_call``
    steps (a loop of ``steps_per_loop``, or 1), it logs where ``step %
    every < steps_per_call``: at each multiple of ``every`` for single
    steps, and at the first call past one under loops, as the reference's
    loop does (euler_tpu/estimator/estimator.py:237). The rate counts
    from the hook's construction; ``total``, when given, follows the step
    as ``/total``.
    """

    def __init__(self, every: int = 100, log_fn: Callable = print,
                 steps_per_call: int = 1, total: Optional[int] = None):
        self.every = every
        self.log_fn = log_fn
        self.steps_per_call = steps_per_call
        self.of = f"/{total}" if total else ""
        self._t0 = time.time()

    def __call__(self, step: int, loss, batch_size: int) -> Optional[float]:
        """Log where ``step`` is due; returns the loss logged (``loss`` may
        be a tensor on the card: only a logged one is read), else None."""
        if not self.every or step % self.every >= self.steps_per_call:
            return None
        loss = float(loss)
        rate = step * batch_size / max(time.time() - self._t0, 1e-9)
        self.log_fn(f"[euler_tpu_torch] step {step}{self.of} "
                    f"loss={loss:.4f} ({rate:.0f} ex/s)")
        return loss


class ProfilerHook:
    """A torch.profiler trace of steps [start, start + steps), written to
    ``out_dir`` as a Chrome trace (``trace_<pid>_<time>.json``; open it in
    Perfetto or chrome://tracing). The CPU is traced, and the card where
    CUDA is available.

    Called with the number of steps done after each step or loop, it
    starts at the first call at or past ``start`` and stops at the first
    at or past ``start + steps``, so under ``steps_per_loop`` the window
    rounds to loop boundaries. (The reference starts at ``start``
    exactly.)

    Tracing (``utils.trace``) is on while it records, so the trace shows
    the port's spans (``loop``, ``step``, ``forward``, ``conv``, ...) as
    host annotations beside the kernels they launched: the operator's
    view of which layer a kernel or an idle stretch of the card belongs
    to (``RunConfig.profile``). The hook drops its list of spans when it
    closes.
    """

    def __init__(self, out_dir: str = "prof_dir", start: int = 10,
                 steps: int = 10):
        self.out_dir = out_dir
        self.start = start
        self.stop = start + steps
        self._prof = None
        self._tracing = contextlib.ExitStack()
        self._done = False

    def __call__(self, step: int, *_):
        if self._prof is None and not self._done and step >= self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._tracing.enter_context(trace.recording())
        elif self._prof is not None and step >= self.stop:
            self.close()

    def close(self):
        """Stop a running trace and write it."""
        if self._prof is None:
            return
        prof, self._prof, self._done = self._prof, None, True
        self._tracing.close()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class SyncExitHook:
    """Block until every process of the job reaches the end of training:
    one ``torch.distributed.barrier()`` where a process group of more than
    one rank is initialised, else nothing. The reference's polling of a
    TF variable (and euler_tpu's ``sync_global_devices``) collapses into
    the barrier."""

    def __call__(self):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            dist.barrier()
