"""Start ``world`` ranks of one function on this machine and join them.

``launch(target, world, backend=, timeout_s=, args=)`` spawns one
process a rank (the spawn start method: the caller may hold CUDA), each
joins the process group through a ``file://`` rendezvous in a directory
of its own, calls ``target(*args)`` and leaves the group. The launcher
waits for every rank until one deadline, kills every rank still alive
then, and raises with each failed rank's exit code and the end of its
traceback; else it returns each rank's return value, in rank order.

A rank's function reads its place from ``torch.distributed`` (or builds
the mesh with ``distributed.make_global_mesh``), so the same function
runs under a launcher that sets ``env://`` (torchrun) after
``distributed.initialize()``, with no ``launch``. NCCL ranks take card
``rank % device_count`` before they join; gloo ranks may share a card.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def _rank_main(target: Callable, rank: int, world: int, backend: str,
               work: str, timeout_s: float, args: Sequence) -> None:
    """One spawned rank: join, run ``target(*args)``, write its result
    (or its traceback) under ``work``, leave."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(work, "rendezvous"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(work, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def launch(target: Callable, world: int, backend: str = "gloo",
           timeout_s: float = 600.0, args: Sequence = ()) -> List[Any]:
    """Run ``target(*args)`` on ``world`` ranks of a fresh process group
    over ``backend`` and return each rank's result (it must pickle).
    ``target`` and ``args`` must pickle too: a function of a module, by
    its import path. Raises ``RuntimeError`` naming each rank that
    failed or was still running ``timeout_s`` seconds after the start
    (every such rank is killed), with its exit code and traceback."""
    if world < 1:
        raise ValueError(f"launch: world {world} < 1")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"launch: NCCL needs a card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    work = tempfile.mkdtemp(prefix="ranks_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        target, r, world, backend, work, timeout_s, tuple(args)))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in late:
            procs[r].kill()
            procs[r].join()
        errors = [f"rank {r}: still running after {timeout_s} s, killed"
                  for r in late]
        for r, p in enumerate(procs):
            if r in late or p.exitcode == 0:
                continue
            path = os.path.join(work, f"error_{r}.txt")
            tail = ""
            if os.path.exists(path):
                with open(path) as f:
                    tail = f.read()[-4000:]
            errors.append(f"rank {r}: exit code {p.exitcode}\n{tail}")
        if errors:
            raise RuntimeError(f"launch: {len(errors)} of {world} ranks "
                               f"failed\n" + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(work, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
