"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), then the correctness check, and the result line.

The cell's configuration module builds the system and checks the run;
the generator of the mix's kind drives it; each per-layer metric's own
file reads it. Order matters: the device's memory peak is read right
after the window, before the trace, the rooflines and the reference; the
program's state is freed before the reference runs, so that it fits
beside nothing. A run in which any step or request failed is not
correct, whatever the sample shows.
"""
from __future__ import annotations

import gc
import json
import sys
import time
import traceback
from typing import Dict, List, Optional, TextIO

import torch

import numpy as np

from benchmark.harness import drive as drive_lib
from benchmark.harness.spec import Spec

#: no module of these top-level names may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "euler_tpu")


class NoChip(RuntimeError):
    pass


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names in ``sys.modules`` that a run must not load,
    compared whole (``euler_tpu_torch`` is not ``euler_tpu``)."""
    tops = {name.split(".")[0] for name in (modules or list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader may read: the configuration, the
    mix, the system under test (still alive), the drive with its
    records, the measured window and the reduced trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> tuple:
    """(correct, rows): each compared number beside its limit; a number
    that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and bool(np.isfinite(v) and v <= limit)
        v = v if good or (v is not None and np.isfinite(v)) else None
        ok &= good
        rows.append((name, v, limit, good))
    return ok, rows


def device_info(chips: int, peak: int, trace: Optional[dict]) -> dict:
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": chips,
           "memory_peak_bytes": peak}
    if trace is not None:
        out.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", spec: Optional[Spec] = None,
        look_for_chip: bool = True, out: TextIO = sys.stdout,
        err: TextIO = sys.stderr) -> Optional[dict]:
    """Run the cell and print its result line; returns the result, or
    None after printing why there is none (no chip, a forbidden module)."""
    spec = spec or Spec()
    w = spec.workload(workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if look_for_chip and found < w["chips"]:
        raise NoChip(f"{workload} needs {w['chips']} CUDA device(s); "
                     f"found {found}")
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    limits = spec.limits(workload)
    module = spec.config_module(w["config"])
    system = module.build(cfg, seed, device)
    drv = drive_lib.make(spec, mix, system, seed)
    t_drive = time.perf_counter()
    drv.setup()
    drive_lib.sync(device)
    setup_s = time.perf_counter() - t_start
    parts = dict(getattr(system, "setup_parts", {}),
                 **{"first steps or warm-up": time.perf_counter() - t_drive})
    print("setup (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    parts.items()), file=err)

    window = drv.window(seconds)
    drive_lib.sync(device)
    if window.get("notes"):
        print(window["notes"], file=err)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = dict(window["metrics"], setup_s=setup_s, peak_mem_gb=peak / 1e9)

    prof = None
    metrics: Dict[str, dict] = {}
    if trace:
        from benchmark.harness.trace import profile_window
        prof = profile_window(drv.traced)
        ctx = Context(spec=spec, workload=w, cfg=cfg, mix=mix, system=system,
                      drive=drv, window=window, trace=prof, device=device)
        for m in spec.per_layer(workload):
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del ctx
    else:
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    evidence = drv.evidence()
    handed = system.release()
    del system, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = module.check(cfg, seed, device, handed, evidence)
    correct, rows = verdict(readings, limits)
    rows.append(("failed", window["failed"], 0, window["failed"] == 0))
    correct &= window["failed"] == 0

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=err)
        return None
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": device_info(w["chips"], peak, prof)}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim, _ in rows}
    for name, v, lim, good in rows:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if good else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_start)
    except NoChip as e:
        print(str(e), file=sys.stderr)
        return 2
    except Exception:  # the run failed: its traceback, and no result
        traceback.print_exc()
        return 1
    return 0 if res is not None else 3
