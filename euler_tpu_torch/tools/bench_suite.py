"""Bench suite: one number per BASELINE.json config family on the card.

Counterpart of tools/bench_suite.py: runs ``python -m
euler_tpu_torch.bench --model <mode>`` once per mode, one after another,
each in a subprocess with a deadline; keeps the mode's last JSON line
(the pipelined phase), adds ``wall_s``, writes ``{"ts", "results"}`` to
``build/euler_tpu_torch/bench_suite.json`` (or ``--out``) and prints the
reference's markdown table.

    python -m euler_tpu_torch.tools.bench_suite [--modes sage,gat,...]
        [--deadline S] [--out PATH] [--device cpu] [--nodes N] [--batch B]

A mode that prints no JSON line, exits non-zero or runs past its deadline is
recorded as the reference records it, ``{"model", "error": "no_result",
"stderr_tail"}``, and the suite then exits 1. The port's bench reports
``vs_baseline: null``, so the "vs 1e8 target" column prints "—".
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from euler_tpu_torch._build import BUILD_DIR, REPO_ROOT

MODES = ["sage", "gat", "gin", "rgcn", "gcn", "transe"]
OUT = os.path.join(BUILD_DIR, "bench_suite.json")


def _text(b) -> str:
    return b.decode(errors="replace") if isinstance(b, bytes) else (b or "")


def run_mode(mode: str, deadline: float, extra=()) -> dict:
    """One ``euler_tpu_torch.bench`` run of ``mode`` (with ``extra``
    flags) in a subprocess killed at ``deadline`` seconds: its last JSON
    line with ``wall_s``, or the reference's no_result record."""
    t0 = time.time()
    cmd = [sys.executable, "-m", "euler_tpu_torch.bench", "--model", mode,
           *extra]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=deadline, cwd=REPO_ROOT)
        # a bench that fails after a line has no result either
        out = p.stdout if p.returncode == 0 else ""
        err = p.stderr
    except subprocess.TimeoutExpired as e:
        out = ""
        err = _text(e.stderr) + f"\nbench_suite: killed at the {deadline} s " \
            "deadline"
    last = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                last = json.loads(line)
            except ValueError:
                pass
    if last is None:
        last = {"model": mode, "error": "no_result",
                "stderr_tail": err[-500:]}
    last["wall_s"] = round(time.time() - t0, 1)
    return last


def table(results: dict) -> str:
    """The reference's markdown table of ``results``."""
    lines = ["| family | metric | value | unit | vs 1e8 target | config |",
             "|---|---|---|---|---|---|"]
    for mode, r in results.items():
        vb = r.get("vs_baseline")
        lines.append(f"| {mode} | {r.get('metric', '?')} "
                     f"| {r.get('value', 0):,.0f} | {r.get('unit', '?')} "
                     f"| {vb if vb is not None else '—'} "
                     f"| {r.get('config', '?')} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--deadline", type=float, default=600.0,
                    help="per-mode deadline seconds")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="the bench's --device (default: cuda)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)
    extra = []
    for flag, v in (("--device", args.device), ("--nodes", args.nodes),
                    ("--batch", args.batch)):
        if v is not None:
            extra += [flag, str(v)]

    results = {}
    for mode in args.modes.split(","):
        mode = mode.strip()
        if not mode:
            continue
        print(f"# running {mode} ...", flush=True)
        results[mode] = run_mode(mode, args.deadline, extra)
        print(json.dumps(results[mode]), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"ts": time.time(), "results": results}, f, indent=1)
    print(f"\nwrote {args.out}\n")
    print(table(results))
    failed = [m for m, r in results.items() if "error" in r]
    if failed:
        print(f"bench_suite: no result from {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
