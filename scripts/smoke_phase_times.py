"""Wall seconds of each phase of ``chip_smoke.py``, for one or more checkouts.

Runs ``python3 -u chip_smoke.py`` in each given checkout, one after the
other, stamps every line of its output with the seconds since the process
started, and counts a phase from its first ``[N]`` line to the next phase's
first line (the last phase runs to the process's end, so it holds the
closing kernel line and the exit).  Writes each run's stamped log to
``<out>/<label>.log`` and prints, per run, one line of phase walls and one
JSON object with the exit code, the walls, the total and the smoke's
``launches_by_phase`` of each kernel.

    python3 scripts/smoke_phase_times.py build/parent build/change \
        build/change build/parent --labels parent change1 change2 parent2

Run it on the card: the smoke fails without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

PHASE = re.compile(r"^\[(\d+)\]")


def phase_walls(stamped):
    """(phase, seconds) in order of first appearance, from ``(t, line)``
    pairs, with a final ``(t_end, None)`` pair closing the last phase."""
    walls, current, since = [], "start", 0.0
    for t, line in stamped:
        m = PHASE.match(line) if line is not None else None
        if line is None or (m and m.group(1) != current):
            walls.append((current, t - since))
            current, since = (m.group(1) if m else None), t
    return walls


def run_one(checkout: str, label: str, out: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "chip_smoke.py"], cwd=checkout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    stamped = []
    with open(os.path.join(out, f"{label}.log"), "w") as f:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            f.write(f"{t:9.3f} {line}")
    rc = proc.wait()
    total = time.perf_counter() - t0
    walls = phase_walls(stamped + [(total, None)])
    launches = None
    for _, line in stamped:
        if line.startswith('{"kernels"'):
            launches = {k["name"]: k.get("launches_by_phase")
                        for k in json.loads(line)["kernels"]}
    return {"label": label, "checkout": checkout, "rc": rc,
            "total_s": total, "phase_s": walls, "launches_by_phase": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--labels", nargs="+")
    ap.add_argument("--out", default="build/smoke_phases")
    args = ap.parse_args(argv)
    labels = args.labels or [f"run{i}" for i in range(len(args.checkouts))]
    if len(labels) != len(args.checkouts):
        ap.error("one label for each checkout")
    os.makedirs(args.out, exist_ok=True)
    worst = 0
    for checkout, label in zip(args.checkouts, labels):
        r = run_one(checkout, label, args.out)
        walls = " ".join(f"[{p}] {s:.1f}" for p, s in r["phase_s"])
        print(f"{label}: rc {r['rc']}, total {r['total_s']:.1f} s; {walls}", flush=True)
        print(json.dumps(r), flush=True)
        worst = worst or r["rc"]
    return worst


if __name__ == "__main__":
    sys.exit(main())
