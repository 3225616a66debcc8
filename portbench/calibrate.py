"""The readings a cell's limits are set from, in one process:

- the program's numbers on every seed (sound runs: the lower reading is
  their largest);
- the control's on the first ``--control`` seeds: the plain reference,
  computed in bfloat16, in the program's place (float32 is what the
  configurations state; TF32 would change nothing, the path has no
  matrix product);
- each fault planted in the timed path (the ``FAULTS`` of the mix's
  driver) on the first ``--faults`` seeds.

    python3 portbench/calibrate.py --workload cornell.render \\
        --seeds 11 12 13 --seconds 2 --control 3 --faults 3 \\
        --out calibrate_cornell_render.jsonl

One JSON line a run on standard output (and in ``--out``), then the
largest sound reading, the smallest control reading and the smallest
fault reading of each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(p, seed, seconds, dev, fault=None, control=False):
    """A run of the cell as the harness makes it, untraced; with
    ``control``, the control's numbers after the check."""
    import torch

    from portbench import harness

    t = time.perf_counter()
    out, run = harness.run_cell(p, seed, seconds, False, dev, t, fault)
    rec = {"seed": seed,
           "numbers": {k: c["value"] for k, c in out["checks"].items()},
           "end_to_end": {k: m["value"] for k, m in out["metrics"].items()},
           "units": out["attempted"]}
    if control:
        rec["control"] = run.control(torch.bfloat16)
    rec["run_s"] = time.perf_counter() - t
    return rec


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(prog="calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default=None,
                    help="JSON of harness.plan overrides (small CPU runs)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    p = harness.plan(harness.load_spec(), args.workload,
                     json.loads(args.overrides) if args.overrides else None)
    dev = torch.device(args.device)
    out = open(args.out, "w") if args.out else None
    recs = []

    def emit(rec):
        recs.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        emit({"run": "program", **_run(p, seed, args.seconds, dev,
                                       control=i < args.control)})
    for name, fn in p.driver.FAULTS.items():
        for seed in args.seeds[:args.faults]:
            emit({"run": f"fault {name}",
                  **_run(p, seed, args.seconds, dev, fault=fn)})
    summary = {}
    for name in p.limits:
        prog = [r["numbers"][name] for r in recs if r["run"] == "program"]
        ctrl = [r["control"][name] for r in recs if "control" in r]
        summary[name] = {"lower": max(prog), "control_min": min(ctrl or
                                                                [math.nan]),
                         "limit": p.limits[name]}
        for r in recs:
            if r["run"].startswith("fault"):
                key = r["run"].replace("fault ", "fault_min ")
                summary[name][key] = min(summary[name].get(key, math.inf),
                                         r["numbers"][name])
    emit({"summary": summary})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
