"""Find a cell's parts by name and run it once.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run (the file
  the config entry names); its ``scene.kind`` names the program-side
  builder ``scenes/<kind>.py`` and the plain reference
  ``reference/<kind>.py``;
- ``mixes/<traffic>.json``: the traffic's parameters; its ``driver``
  names ``drivers/<driver>.py``, which loads, warms up, runs the window
  and checks what the window produced;
- ``metrics/<name>.py``: a per-layer metric's reader; a metric named
  ``<base>.<part>`` that has no file of its own is read by
  ``metrics/<base>.py`` (``idle_pct.render`` and ``idle_pct.train`` by
  ``idle_pct.py``). Its unit, layer, source and the end-to-end metric it
  moves are its entry in ``BENCHMARK.json``;
- ``limits/<workload>.json``: the limit of each number the cell's check
  compares.

A later change adds a configuration, a mix, a metric or a cell by adding
such files and entries, without editing one that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
SPEC = HERE.parent / "BENCHMARK.json"


@dataclass
class Plan:
    """One cell's parts."""

    workload: str
    chips: int
    config: dict          # the configuration file's content
    config_file: Path
    mix: dict
    mix_file: Path
    driver: ModuleType
    scene: ModuleType     # the program-side builder of the config's scene
    reference: ModuleType  # the plain reference of the config's scene
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list       # (entry, reader module) of this cell's metrics
    limits: dict


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(path.read_text())


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file
    of the part of the name before its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return _module(path, "portbench_metric_" + path.stem.replace(".", "_"))


def _reports(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def plan(spec: dict, workload: str, overrides: dict | None = None) -> Plan:
    """The parts of cell ``workload``; ``overrides`` (tests) replaces keys
    of the config's ``render`` group and of the mix."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"portbench: no workload {workload!r}; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    centry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config_file = HERE.parent / centry["file"]
    config = json.loads(config_file.read_text())
    mix_file = HERE / "mixes" / f"{w['traffic']}.json"
    mix = json.loads(mix_file.read_text())
    over = overrides or {}
    config["render"].update(over.get("render", {}))
    mix.update(over.get("mix", {}))
    return Plan(
        workload=workload, chips=w["chips"], config=config,
        config_file=config_file, mix=mix, mix_file=mix_file,
        driver=importlib.import_module(f"portbench.drivers.{mix['driver']}"),
        scene=importlib.import_module(
            f"portbench.scenes.{config['scene']['kind']}"),
        reference=importlib.import_module(
            f"portbench.reference.{config['scene']['kind']}"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[(m, metric_reader(m["name"])) for m in spec["per_layer"]
                   if _reports(m, workload)],
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        v = float(v) if v is not None else math.inf
        ok = ok and math.isfinite(v) and v <= limit
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def run_cell(p: Plan, seed: int, seconds: float, trace: bool, dev,
             t_start: float, fault=None):
    """One run of a cell on ``dev``: set-up, the window, the check.
    Returns the result line's dict (the contract's keys, ``checks`` last)
    and the traffic driver's ``Run``, which ``calibrate`` asks for the
    control. ``fault`` (tests and calibration) breaks the timed path underneath."""
    import torch

    t = time.perf_counter()
    run = p.driver.Run(p, seed, dev, fault)
    t_built = time.perf_counter()
    run.setup(trace)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s: start to the cell "
          f"{t - t_start:.3f} s, the program's inputs {t_built - t:.3f} s, "
          f"warm-up {time.perf_counter() - t_built:.3f} s", file=sys.stderr,
          flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.release()
    t_check = time.perf_counter()
    ok, checks = judge(run.check(), p.limits)
    print(f"portbench: the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    metrics, extra = {}, {}
    if trace:
        reading = run.reading()
        for entry, reader in p.per_layer:
            v = reader.read(reading)
            if v is None:
                print(f"portbench: {entry['name']} found nothing to read in "
                      "this run; left out of the line", file=sys.stderr)
            else:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
        extra = {"busy_s": reading.busy_s, "window_s": reading.window_s}
        print(f"portbench: traced {reading.units_traced} units: busy "
              f"{reading.busy_s!r} s of {reading.window_s!r} s on the host "
              f"clock, {reading.events_s!r} s between CUDA events at its "
              f"ends; {reading.n_kernels} kernels, by name "
              f"{dict(sorted(reading.kernel_n.items()))}", file=sys.stderr)
    else:
        print(f"portbench: {run.describe_window()}", file=sys.stderr)
        values = dict(run.end_to_end(), setup_s=setup_s)
        for entry in p.end_to_end:
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}
    out = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": p.chips, "memory_peak_bytes": int(peak),
                      **extra}}
    if trace:
        out["breakdown"] = reading.breakdown
    out["checks"] = checks
    return out, run


def list_cells(spec: dict) -> list[str]:
    """A line a cell: its name, configuration file, mix file, driver and
    metric readers, each found by name."""
    lines = []
    for w in spec["workloads"]:
        p = plan(spec, w["name"])
        lines.append(
            f"{p.workload}: config {p.config_file.relative_to(HERE.parent)} "
            f"mix {p.mix_file.relative_to(HERE.parent)} driver "
            f"{p.driver.__name__} scene {p.scene.__name__} end_to_end "
            f"{','.join(m['name'] for m in p.end_to_end)} per_layer "
            + ",".join(f"{m['name']}={Path(r.__file__).name}"
                       for m, r in p.per_layer))
    return lines


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--list", action="store_true",
                    help="list every cell and the files found for it")
    args = ap.parse_args(argv)
    spec = load_spec()
    if args.list:
        print("\n".join(list_cells(spec)))
        return 0
    if args.workload is None:
        ap.error("--workload is required")
    p = plan(spec, args.workload)
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds

    from portbench import device

    power = device.PowerLimit()
    try:
        import torch

        if not torch.cuda.is_available():
            print("portbench: no CUDA card (torch.cuda.is_available() is "
                  "false); no result", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < p.chips:
            print(f"portbench: {p.workload} needs {p.chips} cards, "
                  f"{torch.cuda.device_count()} found; no result",
                  file=sys.stderr)
            return 3
        print(f"portbench: {p.workload} seed {args.seed} trace {args.trace} "
              f"on {torch.cuda.get_device_name(0)} (cards "
              f"{torch.cuda.device_count()}, using {p.chips}), torch "
              f"{torch.__version__}; {time.perf_counter() - t_start:.2f} s to "
              "here", file=sys.stderr, flush=True)
        out, _ = run_cell(p, args.seed, seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    finally:
        limit = power.read()
    print(f"portbench: power limit {limit}", file=sys.stderr)
    bad = device.loaded_forbidden(sys.modules)
    if bad:
        print(f"portbench: modules loaded that the run may not hold: {bad}; "
              "no result", file=sys.stderr)
        return 4
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
