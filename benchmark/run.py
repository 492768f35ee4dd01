"""Run one cell of the benchmark once and print one JSON line.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Everything about a cell is found by name from `BENCHMARK.json`: its
configuration file (`configs/`), its traffic mix (`traffic/<traffic>.json`,
whose `kind` names the runner under `kinds/`), the limits of its checks
(`checks/<workload>.json`) and the reader of each metric
(`metrics/<metric>.py`).  With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics.  The run exits
with another code than 0, and prints no result, without the cards the cell
asks for, or when JAX or the JAX package is loaded once the window has
closed.  Each compared number and its limit are the last lines on standard
error and the last key of the result line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass

if __package__ in (None, ""):  # run as a file: the checkout is the import root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import env  # noqa: E402


@dataclass
class Spec:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec(bench: dict, workload: str, seed: int, seconds: float, trace: bool, root: str = env.ROOT) -> Spec:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        env.fail(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return Spec(name=workload, cell=cell, config=load_json(root, cfg_entry["file"]),
                traffic=load_json(root, "benchmark", "traffic", f"{cell['traffic']}.json"),
                limits=load_json(root, "benchmark", "checks", f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace)


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: its end-to-end ones, or with `trace` its
    per-layer ones (listed for it, or without a list and moving an
    end-to-end metric that it reports)."""
    def reported(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: str = env.ROOT):
    """`read(record)` of `metrics/<name>.py`."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, record, root: str = env.ROOT) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def is_correct(record) -> bool:
    """No request failed, there was something to check, and every compared number is within its limit."""
    return record.failed == 0 and bool(record.checks) and all(v <= lim for v, lim in record.checks.values())


def main(argv=None) -> int:
    t_start = env.process_start_time()
    env.set_cache_dirs()
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)

    bench = load_json(env.ROOT, "BENCHMARK.json")
    spec = load_spec(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    device = env.require_cards(spec.cell["chips"])
    import torch

    kind = importlib.import_module(f"benchmark.kinds.{spec.traffic['kind']}")
    record = kind.run(spec, device, t_start)

    found = env.forbidden_modules()
    if found:
        env.fail(f"JAX or the JAX package is loaded in the process: {', '.join(found)}")
    metrics = read_metrics(metrics_of(bench, spec.name, spec.trace), record)
    result = {
        "correct": is_correct(record),
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": spec.cell["chips"], "memory_peak_bytes": record.memory_peak_bytes},
    }
    if spec.trace and record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    info = env.card_info()
    for note in record.notes[:20]:
        print(f"note: {note}", file=sys.stderr)
    for k, v in record.diagnostics.items():
        print(f"diagnostic (not compared) {k}: {v!r}", file=sys.stderr)
    print(f"card: {info.get('name', '?')}, power limit {info.get('power_limit', '?')}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in record.checks.items()}
    for k, (v, lim) in record.checks.items():
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
