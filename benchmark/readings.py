"""The readings that the check limits of a cell are set from.

    python -m benchmark.readings --workload NAME --seeds 1,2,... \
        [--control-seeds 101,102,103] [--seconds 3] [--out FILE]

Runs the cell's timed path for a short window on each seed, as the program
(the lower readings), and with `--control-seeds` as the control (the upper
readings: the program's own int8 serving path for the generator, and the
reference's routing rounded to bfloat16 in place of the program's), each
followed by the cell's checks; one process, on the card.  Prints one JSON
line per run and the largest program and smallest control reading of each
check.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.harness import env


def main(argv=None) -> int:
    env.set_cache_dirs()
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import importlib

    import torch

    from benchmark.run import load_json, load_spec

    bench = load_json(env.ROOT, "BENCHMARK.json")
    device = env.require_cards(1)
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            spec = load_spec(bench, args.workload, seed, args.seconds, False)
            kind = importlib.import_module(f"benchmark.kinds.{spec.traffic['kind']}")
            t = time.time()
            rec = kind.run(spec, device, time.time(), control=control)
            row = {"control": control, "seed": seed, "attempted": rec.attempted, "failed": rec.failed,
                   "checks": {k: v for k, (v, _) in rec.checks.items()},
                   "diagnostics": rec.diagnostics, "seconds": time.time() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for name in rows[0]["checks"] if rows else []:
        prog = [r["checks"][name] for r in rows if not r["control"]]
        ctrl = [r["checks"][name] for r in rows if r["control"]]
        summary[name] = {"program_max": max(prog) if prog else None, "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
