#!/usr/bin/env python3
"""The port's training run of record at the reference batch, and its tables.

  python3 scripts/torch_training_run.py run --out OUT_DIR [--kimg 32] [--resume_kimg 36]
  python3 scripts/torch_training_run.py summarize docs/runs/torch_h100

`run` (one NVIDIA GPU): in a scratch directory on the machine,
`cli.train --synthetic 512 --batch 96 --accum 3 --kimg 32 --aug ada
--kimg_per_tick 4 --img_snap 4 --snap 2` (the fashion preset, full width,
bf16, ADA; the JAX run of record's command with the card's microbatch of
32 and a snapshot every 8 kimg), then a continuation from its
`train-state-latest.pt` to `--resume_kimg`, then `cli.eval_run_snapshots`
over both run directories.  Everything printed goes to `log.txt` as well
(`utils.Logger`).  Into `--out` it copies only what is small enough to
keep: each run's `stats.jsonl` and `training_options.json` (`main/`,
`resume/`), the evaluation lines (`eval.jsonl`), the first and last
`fakes` / `tryon_grid` PNGs of the main run, `log.txt` and `summary.json`
(the card's name and power limit, each run's wall seconds and peak memory
allocated).  Snapshots and train states stay in the scratch directory,
which is removed at the end.

`summarize DIR` prints, from those files, the markdown tables of
`DIR/README.md`: tick means (kimg, D/loss, G/loss, G/L1, r1_penalty, the
real / fake scores, ADA p, sec/kimg), the snapshots' held-out quality, the
resume's continuity (step, kimg, ADA p, L1) and the spread of sec/kimg over
the steady ticks (every tick but the first of each run, whose time holds
the start-up).
"""

import argparse
import glob
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_ARGV = ["--synthetic", "512", "--batch", "96", "--accum", "3", "--aug", "ada", "--kimg_per_tick", "4",
              "--img_snap", "4", "--snap", "2"]


def _train(torch, argv, label):
    from pasta_gan_tpu_torch.cli import train as cli_train

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cli_train.main(argv)
    torch.cuda.synchronize()
    res = {"argv": argv, "run_dir": out["run_dir"], "steps": out["state"].step, "wall_s": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label}: {json.dumps(res)}", flush=True)
    del out
    torch.cuda.empty_cache()
    return res


def run(args):
    import torch

    import chip_smoke as cs
    from pasta_gan_tpu_torch.cli import eval_run_snapshots
    from pasta_gan_tpu_torch.utils import Logger

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    summary = {}
    with tempfile.TemporaryDirectory() as work, Logger(os.path.join(args.out, "log.txt")):
        summary["card"] = cs.card_tag()
        print(f"card: {summary['card']}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
        runs = os.path.join(work, "runs")
        main = _train(torch, ["--outdir", runs, "--kimg", args.kimg, *TRAIN_ARGV], "main run")
        resume = _train(torch, ["--outdir", runs, "--kimg", args.resume_kimg, *TRAIN_ARGV, "--resume",
                                os.path.join(main["run_dir"], "train-state-latest.pt")], "resumed run")
        summary.update(main=main, resume=resume)
        evals = []
        for label, r in (("main", main), ("resume", resume)):
            t0 = time.perf_counter()
            for rec in eval_run_snapshots.main([r["run_dir"]]):
                evals.append({"run": label, **rec})
            summary[f"eval_{label}_s"] = time.perf_counter() - t0
        with open(os.path.join(args.out, "eval.jsonl"), "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in evals)
        for label, r in (("main", main), ("resume", resume)):
            os.makedirs(os.path.join(args.out, label), exist_ok=True)
            for name in ("stats.jsonl", "training_options.json"):
                shutil.copy(os.path.join(r["run_dir"], name), os.path.join(args.out, label, name))
        for kind in ("fakes", "tryon_grid"):
            pngs = sorted(glob.glob(os.path.join(main["run_dir"], f"{kind}[0-9]*.png")))
            for p in {pngs[0], pngs[-1]}:
                shutil.copy(p, os.path.join(args.out, "main", os.path.basename(p)))
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(f"summary: {json.dumps(summary)}", flush=True)
    return 0


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _mean(row, key):
    v = row.get(key)
    return None if v is None else (v["mean"] if isinstance(v, dict) else v)


def _fmt(v, spec):
    return "—" if v is None else format(v, spec)


def summarize(args):
    d = args.dir
    runs = {label: _rows(os.path.join(d, label, "stats.jsonl")) for label in ("main", "resume")}
    summary = json.load(open(os.path.join(d, "summary.json")))
    print(f"card: {summary['card']}\n")
    cols = [("D/loss", "Loss/D/loss", ".3f"), ("G/loss", "Loss/G/loss", ".3f"), ("G/L1", "Loss/G/L1", ".2f"),
            ("r1_penalty", "Loss/r1_penalty", ".3g")]
    print("| run | tick | kimg | step | " + " | ".join(c[0] for c in cols)
          + " | score real / fake | ADA p | sec/kimg |")
    print("|" + "---|" * (7 + len(cols)))
    for label, rows in runs.items():
        for r in rows:
            print(f"| {label} | {r['Progress/tick']} | {r['Progress/kimg']:.3f} | {r['Progress/step']} | "
                  + " | ".join(_fmt(_mean(r, k), n) for _, k, n in cols)
                  + f" | {_fmt(_mean(r, 'Loss/scores/real'), '.2f')} / {_fmt(_mean(r, 'Loss/scores/fake'), '.2f')}"
                  f" | {_mean(r, 'Progress/augment_p'):.4f} | {r['Timing/sec_per_kimg']:.2f} |")
    print("\n| run | snapshot | fid_proxy | recon L1 | PSNR (dB) | samples |\n|---|---|---|---|---|---|")
    for e in _rows(os.path.join(d, "eval.jsonl")):
        print(f"| {e['run']} | {e['snapshot']} | {e['fid_proxy']:.3f} | {e['recon_l1']:.4f} | {e['psnr_db']:.2f} | "
              f"{e['samples']} |")
    last, first = runs["main"][-1], runs["resume"][0]
    print("\nresume continuity (last tick of the main run -> first tick of the resumed run): "
          f"step {last['Progress/step']} -> {first['Progress/step']}, kimg {last['Progress/kimg']:.3f} -> "
          f"{first['Progress/kimg']:.3f}, ADA p {_mean(last, 'Progress/augment_p'):.5f} -> "
          f"{_mean(first, 'Progress/augment_p'):.5f} (tick means), G/L1 {_mean(last, 'Loss/G/L1'):.3f} -> "
          f"{_mean(first, 'Loss/G/L1'):.3f}; the last tick's steps (mean ± std) against the first resumed step: "
          + ", ".join(f"{name} {_mean(last, k):.3f} ± {last[k]['std']:.3f} -> {_mean(first, k):.3f}"
                      for name, k in (("G/loss", "Loss/G/loss"), ("D/loss", "Loss/D/loss"),
                                      ("fake score", "Loss/scores/fake"), ("real score", "Loss/scores/real"))))
    steady = [r["Timing/sec_per_kimg"] for rows in runs.values() for r in rows[1:]]
    q = statistics.quantiles(steady, n=4)
    print(f"sec/kimg over the {len(steady)} steady ticks: median {statistics.median(steady):.3f}, min "
          f"{min(steady):.3f}, max {max(steady):.3f}, quartiles {q[0]:.3f} / {q[2]:.3f}, stdev "
          f"{statistics.stdev(steady):.3f}")
    for label in ("main", "resume"):
        r = summary[label]
        print(f"{label}: ended at step {r['steps']} after {r['wall_s']:.1f} s (the CLI's wall time), peak "
              f"{r['peak_gb']:.2f} GB allocated")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--out", required=True, help="where the curated files go")
    r.add_argument("--kimg", default="32", help="cli.train's --kimg of the main run")
    r.add_argument("--resume_kimg", default="36", help="cli.train's --kimg of the continuation")
    s = sub.add_parser("summarize")
    s.add_argument("dir")
    args = ap.parse_args(argv)
    return run(args) if args.cmd == "run" else summarize(args)


if __name__ == "__main__":
    sys.exit(main())
