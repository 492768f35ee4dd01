"""Score every network snapshot of a training run on a fixed evaluation set
(counterpart of `scripts/eval_run_snapshots.py`).

  python -m pasta_gan_tpu_torch.cli.eval_run_snapshots RUN_DIR [--samples 64] [--batch 8] [--seed 123] \\
      [--device cuda|cpu]

Each `network-snapshot-*.pt` of RUN_DIR, oldest first, is rebuilt by
`cli/test.py:load_generator` (float32) and run with the training-style
forward (`metrics/quality.py:eval_forward`, noise const) over the synthetic
samples of `--seed` (123: the quality-regression set, held out from a
`cli.train --synthetic` run's seed-0 samples); one JSON line per snapshot:
`snapshot`, `fid_proxy` (the JAX package's seed-0 SimpleConvFeatures
weights; NOT comparable to reference FID, comparable across snapshots and
with the JAX records), `recon_l1`, `psnr_db`, `samples`.  TF32 is off, as in
`cli/calc_metrics.py`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from .. import resolve_device


def main(argv=None):
    """The CLI; returns one dict per snapshot with the unrounded metrics."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=123, help="evaluation set seed (123: the quality-regression set)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..metrics.extractors import jax_simpleconv
    from ..metrics.quality import eval_batches, generate, quality_metrics, reals_of
    from .test import load_generator

    snaps = sorted(glob.glob(os.path.join(args.run_dir, "network-snapshot-*.pt")))
    if not snaps:
        raise SystemExit(f"no network-snapshot-*.pt under {args.run_dir}")
    batches = eval_batches(args.samples, args.batch, seed=args.seed, device=device)
    reals = reals_of(batches)
    extractor = jax_simpleconv(device)
    records = []
    for snap in snaps:
        gen, _ = load_generator(snap, device)
        m = quality_metrics(generate(gen, batches), reals, extractor)
        del gen
        records.append({"snapshot": os.path.basename(snap), **m, "samples": args.samples})
        print(json.dumps({"snapshot": os.path.basename(snap), "fid_proxy": round(m["fid_proxy"], 3),
                          "recon_l1": round(m["recon_l1"], 4), "psnr_db": round(m["psnr_db"], 2),
                          "samples": args.samples}), flush=True)
    return records


if __name__ == "__main__":
    main()
