"""Fixed-seed quality-regression run (counterpart of `scripts/quality_regression.py`).

Trains the losses of record at a small width from a fixed seed for K steps
on a fixed synthetic set, then scores G_ema's finetune output on that set:

  python -m pasta_gan_tpu_torch.cli.quality_regression [--steps 30] [--samples 32] \\
      [--ada off|exact|fast --ada_p 0.3] [--dtype float32|bfloat16] [--seed_offset 0] \\
      [--quant int8|int8_static] [--device cuda|cpu]

* fid_proxy: the FID formula under the JAX package's seed-0
  SimpleConvFeatures weights (`metrics/extractors.py:jax_simpleconv`; NOT
  comparable to reference FID numbers);
* recon_l1: mean |G(x) - real| over the set; psnr_db: of the same.

The JAX script's config: `mapping_layers` 2, minibatch-std groups of
min(4, batch), L1 40, VGG 0, mask 20, R1 gamma 10 (only Gmain + Dmain run,
no R1, as in the JAX script), ADA at a fixed p (`--ada_p`, controller
horizon 1e9 kimg) with the exact warp one call at a time (`exact`) or the
two-pass warp with stacked calls (`fast`).  Data: `SyntheticUvitonDataset(
seed=123)`, batched by `metrics/quality.py:eval_batches`; G and D drawn from
a CPU generator seeded 0; step `it` trains on batch `it mod n` with its noise,
ADA and latent draws seeded `100 + seed_offset + it`.  `--seed_offset` moves
only the step seeds: two runs at different offsets give the noise scale that a
change must stay within.  `--quant` also scores the int8 serving mode on the
same G_ema (`int8_static`: scales calibrated over the set's batches by
`cli/test.py:calibrate_int8_static`): `fid_proxy_quant`, `quant_pixel_l1`
against the float output and `quant_mode`.

Prints one JSON line with the JAX script's keys and `device` (the card's
name, or "cpu").  TF32 is off, as in `cli/calc_metrics.py`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device


def build_config(args):
    """The JAX script's TrainConfig for `args`."""
    from ..runtime.config import AdaConfig, LossConfig, ModelConfig, TrainConfig

    return TrainConfig(
        model=ModelConfig(img_resolution=args.res, channel_base=args.channel_base, channel_max=args.channel_max,
                          mbstd_group_size=min(4, args.batch), mapping_layers=2),
        loss=LossConfig(l1_weight=40.0, vgg_weight=0.0, mask_weight=20.0, r1_gamma=10.0),
        ada=AdaConfig(enabled=args.ada != "off", initial_p=args.ada_p, kimg=10**9,  # a fixed p
                      fast_geom=args.ada == "fast", stack_calls=args.ada == "fast"),
        compute_dtype=args.dtype,
        batch_size=args.batch,
    )


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None):
    """The CLI; returns {"result": the printed dict, "trainer", "state", "batches"}."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--channel_base", type=int, default=4096)
    ap.add_argument("--channel_max", type=int, default=128)
    ap.add_argument("--ada", choices=["off", "exact", "fast"], default="off",
                    help="ADA at the fixed --ada_p: 'exact' = the exact warp, D calls one by one; 'fast' = the "
                         "two-pass warp and stacked D calls")
    ap.add_argument("--ada_p", type=float, default=0.3)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--seed_offset", type=int, default=0,
                    help="offset of the per-step seeds: two runs at different offsets give the noise scale")
    ap.add_argument("--quant", choices=["int8", "int8_static"], default=None,
                    help="also score the int8 serving mode: fid_proxy_quant and the pixel delta from the float forward")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # a yardstick: fp32 stays fp32, as in cli/calc_metrics.py
    torch.backends.cudnn.allow_tf32 = False

    from ..metrics.extractors import jax_simpleconv
    from ..metrics.quality import eval_batches, fid_proxy, generate, quality_metrics, reals_of
    from ..train.step import GANTrainer
    from .test import calibrate_int8_static

    cfg = build_config(args)
    batches = eval_batches(args.samples, args.batch, seed=123, res=args.res, device=device)
    trainer = GANTrainer(cfg, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    t0 = time.time()
    for it in range(args.steps):
        seed = 100 + args.seed_offset + it
        for g in (trainer.noise, trainer.augment_gen, trainer.latent_gen):
            g.manual_seed(seed)
        state, _ = trainer.train_step(state, batches[it % len(batches)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0

    gen = state.G_ema
    extractor = jax_simpleconv(device)
    reals = reals_of(batches)
    fakes = generate(gen, batches)
    m = quality_metrics(fakes, reals, extractor)
    out = {
        "metric": "fid_proxy",
        "value": round(m["fid_proxy"], 3),
        "unit": "simpleconv-fid (NOT reference-comparable)",
        "recon_l1": round(m["recon_l1"], 4),
        "psnr_db": round(m["psnr_db"], 2),
        "steps": args.steps,
        "samples": args.samples,
        "train_s": round(train_s, 1),
        "ada": args.ada,
        "dtype": args.dtype,
        "seed_offset": args.seed_offset,
    }
    if args.quant:
        if args.quant == "int8_static":
            calibrate_int8_static(gen, state.w_avg, batches, noise_mode="const")
        else:
            gen.quant = "int8"
        fakes_q = generate(gen, batches)
        gen.quant = None
        out["fid_proxy_quant"] = round(fid_proxy(fakes_q, reals, extractor), 3)
        out["quant_pixel_l1"] = round(float(np.mean(np.abs(fakes_q - fakes))), 4)
        out["quant_mode"] = args.quant
    out["device"] = device_name(device)
    print(json.dumps(out), flush=True)
    return {"result": out, "trainer": trainer, "state": state, "batches": batches}


if __name__ == "__main__":
    main()
