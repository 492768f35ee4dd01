#!/usr/bin/env python3
"""The spread of a freshly initialized GeneratorFull's finetune output over
init seeds, in the JAX package and in the port, on one evaluation batch.

  JAX_PLATFORMS=cpu python scripts/init_spread_jax_vs_port.py [--seeds 12] [--samples 8]

At `cli.quality_regression`'s width (channel_base 4096, channel_max 128, 2
mapping layers), 30 steps at batch 8 move G_ema by under 2 % of G's move
(ema_kimg 10), so that tool's recon L1 and PSNR mostly read the initial
draw.  The two packages draw their initial weights from other generators
(`jax.random` keys, `torch.Generator` seeds), so the tool's numbers agree
between them only in distribution.  For each seed this prints the mean
|output| of the image and finetune heads and the finetune output's L1 from
the reals, then the mean and median over the seeds.  Needs JAX and the JAX
package (CPU only); the port never imports this script.
"""

import argparse
import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CFG = dict(img_resolution=256, channel_base=4096, channel_max=128, mapping_layers=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--samples", type=int, default=8)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
    from pasta_gan_tpu_torch.metrics import quality
    from pasta_gan_tpu_torch.models import GeneratorFull

    b = quality.eval_batches(args.samples, args.samples, seed=123, device="cpu")[0]
    keys = ("style_input", "retain", "pose", "denorm_upper_img", "denorm_lower_img", "denorm_upper_mask",
            "denorm_lower_mask")
    bj = [jnp.asarray(b[k].numpy()) for k in keys]
    reals = b["real_img"].numpy()
    jgen = JaxGeneratorFull(**CFG)
    init = jax.jit(lambda k: jgen.init({"params": jax.random.fold_in(k, 0), "noise": jax.random.fold_in(k, 1)},
                                       None, *bj, noise_mode="const"))
    fwd = jax.jit(lambda v: jgen.apply(v, None, *bj, noise_mode="const", rngs={"noise": jax.random.PRNGKey(0)}))

    def port(seed):
        gen = GeneratorFull(**CFG).reset_parameters(torch.Generator().manual_seed(seed)).eval()
        with torch.no_grad():
            return [t.numpy() for t in gen(None, *[b[k] for k in keys], noise_mode="const")]

    l1 = {"jax": [], "port": []}
    for name, run in (("jax", lambda s: [np.asarray(t) for t in fwd(init(jax.random.PRNGKey(s)))]), ("port", port)):
        for s in range(args.seeds):
            img, ft, _ = run(s)
            l1[name].append(float(np.abs(ft - reals).mean()))
            print(f"{name} seed {s}: |img| {np.abs(img).mean():.3f} |ft| {np.abs(ft).mean():.3f} "
                  f"ft L1 {l1[name][-1]:.3f}", flush=True)
    for name, v in l1.items():
        print(f"{name}: ft L1 over {len(v)} seeds mean {statistics.mean(v):.3f} median {statistics.median(v):.3f} "
              f"min {min(v):.3f} max {max(v):.3f}")


if __name__ == "__main__":
    main()
