#!/usr/bin/env python3
"""Write the JAX `SimpleConvFeatures(seed=0)` weights for the port's fid_proxy.

  JAX_PLATFORMS=cpu python scripts/export_simpleconv_jax.py [--out pasta_gan_tpu_torch/metrics/simpleconv_jax_seed0.npz]

The JAX package draws the extractor's weights from `jax.random` keys, which
the port cannot reproduce, so its fid_proxy numbers (BASELINE.md,
TRAINING_RUN_R5.md) are only comparable under these exact weights.  The file
holds `kernel0`..`kernel3` (HWIO, as the JAX module keeps them) and `proj`
[256, 256], float32, uncompressed; `pasta_gan_tpu_torch/metrics/extractors.py:
jax_simpleconv` reads it.  Needs JAX and the JAX package, so it runs where
they are installed; the port only reads the file.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_OUT = os.path.join("pasta_gan_tpu_torch", "metrics", "simpleconv_jax_seed0.npz")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from pasta_gan_tpu.metrics.extractors import SimpleConvFeatures

    ext = SimpleConvFeatures(seed=0)
    arrays = {f"kernel{i}": np.asarray(k, np.float32) for i, k in enumerate(ext.kernels)}
    arrays["proj"] = np.asarray(ext.proj, np.float32)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items())
          + f"; {os.path.getsize(args.out)} bytes")
    return args.out


if __name__ == "__main__":
    main()
