#!/usr/bin/env python3
"""Run `chip_smoke.py`'s conditional-metrics, transfer-learning, stock
generator / skip D and plain-512 phases alone on one NVIDIA GPU, the kernels
built first, and print each phase's seconds:

  python3 scripts/smoke_transfer_phases.py

The conditional FID compares the fixture's reals with 16 random 256x192 PNGs
(the full smoke uses `serving_real`'s try-ons) on the random-weight detector
files of `chip_smoke.random_detectors`."""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from pasta_gan_tpu_torch.data import image_io
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = cs.card_tag()
    print("card:", tag, flush=True)
    ck.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "tryon_real"))
        rng = np.random.default_rng(0)
        for i in range(16):
            image_io.write_png(rng.integers(0, 256, (256, 192, 3), np.uint8), os.path.join(tmp, "tryon_real", f"{i}.png"))
        cs.random_detectors(torch, tmp)
        secs = {}
        t1 = time.perf_counter()
        print(cs.metrics_conditional_phase(torch, ck, tag, tmp), flush=True)
        secs["metrics_conditional"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        launches, pkl, expected = cs.transfer_phase(torch, ck, tag, tmp)
        print("training_transfer", launches, flush=True)
        secs["training_transfer"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        print(cs.stock_phase(torch, ck, tag, pkl, expected), flush=True)
        secs["stock_forward and d_skip"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        print(cs.plain_512_phase(torch, ck, tag), flush=True)
        secs["plain_512"] = time.perf_counter() - t1
        print(f"phase seconds { {k: round(v, 1) for k, v in secs.items()} }, total {time.perf_counter() - t0:.1f} "
              f"[{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
