#!/usr/bin/env python3
"""Run `chip_smoke.py`'s zoo phase alone on one NVIDIA GPU, the kernels built
first, and print its seconds and its launches:

  python3 scripts/smoke_zoo_phase.py

The phase builds each of the 20 zoo and ablation classes through
`models.build_model` at its defaults, runs one bf16 forward at batch 8 with
the launch counts set to 0 just before it, holds every up2/down2 class of
that forward to its plain version, compares the card with the CPU at a thin
width and times four of the classes (`chip_smoke.zoo_phase`)."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import chip_smoke as cs
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = cs.card_tag()
    print("card:", tag, flush=True)
    ck.build_kernels()
    t0 = time.perf_counter()
    launches = cs.zoo_phase(torch, ck, tag)
    print(json.dumps({path: {k: n for k, n in counts.items() if n} for path, counts in launches.items()}), flush=True)
    print(f"zoo phase {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
