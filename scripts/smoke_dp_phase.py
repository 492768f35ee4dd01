#!/usr/bin/env python3
"""Run `chip_smoke.py`'s data-parallel phase alone on one NVIDIA GPU, the
kernels built first, and print its seconds and its launches:

  python3 scripts/smoke_dp_phase.py

The phase (`chip_smoke.dp_phase`): `cli.train` under torchrun as two gloo
ranks sharing cuda:0 and at world 1 followed by a one-rank NCCL smoke of the
collectives, at full width for two steps at global batch 4, each rank's FIR
classes held to their plain versions, and `cli.test --dp` over two replicas
on cuda:0 against the same call without it, on the full-width GeneratorFull
snapshot that `chip_smoke.slice_phase` writes (made here from the same
seed)."""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import chip_smoke as cs
    from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
    from pasta_gan_tpu_torch.models import GeneratorFull
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
    with tempfile.TemporaryDirectory() as tmp:
        g = torch.Generator().manual_seed(0)
        gen = GeneratorFull(img_resolution=256, channel_base=16384, channel_max=512).reset_parameters(g)
        save_snapshot(os.path.join(tmp, "snapshot.pt"), gen.state_dict(), 0.1 * torch.randn(512, generator=g),
                      {"model": gen.config, "generator": gen.variant})
        del gen
        launches = cs.dp_phase(torch, ck, tag, tmp)
    print(json.dumps({path: {k: n for k, n in counts.items() if n} for path, counts in launches.items()}), flush=True)
    print(f"dp phase alone {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
