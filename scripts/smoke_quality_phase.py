#!/usr/bin/env python3
"""Run `chip_smoke.py`'s training-quality phase alone on one NVIDIA GPU, the
kernels built first, and print its seconds and its launches:

  python3 scripts/smoke_quality_phase.py

The phase (`chip_smoke.quality_phase`): `cli.eval_run_snapshots` over a run
directory holding one full-width GeneratorFull snapshot (here drawn from
seed 0 and saved as `network-snapshot-000000.pt`, where the smoke scores
its training phase's snapshot), then `cli.quality_regression --quant
int8_static` at its defaults, and the kernels at that path's shapes against
their plain versions."""

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
    with tempfile.TemporaryDirectory() as tmp:
        gen = GeneratorFull(img_resolution=256, channel_base=16384, channel_max=512)
        gen.reset_parameters(torch.Generator().manual_seed(0))
        save_snapshot(os.path.join(tmp, "network-snapshot-000000.pt"), gen.state_dict(), torch.zeros(512),
                      {"model": gen.config, "generator": gen.variant})
        del gen
        t0 = time.perf_counter()
        launches = cs.quality_phase(torch, ck, tag, tmp)
        print(f"quality phase alone {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    print(json.dumps({path: {k: n for k, n in counts.items() if n} for path, counts in launches.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
