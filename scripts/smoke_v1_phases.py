#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phases of the flow generator V1, the patch
discriminators, host routing and the dataset tools alone on one NVIDIA GPU,
the kernels built first, and print their seconds and their launches:

  python3 scripts/smoke_v1_phases.py

The phases (`chip_smoke.v1_phase`, `patch_d_phase`, `host_routing_phase`,
`tools_phase`): GeneratorV1 at its defaults in bf16 and fp32 at batch 8 and
against the CPU at a thin width; both patch discriminators forward and
backward at batch 16 and against the CPU at a thin width; the host routes
against the card's device route and their host ms by thread count;
`cli.dataset_tool convert` and `cli.draw_point` on the fixture."""

import json
import os
import sys
import tempfile
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
    launches = cs.v1_phase(torch, ck, tag)
    launches.update(cs.patch_d_phase(torch, ck, tag))
    launches.update(cs.host_routing_phase(torch, ck, tag))
    with tempfile.TemporaryDirectory() as tmp:
        cs.tools_phase(torch, tag, tmp)
    print(json.dumps({path: {k: n for k, n in counts.items() if n} for path, counts in launches.items()}), flush=True)
    print(f"v1, patch_d, host_routing and tools phases {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
