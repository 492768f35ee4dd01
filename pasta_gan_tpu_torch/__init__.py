"""PyTorch/CUDA port of `pasta_gan_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here keeps its
counterpart's module path and its public NHWC layouts, so tests feed the same
numpy inputs to both.  The three patch-routing kernels and the two 2x FIR
resampling kernels are hand-written CUDA (`csrc/`, declared, built and
counted in `ops/cuda_kernels.py`, bound in `ops/warp_kernels.py` and
`ops/upfirdn_kernels.py`).

Entry points take `device` (default "cuda") and raise when CUDA is absent and
the CPU was not asked for explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; refuses to fall back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
