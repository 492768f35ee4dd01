"""norm_warp (csrc/norm_warp.cu): float32 patches [B, N, C, h, w] written
once, the matrices [B, N, 3, 3] and gates [B, N] read once.  The source
frames' taps are left out: which sectors a launch reads depends on its
matrices, which the launch's arguments do not carry, so this count is a
lower bound on the bytes (chip_smoke.py's `norm_source_bytes` counts them
from the data).  Bilinear taps: 8 operations an output element.
Args: (src0, src1, minv, valid, out, B, N, n0, H, W, h, w, C, device)."""

from . import PEAK_FP32 as PEAK_OPS  # noqa: F401

DEVICE_NAMES = r"\bnorm_warp_kernel\b"


def cost(args):
    B, N, _, _, _, h, w, C = args[5:13]
    out = B * N * C * h * w
    return 8 * out, 4 * (out + B * N * 10)
