"""denorm_warp (csrc/denorm_warp.cu): planes [B, N, C, H, W] written once,
the matrices and gates read once; the patches' taps are left out (a lower
bound on the bytes, as for composite).
Args: (srcs, minv, valid, out, B, N, C, Hs, Ws, H, W, replicate, device)."""

from . import PEAK_FP32 as PEAK_OPS  # noqa: F401

DEVICE_NAMES = r"\bdenorm_warp_kernel\b"


def cost(args):
    B, N, C, _, _, H, W = args[4:11]
    out = B * N * C * H * W
    return 8 * out, 4 * (out + B * N * 10)
