"""composite (csrc/composite.cu): the group images [B, G, 3, H, W] and hand
masks [B, n_hands, H, W] written once, the matrices and gates read once.
The patches' taps are left out (their sectors depend on the matrices, which
the arguments do not carry): a lower bound on the bytes.  Operations are
not counted; the bytes bound it.
Args: (srcs, minv, valid, g_out, h_out, B, N, Hs, Ws, H, W, n_groups,
group_bits, erode_bits, hand_bits, n_hands, threshold, device)."""

from . import PEAK_FP32 as PEAK_OPS  # noqa: F401

DEVICE_NAMES = r"\bcomposite_kernel\b"


def cost(args):
    B, N, _, _, H, W, n_groups = args[5:12]
    n_hands = args[15]
    return 0, 4 * (B * (3 * n_groups + n_hands) * H * W + B * N * 10)
