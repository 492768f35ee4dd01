"""down2 (csrc/upfirdn2x.cu): each output element is a 4-tap sum per axis,
computed in float32: 36 operations (chip_smoke.py's count); the input read
once and the output written once.
Args: (x, y, bf16, planes, H, W, pad, gain, device)."""

from . import PEAK_FP32 as PEAK_OPS  # noqa: F401

DEVICE_NAMES = r"\bdown2_(per_output_)?kernel\b"


def cost(args):
    _, _, bf16, planes, H, W, pad, _, _ = args
    elt = 2 if bf16 else 4
    out = planes * (H // 2 + pad - 1) * (W // 2 + pad - 1)
    return 36 * out, elt * (planes * H * W + out)
