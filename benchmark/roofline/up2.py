"""up2 (csrc/upfirdn2x.cu): each output element is a 2x2-tap sum per axis,
computed in float32: 10 operations (chip_smoke.py's count); the input read
once and the output written once.
Args: (x, y, bf16, planes, H, W, extend, gain, device)."""

from . import PEAK_FP32 as PEAK_OPS  # noqa: F401

DEVICE_NAMES = r"\bup2_(short_rows_)?kernel\b"


def cost(args):
    _, _, bf16, planes, H, W, extend, _, _ = args
    elt = 2 if bf16 else 4
    out = planes * (2 * H + 2 * extend) * (2 * W + 2 * extend)
    return 10 * out, elt * (planes * H * W + out)
