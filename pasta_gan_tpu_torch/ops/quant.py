"""int8 serving (W8A8; counterpart of `pasta_gan_tpu/ops/quant.py`).

Scheme, as in the JAX package:
* weights: symmetric per-output-channel int8 of the gain-scaled fp32 weight
  (`quantize_weight`, OIHW, scale [O]);
* activations: symmetric int8 (`quantize_act`: per sample, scale
  [N, 1, 1, 1]; `quantize_act_with_scale`: one precomputed scalar scale);
* an s8 x s8 convolution with a 32-bit integer accumulator, emitted as the
  output type (s32 -> fp32 -> bf16, each round to nearest even), multiplied
  in fp32 by sx * sw (that product rounded first) and cast to the output
  type.

Modes (`INT8_MODES`): "int8" quantizes each activation with its own
per-sample amax; "int8_calib" quantizes with the current batch's
per-tensor amax and folds that amax into the site's running `act_amax`;
"int8_static" quantizes with the frozen `act_amax` (calibrated beforehand).
An `ActScale` is one quantization site: its `act_amax` is a non-persistent
buffer, so a generator's state_dict is the same under every mode (JAX keeps
the scales in a separate "quant_scales" collection); `quant_scales` /
`load_quant_scales` read and set them by the JAX package's site names.
A `QuantizedActivation` is one quantize shared by several convs.
`int8_conv2d` quantizes the weight (and the activation, unless it is given
quantized) and runs `int8_conv`.

`int8_conv` runs the integer convolution: on a CUDA tensor the hand-written
kernel of `csrc/int8_conv.cu` (the `int8_conv` entry of
`ops/cuda_kernels.py:KERNELS`), on a CPU tensor `int8_conv_reference`, the
plain version: the exact accumulator as an `F.conv2d` of the int8 values in
float64 (|acc| < 2^53), with zeros inserted for the input dilation, then the
same epilogue.  The kernel's operands are laid out by `kernel_operands`
(NHWC activation, weights packed by output phase, the table of taps that
land on real input).  The quantize passes themselves are plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cuda_kernels import INT8_CONV, check_tensor

INT8_MODES = ("int8", "int8_calib", "int8_static")
OUT_DTYPES = (torch.float32, torch.bfloat16)


def is_int8(quant) -> bool:
    return quant in INT8_MODES


class QuantizedActivation(NamedTuple):
    """An activation quantized once, with its dequant scale, for every conv
    that consumes it (one scale for all of them)."""

    q: torch.Tensor  # int8 NCHW
    scale: torch.Tensor  # fp32, [N, 1, 1, 1] or a scalar


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW weight: (wq int8, scale fp32 [O])."""
    w32 = w.float()
    s = (w32.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    wq = torch.round(w32 / s[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return wq, s


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-sample int8 of an NCHW activation: (xq int8, scale fp32 [N, 1, 1, 1])."""
    x32 = x.float()
    s = (x32.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(x32 / s).clamp(-127, 127).to(torch.int8), s


def quantize_act_with_scale(x: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 of `x` with a precomputed scale (the calib and static modes)."""
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8), s


class ActScale(nn.Module):
    """One activation-quantization site (`module_act_scale` of the JAX
    package): the running per-tensor amax of the calibration pass and the
    scale each mode quantizes with."""

    def __init__(self):
        super().__init__()
        self.register_buffer("act_amax", torch.zeros(()), persistent=False)

    def scale(self, x: torch.Tensor, quant: str) -> Optional[torch.Tensor]:
        """None (per-sample, inside the quantize) for "int8"; the batch's
        amax / 127 for "int8_calib", which also grows `act_amax`; the frozen
        `act_amax` / 127 for "int8_static"."""
        if quant == "int8":
            return None
        if quant == "int8_calib":
            cur = x.detach().float().abs().amax()
            self.act_amax.copy_(torch.maximum(self.act_amax, cur))
            return cur.clamp_min(1e-12) / 127.0
        if quant == "int8_static":
            return self.act_amax.clamp_min(1e-12) / 127.0
        raise ValueError(f"quant must be one of {INT8_MODES}, got {quant!r}")

    def quantize(self, x: torch.Tensor, quant: str) -> QuantizedActivation:
        """Quantize `x` once at this site (`quantize_act_for`)."""
        s = self.scale(x, quant)
        return QuantizedActivation(*(quantize_act(x) if s is None else quantize_act_with_scale(x, s)))


def _site_key(name: str) -> str:
    """A site's JAX name: that of the module that owns it (`<module>.act_scale.act_amax`
    -> `<module>.act_amax`), or its own where it stands alone (`spade_feat_quant`)."""
    parts = name.split(".") if name else []
    if parts and parts[-1] == "act_scale":
        parts = parts[:-1]
    return ".".join(parts + ["act_amax"])


def quant_scales(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{site name: act_amax} of every `ActScale` under `module`, named as the
    JAX package's "quant_scales" leaves translate (`io/from_jax.py:port_key`)."""
    return {_site_key(name): m.act_amax for name, m in module.named_modules() if isinstance(m, ActScale)}


def load_quant_scales(module: nn.Module, scales: Dict[str, torch.Tensor]) -> None:
    """Set every site's `act_amax`; raises on a missing or an unknown site."""
    sites = {_site_key(name): m for name, m in module.named_modules() if isinstance(m, ActScale)}
    missing, extra = sorted(set(sites) - set(scales)), sorted(set(scales) - set(sites))
    if missing or extra:
        raise KeyError(f"quant_scales mismatch: missing {missing[:10]}, extra {extra[:10]}")
    with torch.no_grad():
        for k, m in sites.items():
            m.act_amax.copy_(torch.as_tensor(scales[k], dtype=torch.float32).reshape(()))


def reset_quant_scales(module: nn.Module) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ActScale):
                m.act_amax.zero_()


class QuantMode:
    """Mixin of the modules whose convs follow int8 serving: `quant` is None
    (float) or one of INT8_MODES, set on every such module of a generator by
    its `quant` setter."""

    quant: Optional[str] = None


# ---------------------------------------------------------------- the convolution


def _out_size(size, k, stride, pad0, pad1, dil):
    return ((size - 1) * dil + 1 + pad0 + pad1 - k) // stride + 1


def _epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, out_dtype) -> torch.Tensor:
    """float64 accumulator (exact integers) -> the output: emitted as
    `out_dtype`, times sx * sw in fp32, cast to `out_dtype`."""
    y = acc.to(torch.float32)
    if out_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16).to(torch.float32)
    scale = sx.float().reshape(-1, 1, 1, 1) * sw.float().reshape(1, -1, 1, 1)
    return (y * scale).to(out_dtype)


def int8_conv_reference(xq, wq, sx, sw, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of `int8_conv`: int8 NCHW `xq`, int8 OIHW `wq` (a
    correlation kernel), fp32 `sx` ([N, 1, 1, 1] or a scalar) and `sw` [O];
    `padding_hw` ((top, bottom), (left, right)) on the dilated input.  The
    accumulator is an `F.conv2d` of the int8 values in float64, exact
    (|acc| < 2^53), rounded to the nearest integer (which a transform-based
    conv algorithm could miss by a little); then the epilogue."""
    (pt, pb), (pl, pr) = padding_hw
    x = xq.to(torch.float64)
    if lhs_dilation > 1:
        N, C, H, W = x.shape
        d = lhs_dilation
        xd = x.new_zeros(N, C, (H - 1) * d + 1, (W - 1) * d + 1)
        xd[:, :, ::d, ::d] = x
        x = xd
    acc = F.conv2d(F.pad(x, [pl, pr, pt, pb]), wq.to(torch.float64), stride=stride).round()
    return _epilogue(acc, sx, sw, out_dtype)


def _phase_taps(kh, kw, stride, dil, pt, pl):
    """For each output phase (oy mod D, ox mod D), the taps (ky, kx) that land
    on real input and their offsets (dy, dx): input row = i * stride + dy for
    the phase's row i."""
    phases = [(0, 0)] if dil == 1 else [(py, px) for py in range(dil) for px in range(dil)]
    out = []
    for py, px in phases:
        taps = []
        for ky in range(kh):
            u = py * stride + ky - pt
            if u % dil:
                continue
            for kx in range(kw):
                v = px * stride + kx - pl
                if v % dil:
                    continue
                taps.append((ky, kx, u // dil, v // dil))
        out.append(taps)
    return out


@functools.lru_cache(maxsize=None)
def _tap_table(kh, kw, stride, dil, pt, pl, device):
    """(phase taps, int32 [P, Tmax, 2] offsets, int32 [P] counts) on `device`,
    kept for each geometry (a few small tensors)."""
    phases = _phase_taps(kh, kw, stride, dil, pt, pl)
    table = torch.zeros(len(phases), max(max(len(t) for t in phases), 1), 2, dtype=torch.int32)
    for p, taps in enumerate(phases):
        for t, (_, _, dy, dx) in enumerate(taps):
            table[p, t, 0], table[p, t, 1] = dy, dx
    counts = torch.tensor([len(t) for t in phases], dtype=torch.int32)
    return phases, table.to(device), counts.to(device)


K_STEP = 64  # K bytes per step of the kernel (csrc/int8_conv.cu:BK)
C_ALIGN = 16  # the kernel's activation channels: a multiple of 16, one 16-byte copy each


class KernelOperands(NamedTuple):
    """What csrc/int8_conv.cu reads besides the scales."""

    x: torch.Tensor  # int8 [N, H, W, Cp], NHWC, zeros in the channels past C
    w: torch.Tensor  # int8 [P, O, Kp]: each phase's valid taps in order, Cp channels each, zeros past them
    taps: torch.Tensor  # int32 [P, Tmax, 2]: (dy, dx) of each phase's valid taps
    ntaps: torch.Tensor  # int32 [P]
    stride: int
    dilation: int
    out_hw: Tuple[int, int]


def _pack_weight(wq: torch.Tensor, phases, cp: int) -> torch.Tensor:
    """int8 OIHW -> int8 [P, O, Kp]: each phase's valid taps in order, `cp`
    channels each (zeros past C), zeros past the taps, Kp a multiple of K_STEP."""
    O, C = wq.shape[:2]
    kp = -(-max(len(t) for t in phases) * cp // K_STEP) * K_STEP
    w = F.pad(wq, (0, 0, 0, 0, 0, cp - C))
    packed = []
    for taps in phases:
        ky = torch.tensor([t[0] for t in taps], device=wq.device, dtype=torch.long)
        kx = torch.tensor([t[1] for t in taps], device=wq.device, dtype=torch.long)
        k = w[:, :, ky, kx].permute(0, 2, 1).reshape(O, -1)  # [O, nT * cp]
        packed.append(F.pad(k, (0, kp - k.shape[1])))
    return torch.stack(packed).contiguous()


def kernel_operands(xq, wq, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1) -> KernelOperands:
    """Lay out the kernel's operands: the activation NHWC with its channels
    padded to a multiple of C_ALIGN, the weight packed by phase
    (`_pack_weight`), the tap table (`_tap_table`)."""
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    (pt, pb), (pl, pr) = padding_hw
    cp = -(-C // C_ALIGN) * C_ALIGN
    phases, table, counts = _tap_table(kh, kw, stride, lhs_dilation, pt, pl, xq.device)
    x = F.pad(xq.permute(0, 2, 3, 1), (0, cp - C)).contiguous()
    out_hw = (_out_size(H, kh, stride, pt, pb, lhs_dilation), _out_size(W, kw, stride, pl, pr, lhs_dilation))
    return KernelOperands(x, _pack_weight(wq, phases, cp), table, counts, stride, lhs_dilation, out_hw)


def launch_kernel(ops: KernelOperands, sx: torch.Tensor, sw: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of csrc/int8_conv.cu on the current stream into `out`
    [N, O, Ho, Wo] (fp32 or bf16); `sx` fp32 [N] or [1], `sw` fp32 [O]."""
    N, H, W, cp = ops.x.shape
    _, O, kp = ops.w.shape
    INT8_CONV.launch(ops.x.data_ptr(), ops.w.data_ptr(), ops.taps.data_ptr(), ops.ntaps.data_ptr(), sx.data_ptr(),
                     int(sx.numel() == N), sw.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), N, cp,
                     H, W, O, ops.out_hw[0], ops.out_hw[1], ops.stride, ops.dilation, kp, ops.taps.shape[1],
                     ops.x.device)


def _int8_conv_kernel(xq, wq, sx, sw, stride, padding_hw, lhs_dilation, out_dtype):
    dev = xq.device
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    if lhs_dilation > 1 and stride != 1:
        raise ValueError("int8_conv: input dilation needs stride 1")
    if min(padding_hw[0] + padding_hw[1]) < 0:
        raise ValueError(f"int8_conv: negative padding {padding_hw}")
    check_tensor(xq, "xq", (N, C, H, W), dev, (torch.int8,))
    check_tensor(wq, "wq", (O, C, kh, kw), dev, (torch.int8,))
    sx = sx.float().reshape(-1).contiguous()
    if sx.numel() not in (1, N):
        raise ValueError(f"int8_conv: activation scale of {sx.numel()} values for a batch of {N}")
    sw = sw.float().contiguous()
    check_tensor(sw, "sw", (O,), dev)
    check_tensor(sx, "sx", (sx.numel(),), dev)
    ops = kernel_operands(xq, wq, stride, padding_hw, lhs_dilation)
    if ops.taps.shape[1] > 64:
        raise ValueError(f"int8_conv: {ops.taps.shape[1]} taps, the kernel takes at most 64")
    out = torch.empty(N, O, max(ops.out_hw[0], 0), max(ops.out_hw[1], 0), dtype=out_dtype, device=dev)
    if out.numel():
        launch_kernel(ops, sx, sw, out)
    return out


def int8_conv(xq, wq, sx, sw, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The s8 x s8 -> s32 convolution with the fused dequant (arguments as in
    `int8_conv_reference`): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wq, sx, sw, stride, padding_hw, lhs_dilation, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda tensors, got {xq.device}")
    return _int8_conv_kernel(xq.contiguous(), wq.contiguous(), sx, sw, stride, padding_hw, lhs_dilation, out_dtype)


def int8_conv2d(x: Union[torch.Tensor, QuantizedActivation], w: torch.Tensor, padding=(0, 0, 0, 0),
                stride: int = 1, lhs_dilation: int = 1, flip_weight: bool = True, out_dtype=torch.bfloat16,
                act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 drop-in for `ops/conv2d_resample.py:_conv2d` on NCHW `x` (float,
    or already quantized) and the float OIHW weight `w`: padding (px0, px1,
    py0, py1); `flip_weight=True` is correlation, False flips the kernel
    spatially; `act_scale` None quantizes a float `x` per sample."""
    if not flip_weight:
        w = w.flip([2, 3])
    wq, sw = quantize_weight(w)
    if isinstance(x, QuantizedActivation):
        xq, sx = x
    elif act_scale is not None:
        xq, sx = quantize_act_with_scale(x, act_scale)
    else:
        xq, sx = quantize_act(x)
    px0, px1, py0, py1 = padding
    return int8_conv(xq, wq, sx, sw, stride, ((py0, py1), (px0, px1)), lhs_dilation, out_dtype)


def fold_up_weights(w: torch.Tensor, f: torch.Tensor, gain: float = 4.0) -> torch.Tensor:
    """Fold the FIR of the up=2 conv into its kernel (`pasta_gan_tpu/ops/packing.py:fold_up_weights`):
    `w` [O, I, 3, 3] applied as a true convolution, `f` [4, 4] applied by
    upfirdn with gain `gain`; returns the fp32 correlation kernel
    G = flip(w) * gain * flip(f) (full 2-D convolution) [O, I, 6, 6], summed
    tap by tap in the JAX package's order."""
    kh, kw = w.shape[2:]
    fh, fw = f.shape
    wf = w.flip([2, 3]).float()
    ff = f.flip([0, 1]).float() * gain
    G = torch.zeros(w.shape[:2] + (kh + fh - 1, kw + fw - 1), dtype=torch.float32, device=w.device)
    for p in range(kh):
        for q in range(kw):
            G[:, :, p:p + fh, q:q + fw] += ff * wf[:, :, p, q, None, None]
    return G
