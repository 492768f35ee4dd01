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

The two operands are kept as the convolution kernel reads them.  A
`QuantizedActivation` is one quantize shared by several convs, held NHWC
with its channels padded to a multiple of 16: `quantize_pack` writes it in
one pass, on a CUDA tensor with the hand-written kernel of
`csrc/quantize_pack.cu` (the `quantize_pack` entry of
`ops/cuda_kernels.py:KERNELS`), on a CPU tensor with
`quantize_pack_reference`, the plain version (`quantize_act_with_scale`,
then the permute and the pad).  The per-sample amax of mode "int8" and the
batch amax of "int8_calib" are plain reductions, as in the JAX package.  A
`PackedWeight` is a conv's int8 weight packed by output phase with its
scale, its tap table and its geometry (`pack_weight`); a conv module keeps
its own in an `Int8WeightCache`, so a served forward builds none.

`int8_conv_packed` runs the integer convolution on the two: on a CUDA
tensor the hand-written kernel of `csrc/int8_conv.cu` (the `int8_conv`
entry), on a CPU tensor `int8_conv_reference`, the plain version: the exact
accumulator as an `F.conv2d` of the int8 values in float64 (|acc| < 2^53),
with zeros inserted for the input dilation, then the same epilogue.
`int8_conv` takes the operands NCHW / OIHW (laid out by `kernel_operands`)
and `int8_conv2d` a float activation and weight, as the JAX package's
functions do.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cuda_kernels import INT8_CONV, QUANTIZE_PACK, check_tensor

INT8_MODES = ("int8", "int8_calib", "int8_static")
OUT_DTYPES = (torch.float32, torch.bfloat16)


def is_int8(quant) -> bool:
    return quant in INT8_MODES


C_ALIGN = 16  # the conv kernel's activation channels: a multiple of 16, one 16-byte copy each


def _padded(c: int) -> int:
    return -(-c // C_ALIGN) * C_ALIGN


class QuantizedActivation(NamedTuple):
    """An activation quantized once, with its dequant scale, for every conv
    that consumes it (one scale for all of them), laid out as the conv
    kernel reads it."""

    q: torch.Tensor  # int8 [N, H, W, Cp]: NHWC, Cp = C rounded up to C_ALIGN, zeros past C
    scale: torch.Tensor  # fp32, [N, 1, 1, 1] or a scalar
    channels: int  # C

    def nchw(self) -> torch.Tensor:
        """The int8 activation [N, C, H, W] (a view)."""
        return self.q[..., : self.channels].permute(0, 3, 1, 2)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW weight: (wq int8, scale fp32 [O])."""
    w32 = w.float()
    s = (w32.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    wq = torch.round(w32 / s[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return wq, s


def per_sample_scale(x: torch.Tensor) -> torch.Tensor:
    """The scale of `quantize_act`: each sample's amax / 127, at least 1e-12,
    fp32 [N, 1, 1, 1] (the amax of |x| is exact in x's own type)."""
    return (x.abs().amax(dim=(1, 2, 3), keepdim=True).float() / 127.0).clamp_min(1e-12)


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-sample int8 of an NCHW activation: (xq int8, scale fp32 [N, 1, 1, 1])."""
    return quantize_act_with_scale(x, per_sample_scale(x))


def quantize_act_with_scale(x: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 of `x` with a precomputed scale (the calib and static modes)."""
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8), s


def quantize_pack_reference(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of `quantize_pack`: `quantize_act_with_scale`, then NHWC
    with the channels padded to a multiple of C_ALIGN."""
    C = x.shape[1]
    q, _ = quantize_act_with_scale(x, s)
    return F.pad(q.permute(0, 2, 3, 1), (0, _padded(C) - C)).contiguous()


def launch_quantize_pack(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor) -> None:
    """One launch of csrc/quantize_pack.cu on the current stream: `x` NCHW
    fp32 or bf16, `s` fp32 [N] or [1], into `q` int8 [N, H, W, Cp]."""
    N, C, H, W = x.shape
    QUANTIZE_PACK.launch(x.data_ptr(), s.data_ptr(), int(s.numel() != 1), q.data_ptr(),
                         int(x.dtype == torch.bfloat16), N, C, H * W, q.shape[3], x.device)


def quantize_pack(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 of the NCHW activation `x` with the scale `s` (a scalar or
    [N, 1, 1, 1]), NHWC [N, H, W, Cp] with zeros past C: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if x.dim() != 4:
        raise ValueError(f"quantize_pack takes an NCHW activation, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_pack_reference(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack runs on cpu or cuda tensors, got {x.device}")
    N, C, H, W = x.shape
    x = x.contiguous()
    check_tensor(x, "x", (N, C, H, W), x.device, (torch.float32, torch.bfloat16))
    s = s.float().reshape(-1).contiguous()
    if s.numel() not in (1, N):
        raise ValueError(f"quantize_pack: a scale of {s.numel()} values for a batch of {N}")
    check_tensor(s, "s", (s.numel(),), x.device)
    if N > 65535:
        raise ValueError(f"quantize_pack: a batch of {N}, the kernel takes at most 65535")
    q = torch.empty(N, H, W, _padded(C), dtype=torch.int8, device=x.device)
    if q.numel():
        launch_quantize_pack(x, s, q)
    return q


def quantize_activation(x: torch.Tensor, s: Optional[torch.Tensor] = None) -> QuantizedActivation:
    """Quantize the NCHW activation `x` once, with the scale `s`, or per
    sample where `s` is None."""
    s = per_sample_scale(x) if s is None else s
    return QuantizedActivation(quantize_pack(x, s), s, x.shape[1])


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
            cur = x.detach().abs().amax().float()
            self.act_amax.copy_(torch.maximum(self.act_amax, cur))
            return cur.clamp_min(1e-12) / 127.0
        if quant == "int8_static":
            return self.act_amax.clamp_min(1e-12) / 127.0
        raise ValueError(f"quant must be one of {INT8_MODES}, got {quant!r}")

    def quantize(self, x: torch.Tensor, quant: str) -> QuantizedActivation:
        """Quantize `x` once at this site (`quantize_act_for`)."""
        return quantize_activation(x, self.scale(x, quant))


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


class TapTable(NamedTuple):
    """A conv geometry's taps by output phase, on one device."""

    phases: list  # per phase, the (ky, kx, dy, dx) of its taps that land on real input
    table: torch.Tensor  # int32 [P, Tmax, 2]: (dy, dx) of each phase's taps
    counts: torch.Tensor  # int32 [P]
    gather: torch.Tensor  # int64 [P, Tmax]: ky * kw + kx of each tap, kh * kw (a zero tap) past the last


@functools.lru_cache(maxsize=None)
def _tap_table(kh, kw, stride, dil, pt, pl, device) -> TapTable:
    """The `TapTable` of a geometry, built once for each geometry and device."""
    phases = _phase_taps(kh, kw, stride, dil, pt, pl)
    tmax = max(max(len(t) for t in phases), 1)
    table = torch.zeros(len(phases), tmax, 2, dtype=torch.int32)
    gather = torch.full((len(phases), tmax), kh * kw, dtype=torch.long)
    for p, taps in enumerate(phases):
        for t, (ky, kx, dy, dx) in enumerate(taps):
            table[p, t, 0], table[p, t, 1] = dy, dx
            gather[p, t] = ky * kw + kx
    counts = torch.tensor([len(t) for t in phases], dtype=torch.int32)
    return TapTable(phases, table.to(device), counts.to(device), gather.to(device))


K_STEP = 128  # the largest K step of csrc/int8_conv.cu (its BK): Kp is a multiple of it
MAX_TAPS = 64  # csrc/int8_conv.cu:MAX_TAPS


class PackedWeight(NamedTuple):
    """A conv's int8 weight (the correlation kernel) as csrc/int8_conv.cu
    reads it, with its scale and geometry."""

    wq: torch.Tensor  # int8 OIHW, the plain version's operand
    sw: Optional[torch.Tensor]  # fp32 [O]
    w: torch.Tensor  # int8 [P, O, Kp]: each phase's taps in order, Cp channels each, zeros past them
    taps: TapTable
    stride: int
    padding_hw: Tuple[Tuple[int, int], Tuple[int, int]]  # ((top, bottom), (left, right)) on the dilated input
    dilation: int


def _pack_weight(wq: torch.Tensor, taps: TapTable, cp: int) -> torch.Tensor:
    """int8 OIHW -> int8 [P, O, Kp]: each phase's taps in order, `cp`
    channels each (zeros past C), zeros past the taps, Kp a multiple of K_STEP."""
    O, C, kh, kw = wq.shape
    P, T = taps.gather.shape
    kp = -(-T * cp // K_STEP) * K_STEP
    w = F.pad(wq, (0, 0, 0, 0, 0, cp - C)).reshape(O, cp, kh * kw)
    w = torch.cat([w, w.new_zeros(O, cp, 1)], dim=2)[:, :, taps.gather]  # [O, cp, P, T]
    return F.pad(w.permute(2, 0, 3, 1).reshape(P, O, T * cp), (0, kp - T * cp)).contiguous()


def pack_int8_weight(wq: torch.Tensor, sw: Optional[torch.Tensor], stride: int = 1,
                     padding_hw=((0, 0), (0, 0)), lhs_dilation: int = 1) -> PackedWeight:
    """Pack the int8 OIHW correlation kernel `wq` (scale `sw`, fp32 [O]) for
    a conv of this geometry."""
    if lhs_dilation > 1 and stride != 1:
        raise ValueError("int8_conv: input dilation needs stride 1")
    if lhs_dilation > 2:
        raise ValueError(f"int8_conv: input dilation {lhs_dilation}, the kernel takes 1 or 2")
    if min(padding_hw[0] + padding_hw[1]) < 0:
        raise ValueError(f"int8_conv: negative padding {padding_hw}")
    O, C, kh, kw = wq.shape
    (pt, _), (pl, _) = padding_hw
    taps = _tap_table(kh, kw, stride, lhs_dilation, pt, pl, wq.device)
    if taps.table.shape[1] > MAX_TAPS:
        raise ValueError(f"int8_conv: {taps.table.shape[1]} taps, the kernel takes at most {MAX_TAPS}")
    padding_hw = tuple(tuple(int(v) for v in pair) for pair in padding_hw)
    return PackedWeight(wq, None if sw is None else sw.float().contiguous(), _pack_weight(wq, taps, _padded(C)), taps,
                        stride, padding_hw, lhs_dilation)


def pack_weight(w: torch.Tensor, padding_hw=((0, 0), (0, 0)), stride: int = 1, lhs_dilation: int = 1,
                flip_weight: bool = True) -> PackedWeight:
    """Quantize the float OIHW weight `w` per output channel and pack it;
    `flip_weight=False` flips the kernel spatially first."""
    wq, sw = quantize_weight(w if flip_weight else w.flip([2, 3]))
    return pack_int8_weight(wq, sw, stride, padding_hw, lhs_dilation)


class Int8WeightCache:
    """One conv module's `PackedWeight`, built on its first int8 forward and
    kept until its source changes: the source parameter's identity, storage
    and `_version` (an in-place update or `load_state_dict` bumps it, `.to()`
    moves the storage), plus the caller's key (the quant mode, the geometry
    and whatever else the weight was derived from)."""

    def __init__(self):
        self._source: Optional[torch.Tensor] = None
        self._key = None
        self.value: Optional[PackedWeight] = None
        self.builds = 0

    def get(self, source: torch.Tensor, key: tuple, build) -> PackedWeight:
        k = (source.data_ptr(), source._version, source.device, source.dtype, tuple(source.shape)) + tuple(key)
        if source is not self._source or k != self._key:
            with torch.no_grad():
                self.value = build()
            self._source, self._key = source, k
            self.builds += 1
        return self.value


class KernelOperands(NamedTuple):
    """What csrc/int8_conv.cu reads besides the scales."""

    x: torch.Tensor  # int8 [N, H, W, Cp], NHWC, zeros in the channels past C
    w: torch.Tensor  # int8 [P, O, Kp]: each phase's valid taps in order, Cp channels each, zeros past them
    taps: torch.Tensor  # int32 [P, Tmax, 2]: (dy, dx) of each phase's valid taps
    ntaps: torch.Tensor  # int32 [P]
    stride: int
    dilation: int
    out_hw: Tuple[int, int]


def _operands(xp: torch.Tensor, pw: PackedWeight) -> KernelOperands:
    """The kernel's operands: the packed activation `xp` [N, H, W, Cp] and
    the packed weight."""
    _, H, W, _ = xp.shape
    _, _, kh, kw = pw.wq.shape
    (pt, pb), (pl, pr) = pw.padding_hw
    out_hw = (_out_size(H, kh, pw.stride, pt, pb, pw.dilation), _out_size(W, kw, pw.stride, pl, pr, pw.dilation))
    return KernelOperands(xp, pw.w, pw.taps.table, pw.taps.counts, pw.stride, pw.dilation, out_hw)


def kernel_operands(xq, wq, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1) -> KernelOperands:
    """Lay out the kernel's operands from an int8 NCHW activation and OIHW
    weight: the activation NHWC with its channels padded to a multiple of
    C_ALIGN, the weight packed by phase, the tap table."""
    C = xq.shape[1]
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, _padded(C) - C)).contiguous()
    return _operands(xp, pack_int8_weight(wq, None, stride, padding_hw, lhs_dilation))


def launch_kernel(ops: KernelOperands, sx: torch.Tensor, sw: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of csrc/int8_conv.cu on the current stream into `out`
    [N, O, Ho, Wo] (fp32 or bf16); `sx` fp32 [N] or [1], `sw` fp32 [O]."""
    N, H, W, cp = ops.x.shape
    _, O, kp = ops.w.shape
    INT8_CONV.launch(ops.x.data_ptr(), ops.w.data_ptr(), ops.taps.data_ptr(), ops.ntaps.data_ptr(), sx.data_ptr(),
                     int(sx.numel() == N), sw.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), N, cp,
                     H, W, O, ops.out_hw[0], ops.out_hw[1], ops.stride, ops.dilation, kp, ops.taps.shape[1],
                     ops.x.device)


def _launch(xp: torch.Tensor, sx: torch.Tensor, pw: PackedWeight, out_dtype) -> torch.Tensor:
    """Check the packed operands and run the kernel into a new output."""
    dev = xp.device
    N, H, W, cp = xp.shape
    O, C = pw.wq.shape[:2]
    check_tensor(xp, "x", (N, H, W, _padded(C)), dev, (torch.int8,))
    check_tensor(pw.w, "w", pw.w.shape, dev, (torch.int8,))
    sx = sx.float().reshape(-1).contiguous()
    if sx.numel() not in (1, N):
        raise ValueError(f"int8_conv: activation scale of {sx.numel()} values for a batch of {N}")
    check_tensor(sx, "sx", (sx.numel(),), dev)
    check_tensor(pw.sw, "sw", (O,), dev)
    ops = _operands(xp, pw)
    out = torch.empty(N, O, max(ops.out_hw[0], 0), max(ops.out_hw[1], 0), dtype=out_dtype, device=dev)
    if out.numel():
        launch_kernel(ops, sx, pw.sw, out)
    return out


def _int8_conv_kernel(xq, wq, sx, sw, stride, padding_hw, lhs_dilation, out_dtype):
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    check_tensor(xq, "xq", (N, C, H, W), xq.device, (torch.int8,))
    check_tensor(wq, "wq", (O, C, kh, kw), xq.device, (torch.int8,))
    pw = pack_int8_weight(wq, sw, stride, padding_hw, lhs_dilation)
    if sx.numel() not in (1, N):
        raise ValueError(f"int8_conv: activation scale of {sx.numel()} values for a batch of {N}")
    return _launch(F.pad(xq.permute(0, 2, 3, 1), (0, _padded(C) - C)).contiguous(), sx, pw, out_dtype)


def int8_conv(xq, wq, sx, sw, stride=1, padding_hw=((0, 0), (0, 0)), lhs_dilation=1,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The s8 x s8 -> s32 convolution with the fused dequant on NCHW / OIHW
    operands (arguments as in `int8_conv_reference`): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if xq.device.type == "cpu":
        return int8_conv_reference(xq, wq, sx, sw, stride, padding_hw, lhs_dilation, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda tensors, got {xq.device}")
    return _int8_conv_kernel(xq.contiguous(), wq.contiguous(), sx, sw, stride, padding_hw, lhs_dilation, out_dtype)


def int8_conv_packed(xa: QuantizedActivation, pw: PackedWeight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The convolution of int8 serving on its packed operands: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"int8_conv: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if xa.channels != pw.wq.shape[1]:
        raise ValueError(f"int8_conv: an activation of {xa.channels} channels for a weight of {pw.wq.shape[1]}")
    if xa.q.device.type == "cpu":
        return int8_conv_reference(xa.nchw(), pw.wq, xa.scale, pw.sw, pw.stride, pw.padding_hw, pw.dilation,
                                   out_dtype)
    if xa.q.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda tensors, got {xa.q.device}")
    return _launch(xa.q, xa.scale, pw, out_dtype)


def int8_conv2d(x: Union[torch.Tensor, QuantizedActivation], w: Union[torch.Tensor, PackedWeight],
                padding=(0, 0, 0, 0), stride: int = 1, lhs_dilation: int = 1, flip_weight: bool = True,
                out_dtype=torch.bfloat16, act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 drop-in for `ops/conv2d_resample.py:_conv2d` on NCHW `x` (float,
    or already quantized) and the float OIHW weight `w`, or a `PackedWeight`
    packed for this geometry: padding (px0, px1, py0, py1);
    `flip_weight=True` is correlation, False flips the kernel spatially (a
    packed weight is the correlation kernel already); `act_scale` None
    quantizes a float `x` per sample."""
    px0, px1, py0, py1 = padding
    pads = ((py0, py1), (px0, px1))
    if not isinstance(w, PackedWeight):
        w = pack_weight(w, pads, stride, lhs_dilation, flip_weight)
    elif (w.padding_hw, w.stride, w.dilation, flip_weight) != (pads, stride, lhs_dilation, True):
        raise ValueError(f"int8_conv2d: a weight packed for padding {w.padding_hw}, stride {w.stride}, dilation "
                         f"{w.dilation}, called with {pads}, {stride}, {lhs_dilation}, flip_weight {flip_weight}")
    xa = x if isinstance(x, QuantizedActivation) else quantize_activation(x, act_scale)
    return int8_conv_packed(xa, w, out_dtype)


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
