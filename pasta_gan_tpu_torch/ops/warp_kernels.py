"""The two routing kernels of the try-on path and their plain PyTorch versions.

* `norm_warp` (csrc/norm_warp.cu) replaces `pasta_gan_tpu/ops/pallas_warp.py:_norm_kernel`:
  full frames -> planar per-part patches, bilinear, replicate border.
* `composite` (csrc/composite.cu) replaces `pallas_warp.py:_composite_kernel`:
  patches -> frame (constant-zero border), mask >= 254.5/255, 5x5 erosion of
  flagged parts, later-parts-overwrite composite into group planes, hand masks.

Each wrapper runs its plain version for tensors on the CPU, and for CUDA
tensors launches its kernel or raises; there is no fallback.  The plain
versions (`norm_warp_reference`, `composite_reference`) are the same math as
the JAX package's CPU paths (`_warp_parts_gather`, and the separate-pass
composite of `route_patches_single`); the CPU tests hold them against JAX and
`chip_smoke.py` holds the kernels against them on the card.

Kernels are built with nvcc into `pasta_gan_tpu_torch/build/` at first use
(one shared library per source, plain C interface, loaded with ctypes) and
count their launches in `KERNELS[name].launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .warp_math import warp_coords

# cv2's `== 255` on uint8 masks, as a float32 threshold.
MASK_SATURATION_THRESHOLD = float(np.float32(254.5 / 255.0))

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


class CudaKernel:
    """One kernel: its source, its C entry point, its build and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source  # file name under csrc/
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC_DIR, self.source)

    def library_path(self) -> str:
        with open(self.source_path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"{os.path.splitext(self.source)[0]}-{digest}.so")

    def _function(self):
        if self._fn is None:
            path = self.library_path()
            if not os.path.exists(path):
                build_kernels([self])
            fn = getattr(ctypes.CDLL(path), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed with CUDA error {rc}")
        self.launches += 1


NORM_WARP = CudaKernel(
    "norm_warp", "norm_warp.cu", "pasta_norm_warp_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
COMPOSITE = CudaKernel(
    "composite", "composite.cu", "pasta_composite_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _U, _I, _F, _P],
)
KERNELS: Dict[str, CudaKernel] = {k.name: k for k in (NORM_WARP, COMPOSITE)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_kernels(kernels: Optional[Sequence[CudaKernel]] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, one nvcc per source, all
    started together.  Returns {name: ptxas report} for the ones built."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in kernels:
        out = k.library_path()
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, k.source_path]
        procs.append((k, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports = {}
    for k, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k.source} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        reports[k.name] = log
    return reports


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------- norm


def norm_warp_reference(src0, src1, minv, valid, n0: int, out_hw) -> torch.Tensor:
    """Plain version of `norm_warp`: the bilinear gather of
    `pasta_gan_tpu/data/warp.py:_bilinear_core` (replicate border).  A
    non-finite coordinate gives NaN here, where the kernel (like the TPU
    kernel) squashes it to 0; routed matrices are always finite."""
    B, H, W, C = src0.shape
    N = minv.shape[1]
    sx, sy = warp_coords(minv, out_hw)  # [B, N, h, w]
    sx = sx.clamp(0.0, W - 1)
    sy = sy.clamp(0.0, H - 1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    xi = x0.long().clamp(0, W - 1)
    yi = y0.long().clamp(0, H - 1)
    xj = (xi + 1).clamp(max=W - 1)
    yj = (yi + 1).clamp(max=H - 1)
    frames = torch.stack([src0, src1], dim=1).reshape(-1, C)  # [(B*2*H*W), C]
    sel = (torch.arange(N, device=minv.device) >= n0).long()
    fidx = (torch.arange(B, device=minv.device)[:, None] * 2 + sel[None, :])[..., None, None]

    def tap(yy, xx):
        return frames[(fidx * H + yy) * W + xx]  # [B, N, h, w, C]

    top = tap(yi, xi) * (1 - fx) + tap(yi, xj) * fx
    bot = tap(yj, xi) * (1 - fx) + tap(yj, xj) * fx
    out = top * (1 - fy) + bot * fy
    out = out * valid[:, :, None, None, None]
    return out.permute(0, 1, 4, 2, 3).contiguous()


def norm_warp(src0, src1, minv, valid, n0: int, out_hw) -> torch.Tensor:
    """NORM warps of B samples x N parts in one launch.

    src0, src1: [B, H, W, 4] float32 NHWC frames (parts p < n0 sample src0,
    the rest src1); minv: [B, N, 3, 3] dst->src homographies (inverses of the
    frame->patch M); valid: [B, N] float32 gate.  Returns planar
    [B, N, 4, h, w] float32."""
    if src0.device.type == "cpu":
        return norm_warp_reference(src0, src1, minv, valid, n0, out_hw)
    if src0.device.type != "cuda":
        raise ValueError(f"norm_warp runs on cpu or cuda tensors, got {src0.device}")
    B, H, W, C = src0.shape
    N = minv.shape[1]
    h, w = out_hw
    dev = src0.device
    if C != 4:
        raise ValueError(f"norm_warp needs 4-channel frames, got {C}")
    _check(src0, "src0", (B, H, W, 4), dev)
    _check(src1, "src1", (B, H, W, 4), dev)
    _check(minv, "minv", (B, N, 3, 3), dev)
    _check(valid, "valid", (B, N), dev)
    out = torch.empty((B, N, 4, h, w), dtype=torch.float32, device=dev)
    NORM_WARP.launch(
        src0.data_ptr(), src1.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, N, n0, H, W, h, w, _stream(dev),
    )
    return out


# ---------------------------------------------------------------- composite


def denorm_warp_reference(srcs, minv, out_hw) -> torch.Tensor:
    """Patches [B, N, C, Hs, Ws] -> frames [B, N, C, H, W]: the bilinear gather
    of `_bilinear_core` with a constant-zero border (the JAX CPU path computes
    the same samples as hat contractions)."""
    B, N, C, Hs, Ws = srcs.shape
    H, W = out_hw
    sx, sy = warp_coords(minv, out_hw)  # [B, N, H, W]
    outside = (sx <= -1.0) | (sx >= Ws) | (sy <= -1.0) | (sy >= Hs)
    sx = sx.clamp(-1.0, float(Ws))
    sy = sy.clamp(-1.0, float(Hs))
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).reshape(B * N, 1, H * W)
    fy = (sy - y0).reshape(B * N, 1, H * W)
    # indices into the zero-padded patch [Hs + 2, Ws + 2]
    xi = (x0.long() + 1).clamp(0, Ws + 1).reshape(B * N, 1, H * W)
    yi = (y0.long() + 1).clamp(0, Hs + 1).reshape(B * N, 1, H * W)
    xj = (xi + 1).clamp(max=Ws + 1)
    yj = (yi + 1).clamp(max=Hs + 1)
    padded = F.pad(srcs, (1, 1, 1, 1)).reshape(B * N, C, (Hs + 2) * (Ws + 2))

    def tap(yy, xx):
        return torch.gather(padded, 2, (yy * (Ws + 2) + xx).expand(B * N, C, H * W))

    top = tap(yi, xi) * (1 - fx) + tap(yi, xj) * fx
    bot = tap(yj, xi) * (1 - fx) + tap(yj, xj) * fx
    out = top * (1 - fy) + bot * fy
    out = torch.where(outside.reshape(B * N, 1, H * W), torch.zeros_like(out), out)
    return out.reshape(B, N, C, H, W)


def erode_binary(mask: torch.Tensor, size: int = 5) -> torch.Tensor:
    """cv2.erode with its default (+inf) border on a binary mask [..., H, W]:
    a min-pool with SAME padding (max_pool2d pads with -inf)."""
    shape = mask.shape
    m = mask.reshape((-1, 1) + tuple(shape[-2:]))
    m = -F.max_pool2d(-m, size, stride=1, padding=size // 2)
    return m.reshape(shape)


def composite_reference(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts):
    """Plain version of `composite`: the separate-pass pipeline of
    `pasta_gan_tpu/data/warp.py:route_patches_single` (warp -> threshold ->
    erode_binary -> select chain), op for op."""
    B, N = srcs.shape[:2]
    H, W = out_hw
    dn = denorm_warp_reference(srcs, minv, out_hw) * valid[:, :, None, None, None]
    thresh = torch.tensor(MASK_SATURATION_THRESHOLD, dtype=torch.float32, device=srcs.device)
    sat = (dn[:, :, 3] >= thresh).to(srcs.dtype)  # [B, N, H, W]
    ero = [p for p in range(N) if erode_parts[p]]
    if ero:
        sat = sat.clone()
        sat[:, ero] = erode_binary(sat[:, ero])
    vmask = valid[:, :, None, None]
    n_groups = max(groups) + 1
    acc = [torch.zeros((B, 3, H, W), dtype=srcs.dtype, device=srcs.device) for _ in range(n_groups)]
    for p in range(N):
        v = (sat[:, p] * vmask[:, p])[:, None]  # [B, 1, H, W]
        acc[groups[p]] = dn[:, p, 0:3] * v + acc[groups[p]] * (1 - v)
    hands = [sat[:, p] * vmask[:, p] for p in hand_parts]
    hands = torch.stack(hands, dim=1) if hands else srcs.new_zeros((B, 0, H, W))
    return torch.stack(acc, dim=1), hands


def composite(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts):
    """Fused denorm -> saturate -> erode -> composite.

    srcs: [B, N, 4, h, w] float32 planar patches (mask last); minv: [B, N, 3, 3]
    frame->patch homographies (inverses of the patch->frame M); valid: [B, N]
    float32; groups / erode_parts: per part; hand_parts: ascending part ids.
    Returns (group_imgs [B, n_groups, 3, H, W], hand_masks [B, n_hands, H, W])."""
    if srcs.device.type == "cpu":
        return composite_reference(srcs, minv, valid, out_hw, groups, erode_parts, hand_parts)
    if srcs.device.type != "cuda":
        raise ValueError(f"composite runs on cpu or cuda tensors, got {srcs.device}")
    B, N, C, Hs, Ws = srcs.shape
    H, W = out_hw
    dev = srcs.device
    n_groups = max(groups) + 1
    if C != 4 or N > 32 or n_groups > 2 or len(groups) != N or len(erode_parts) != N:
        raise ValueError("composite takes 4-channel patches, <= 32 parts and <= 2 groups")
    if list(hand_parts) != sorted(set(hand_parts)):
        raise ValueError(f"hand_parts must be ascending and unique, got {hand_parts}")
    _check(srcs, "srcs", (B, N, 4, Hs, Ws), dev)
    _check(minv, "minv", (B, N, 3, 3), dev)
    _check(valid, "valid", (B, N), dev)
    group_bits = sum(1 << p for p in range(N) if groups[p] == 1)
    erode_bits = sum(1 << p for p in range(N) if erode_parts[p])
    hand_bits = sum(1 << p for p in hand_parts)
    g_out = torch.empty((B, n_groups, 3, H, W), dtype=torch.float32, device=dev)
    h_out = torch.empty((B, len(hand_parts), H, W), dtype=torch.float32, device=dev)
    COMPOSITE.launch(
        srcs.data_ptr(), minv.data_ptr(), valid.data_ptr(), g_out.data_ptr(),
        h_out.data_ptr() if hand_parts else None,
        B, N, Hs, Ws, H, W, n_groups, group_bits, erode_bits, hand_bits, len(hand_parts),
        MASK_SATURATION_THRESHOLD, _stream(dev),
    )
    return g_out, h_out
