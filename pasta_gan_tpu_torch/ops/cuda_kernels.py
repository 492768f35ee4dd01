"""The port's CUDA kernels: one registry, one build helper, one launch count each.

Every hand-written kernel of the port is declared here, so that
`build_kernels()` builds all of them and `KERNELS` lists all of them:

* `norm_warp`    csrc/norm_warp.cu     (wrapper: ops/warp_kernels.py)
* `composite`    csrc/composite.cu     (wrapper: ops/warp_kernels.py)
* `denorm_warp`  csrc/denorm_warp.cu   (wrapper: ops/warp_kernels.py)
* `up2`          csrc/upfirdn2x.cu     (wrapper: ops/upfirdn_kernels.py)
* `down2`        csrc/upfirdn2x.cu     (wrapper: ops/upfirdn_kernels.py)

Kernels are built with nvcc into `pasta_gan_tpu_torch/build/` at first use
(one shared library per source, plain C interface, loaded with ctypes; the
library's file name hashes the source, every header under csrc/ and the
flags, so an edited header rebuilds its includers); each
C entry point launches on the stream it is given and returns
`cudaGetLastError()`.  `CudaKernel.launch` raises on a nonzero return and
adds one to `launches` for every launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_longlong


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
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source_path] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:12]
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
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)
COMPOSITE = CudaKernel(
    "composite", "composite.cu", "pasta_composite_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _U, _I, _F, _P],
)
# (src, minv, valid, out, B, N, C, Hs, Ws, H, W, replicate, stream)
DENORM_WARP = CudaKernel(
    "denorm_warp", "denorm_warp.cu", "pasta_denorm_warp_f32",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
)
# (x, y, bf16, planes, H, W, extend | pad, gain, stream)
UP2 = CudaKernel("up2", "upfirdn2x.cu", "pasta_up2", [_P, _P, _I, _L, _I, _I, _I, _F, _P])
DOWN2 = CudaKernel("down2", "upfirdn2x.cu", "pasta_down2", [_P, _P, _I, _L, _I, _I, _I, _F, _P])
KERNELS: Dict[str, CudaKernel] = {k.name: k for k in (NORM_WARP, COMPOSITE, DENORM_WARP, UP2, DOWN2)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_kernels(kernels: Optional[Sequence[CudaKernel]] = None) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc per source, all
    started together.  Returns {source: ptxas report} for the ones built."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for k in kernels:
        out = k.library_path()
        if os.path.exists(out) or k.source in procs:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, k.source_path]
        procs[k.source] = (out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    for source, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        reports[source] = log
    return reports


def check_tensor(t: torch.Tensor, name: str, shape, device, dtypes=(torch.float32,)) -> None:
    """Raise unless `t` lies on `device` with one of `dtypes`, the given shape
    and a contiguous layout: what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
