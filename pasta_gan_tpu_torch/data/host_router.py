"""Host-side patch routing (counterpart of `pasta_gan_tpu/data/host_router.py`).

The reference routes its patches inside DataLoader workers, one
`cv2.warpPerspective` per part per sample on the host
(`training/dataset.py:863-927`).  This module is that path without the card:
the same norm / denorm pipeline as `data/warp.py`'s routes, run on numpy
arrays with the plain C++ warp `csrc/host_ops.cpp` (row-threaded) under a
per-sample thread pool, and `HostRoutingPipeline`, which routes batch i + 1
on threads while the caller's device step runs on batch i.  Nothing here
touches a card; the geometry (the 8x8 solves of `data/geometry.py`) runs on
CPU tensors.

The warp library is built from the checkout at first use into `build/`
(g++ with the JAX package's flags, `-O3 -march=native -std=c++17`, under a
name that hashes the source and the flags) and loaded with ctypes, which
releases the interpreter lock for the call.  A failed build raises; there is
no numpy fallback.

Outputs agree with the device route (`data/warp.py`) up to the bilinear
rounding of float64 coordinates against float32 ones, which can move a mask
pixel across the saturation threshold (tests/test_torch_host_router.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.warp_kernels import MASK_SATURATION_THRESHOLD
from .geometry import HAND_PARTS, LOWER_PART_START, NUM_PARTS, part_transforms
from .masks import _dilate

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")  # pasta_gan_tpu/native/__init__.py:37
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> Tuple[str, ...]:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) was found: {SOURCE} cannot be built")
    return (cxx, *CXX_FLAGS)


def library_path(compiler: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(compiler[1:]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"host_ops-{h.hexdigest()[:12]}.so")


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        compiler = _compiler()
        path = library_path(compiler)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run([*compiler, "-o", tmp, SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        F, I = ctypes.POINTER(ctypes.c_float), ctypes.c_int
        lib.warp_perspective_f32.argtypes = [F, I, I, I, F, I, I, ctypes.POINTER(ctypes.c_double), I]
        lib.warp_perspective_f32.restype = None
        _lib = lib
        return lib


def warp_perspective(src: np.ndarray, M: np.ndarray, out_hw, border: str = "constant") -> np.ndarray:
    """cv2.warpPerspective(src [H, W, C] float32, M src->dst, (w, h)),
    bilinear, constant-0 or replicate border; [h, w, C] float32."""
    if border not in ("constant", "replicate"):
        raise ValueError(f"border must be 'constant' or 'replicate', got {border!r}")
    lib = _library()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim == 2:
        src = src[..., None]
    h, w = out_hw
    dst = np.empty((h, w, src.shape[2]), np.float32)
    M64 = np.ascontiguousarray(M, np.float64)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.warp_perspective_f32(src.ctypes.data_as(fp), src.shape[0], src.shape[1], src.shape[2], dst.ctypes.data_as(fp),
                             h, w, M64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(border == "replicate"))
    return dst


def part_transforms_np(keypoints: np.ndarray, img_h: int, patch_w: int, patch_h: int, pad_x: float = 32.0,
                       knee_fallbacks: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched (M, M_inv, valid) as numpy arrays: `geometry.part_transforms`
    on CPU tensors."""
    M, M_inv, valid = part_transforms(torch.as_tensor(np.asarray(keypoints, np.float32)), img_h=img_h,
                                      patch_w=patch_w, patch_h=patch_h, pad_x=pad_x, knee_fallbacks=knee_fallbacks)
    return M.numpy(), M_inv.numpy(), valid.numpy()


def _erode5(mask: np.ndarray) -> np.ndarray:
    """cv2.erode(5x5, +inf border) of a binary [H, W, 1] mask: 1 - dilate(1 - mask)."""
    return 1.0 - _dilate(1.0 - mask, 5)


def route_patches_host_single(
    upper_img: np.ndarray,  # [H, W, 3] in [0, 1]
    lower_img: np.ndarray,
    upper_clothes_mask: np.ndarray,  # [H, W, 1] in {0, 1}
    lower_clothes_mask: np.ndarray,
    M: np.ndarray,  # [10, 3, 3]
    M_inv: np.ndarray,
    valid: np.ndarray,  # [10] bool
    box_factor: int = 2,
    M_lower: Optional[np.ndarray] = None,
    valid_lower: Optional[np.ndarray] = None,
    denorm_valid: Optional[np.ndarray] = None,
    erode_upper: bool = False,
) -> Dict[str, np.ndarray]:
    """One sample's routing on the host: norm warps with a replicate border,
    the denorm re-projection with a zero border, mask saturation at
    254.5/255, optional 5x5 erosion of parts 0-5, and the in-order composite
    (later parts overwrite earlier ones).  Returns the `RoutedPatches` fields
    as a dict of numpy arrays."""
    H, W = upper_img.shape[0], upper_img.shape[1]
    h, w = H >> box_factor, W >> box_factor
    M_lower = M if M_lower is None else M_lower
    valid_lower = valid if valid_lower is None else valid_lower
    denorm_valid = valid if denorm_valid is None else denorm_valid
    L = NUM_PARTS - LOWER_PART_START

    srcU = np.concatenate([np.asarray(upper_img, np.float32), np.asarray(upper_clothes_mask[..., :1], np.float32)], -1)
    srcL = np.concatenate([np.asarray(lower_img, np.float32), np.asarray(lower_clothes_mask[..., :1], np.float32)], -1)

    warpedU = np.zeros((NUM_PARTS, h, w, 4), np.float32)
    for p in range(NUM_PARTS):
        if valid[p]:
            warpedU[p] = warp_perspective(srcU, M[p], (h, w), "replicate")
    warpedL = np.zeros((L, h, w, 4), np.float32)
    for i in range(L):
        if valid_lower[LOWER_PART_START + i]:
            warpedL[i] = warp_perspective(srcL, M_lower[LOWER_PART_START + i], (h, w), "replicate")

    dn = np.zeros((NUM_PARTS + L, H, W, 4), np.float32)
    for p in range(NUM_PARTS):
        if denorm_valid[p]:
            dn[p] = warp_perspective(warpedU[p], M_inv[p], (H, W), "constant")
    for i in range(L):
        if denorm_valid[LOWER_PART_START + i]:
            dn[NUM_PARTS + i] = warp_perspective(warpedL[i], M_inv[LOWER_PART_START + i], (H, W), "constant")

    sat = (dn[..., 3:4] >= MASK_SATURATION_THRESHOLD).astype(np.float32)
    if erode_upper:
        for p in range(LOWER_PART_START):
            sat[p] = _erode5(sat[p])

    denorm_upper = np.zeros((H, W, 3), np.float32)
    hand_masks = {}
    for p in range(NUM_PARTS):
        valid_p = sat[p] * float(denorm_valid[p])
        denorm_upper = dn[p, ..., 0:3] * valid_p + denorm_upper * (1.0 - valid_p)
        if p in HAND_PARTS:
            hand_masks[p] = valid_p
    denorm_lower = np.zeros((H, W, 3), np.float32)
    for i in range(L):
        valid_p = sat[NUM_PARTS + i] * float(denorm_valid[LOWER_PART_START + i])
        denorm_lower = dn[NUM_PARTS + i, ..., 0:3] * valid_p + denorm_lower * (1.0 - valid_p)

    def stack_ch(x):  # [P, h, w, C] -> [h, w, P*C]
        return np.transpose(x, (1, 2, 0, 3)).reshape(x.shape[1], x.shape[2], -1)

    return {
        "norm_img": stack_ch(warpedU[..., 0:3]),
        "norm_img_lower": stack_ch(warpedL[..., 0:3]),
        "denorm_upper_img": denorm_upper,
        "denorm_lower_img": denorm_lower,
        "M_invs": np.asarray(M_inv, np.float32),
        "denorm_hand_masks": np.stack([hand_masks[p] for p in HAND_PARTS], axis=0),
        "norm_clothes_masks": stack_ch(np.repeat(warpedU[..., 3:4], 3, axis=-1)),
        "norm_clothes_masks_lower": stack_ch(np.repeat(warpedL[..., 3:4], 3, axis=-1)),
        "valid": np.asarray(valid),
    }


def _map_samples(fn, B: int, workers: Optional[int], pool: Optional[ThreadPoolExecutor]) -> Dict[str, np.ndarray]:
    if pool is not None:
        outs = list(pool.map(fn, range(B)))
    else:
        with ThreadPoolExecutor(max_workers=workers or min(B, os.cpu_count() or 1)) as ex:
            outs = list(ex.map(fn, range(B)))
    return {k: np.stack([o[k] for o in outs], axis=0) for k in outs[0]}


def route_patches_host_batch(
    upper_img: np.ndarray,  # [B, H, W, 3]
    lower_img: np.ndarray,
    upper_clothes_mask: np.ndarray,
    lower_clothes_mask: np.ndarray,
    keypoints: np.ndarray,  # [B, 18, 3]
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 32.0,
    workers: Optional[int] = None,
    pool: Optional[ThreadPoolExecutor] = None,
) -> Dict[str, np.ndarray]:
    """Host counterpart of `data/warp.py:route_patches_batch` (training
    self-routing), one sample a task on `pool` (or on `workers` threads)."""
    h, w = upper_img.shape[1] >> box_factor, upper_img.shape[2] >> box_factor
    M, M_inv, valid = part_transforms_np(keypoints, img_h or upper_img.shape[1], w, h, pad_x)

    def fn(i):
        return route_patches_host_single(upper_img[i], lower_img[i], upper_clothes_mask[i], lower_clothes_mask[i],
                                         M[i], M_inv[i], valid[i], box_factor=box_factor)

    return _map_samples(fn, upper_img.shape[0], workers, pool)


def route_patches_host_transfer_batch(
    garment_upper_img: np.ndarray,
    person_lower_img: np.ndarray,
    garment_upper_mask: np.ndarray,
    person_lower_mask: np.ndarray,
    garment_keypoints: np.ndarray,
    person_keypoints: np.ndarray,
    box_factor: int = 2,
    img_h: Optional[int] = None,
    pad_x: float = 32.0,
    workers: Optional[int] = None,
    pool: Optional[ThreadPoolExecutor] = None,
) -> Dict[str, np.ndarray]:
    """Host counterpart of `route_patches_transfer_batch` (unpaired try-on):
    the upper garment normalizes with the garment's M, the person's lower
    clothes self-route, everything denorms with the person's M_inv, and
    parts 0-5 are eroded."""
    H = img_h or garment_upper_img.shape[1]
    h, w = garment_upper_img.shape[1] >> box_factor, garment_upper_img.shape[2] >> box_factor
    Mg, _, valid_g = part_transforms_np(garment_keypoints, H, w, h, pad_x, knee_fallbacks=True)
    Mp, Mp_inv, valid_p = part_transforms_np(person_keypoints, H, w, h, pad_x, knee_fallbacks=True)

    def fn(i):
        return route_patches_host_single(
            garment_upper_img[i], person_lower_img[i], garment_upper_mask[i], person_lower_mask[i], Mg[i], Mp_inv[i],
            valid_g[i], box_factor=box_factor, M_lower=Mp[i], valid_lower=valid_p[i], denorm_valid=valid_p[i],
            erode_upper=True)

    return _map_samples(fn, garment_upper_img.shape[0], workers, pool)


_SENTINEL = object()


class HostRoutingPipeline:
    """Double-buffered host routing: a prefetch thread pulls raw host batches
    from `loader`, routes each with `route_fn(host_batch, pool)` on a shared
    thread pool and keeps up to `depth` routed batches ready, so batch i + 1
    is routed while the consumer's step runs on batch i.  Iterate to consume;
    an error of the loader or of `route_fn` is raised on the consumer's side
    after the batches before it; exhaustion or `close()` stops the
    prefetcher and the pool."""

    def __init__(self, loader: Iterable, route_fn: Callable, depth: int = 2, workers: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=workers or (os.cpu_count() or 1))
        self._err: Optional[BaseException] = None

        def put(item) -> None:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def run():
            try:
                for hb in loader:
                    if self._stop.is_set():
                        return
                    put(route_fn(hb, self._pool))
            except BaseException as e:  # raised on the consumer's side
                self._err = e
            finally:
                # never drop the sentinel: the consumer's get() blocks until it
                # comes (or until close() sets the stop flag)
                put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            self.close()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)


def training_route_fn(box_factor: int = 2, pad_x: float = 32.0) -> Callable:
    """`route_fn` of `HostRoutingPipeline` over training host batches (the
    collate dict of `data/dataset.py`: uint8 `image`, `upper_mask`,
    `lower_mask`, `keypoints`): {"host_batch", "routed"}."""

    def fn(host_batch: Dict[str, np.ndarray], pool: ThreadPoolExecutor):
        img = np.asarray(host_batch["image"], np.float32) / 255.0
        up = np.asarray(host_batch["upper_mask"], np.float32)
        lo = np.asarray(host_batch["lower_mask"], np.float32)
        routed = route_patches_host_batch(img * up, img * lo, up, lo, np.asarray(host_batch["keypoints"], np.float32),
                                          box_factor=box_factor, pad_x=pad_x, pool=pool)
        return {"host_batch": host_batch, "routed": routed}

    return fn
