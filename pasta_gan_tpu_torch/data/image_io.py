"""Image decoding for the host data path, without PIL or cv2.

The port's counterpart of the three PIL calls the JAX package's data code
makes (`pasta_gan_tpu/data/dataset.py:63,71,144`), each giving the same array
as Pillow on libjpeg-turbo, bit for bit:

* `read_image(p)`  == `np.asarray(PIL.Image.open(p))`
* `read_rgb(p)`    == `np.asarray(PIL.Image.open(p).convert("RGB"))`
* `read_l_resized(p, (w, h))` == `np.asarray(PIL.Image.open(p).convert("L").resize((w, h)))`

and, for `cli/calc_metrics.py`'s folder source, `resize(img, (w, h), "lanczos")`
== `np.asarray(PIL.Image.fromarray(img).resize((w, h), PIL.Image.LANCZOS))`.

JPEG (baseline and extended sequential Huffman, 8-bit, grey or YCbCr at
4:4:4, 4:2:2 or 4:2:0, restart intervals) is decoded by the plain-C library
`csrc/host_decode.c`, which follows libjpeg's integer IDCT, fancy upsampling
and colour tables.  PNG is inflated with `zlib` and unfiltered in the same
library: 8-bit grey, grey+alpha, RGB and RGBA, palette at 1, 2, 4 and 8 bits
(as indices, which is what `np.asarray` gives for a `P` image) and 1-bit grey
(PIL's mode `1`, a boolean array).  Progressive, lossless, arithmetic-coded,
12-bit and 4-component JPEG, 16-bit, 2/4-bit grey and interlaced PNG raise
`ValueError` naming the file.

`write_png(img, path)` writes an 8-bit grey [H, W] or RGB [H, W, 3] array
as an unfiltered PNG (`zlib` and `struct` only): what the try-on CLIs and the
training snapshot grids write.

The library is built from the checkout at first use into `build/` (nvcc as
the host compiler driver where it is found, else `cc`) under a name that
hashes the source and the flags, and loaded with ctypes, which releases the
interpreter lock for the call: the loader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import struct
import subprocess
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_decode.c")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CC_FLAGS = ("-O2", "-shared", "-fPIC")
_ERRLEN = 256
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> Tuple[str, ...]:
    """nvcc (compiling C for the host) where it is found, else cc."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.exists(nvcc) else shutil.which("nvcc")
    if nvcc:
        return (nvcc, "-x", "c", "-O2", "-shared", "-Xcompiler", "-fPIC")
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError(f"neither nvcc nor cc was found: {SOURCE} cannot be built")
    return (cc, *CC_FLAGS)


def library_path(compiler: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(compiler[1:]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"host_decode-{h.hexdigest()[:12]}.so")


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
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        IP = ctypes.POINTER(ctypes.c_int)
        lib.pasta_jpeg_info.argtypes = [P, S, IP, IP, IP, ctypes.c_char_p, I]
        lib.pasta_jpeg_decode.argtypes = [P, S, P, ctypes.c_char_p, I]
        lib.pasta_png_unfilter.argtypes = [P, I, I, I, P, ctypes.c_char_p, I]
        for fn in (lib.pasta_jpeg_info, lib.pasta_jpeg_decode, lib.pasta_png_unfilter):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(rc: int, err, path: str) -> None:
    if rc != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")


# ------------------------------------------------------------------- JPEG


def _decode_jpeg(data: bytes, path: str) -> Tuple[np.ndarray, str]:
    lib = _library()
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.pasta_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERRLEN),
           err, path)
    out = np.empty((h.value, w.value, c.value) if c.value == 3 else (h.value, w.value), np.uint8)
    _check(lib.pasta_jpeg_decode(data, len(data), out.ctypes.data, err, _ERRLEN), err, path)
    return out, "RGB" if c.value == 3 else "L"


# ------------------------------------------------------------------- PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _decode_png(data: bytes, path: str) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(array as np.asarray(PIL.Image.open) gives it, PIL mode, palette [n, 3] or None)."""
    pos, ihdr, idat, palette = 8, None, [], None
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos : pos + 4], "big")
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise ValueError(f"{path}: not a complete PNG file (IHDR or IDAT missing)")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    depth, ctype, interlace = ihdr[8], ihdr[9], ihdr[12]
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not defined")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)) and not (ctype == 0 and depth == 1):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _PNG_CHANNELS[ctype]
    rowbytes = (w * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data is shorter than {h} rows of {rowbytes} bytes")
    rows = np.empty((h, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(_library().pasta_png_unfilter(raw, h, rowbytes, max(1, channels * depth // 8), rows.ctypes.data,
                                         err, _ERRLEN), err, path)
    if depth < 8:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # most significant first
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, rowbytes * per_byte)[:, :w]
        if ctype == 0:  # 1-bit grey: PIL's mode "1"
            return px.astype(bool), "1", None
        return np.ascontiguousarray(px), "P", palette
    arr = rows.reshape(h, w, channels) if channels > 1 else rows.reshape(h, w)
    return arr, _PNG_MODES[ctype], palette if ctype == 3 else None


# ------------------------------------------------------------------- API


def decode(path: str) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(array, PIL mode, palette or None) of a JPEG or PNG file; the array is
    what `np.asarray(PIL.Image.open(path))` gives."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        arr, mode = _decode_jpeg(data, path)
        return arr, mode, None
    if data[:8] == _PNG_SIG:
        return _decode_png(data, path)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def read_image(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path))`."""
    return decode(path)[0]


def write_png(img: np.ndarray, path: str) -> None:
    """Write a uint8 array, grey [H, W] or RGB [H, W, 3], as a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    color_type = 0 if img.ndim == 2 else 2
    png = (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _l_weights(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def to_rgb(arr: np.ndarray, mode: str, palette: Optional[np.ndarray] = None) -> np.ndarray:
    """`.convert("RGB")` of a decoded image."""
    if mode == "RGB":
        return arr
    if mode == "RGBA":
        return np.ascontiguousarray(arr[..., :3])
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette
        return pal[arr]
    grey = {"L": lambda: arr, "LA": lambda: arr[..., 0], "1": lambda: arr.astype(np.uint8) * 255}[mode]()
    return np.repeat(grey[..., None], 3, axis=-1)


def to_l(arr: np.ndarray, mode: str, palette: Optional[np.ndarray] = None) -> np.ndarray:
    """`.convert("L")` of a decoded image."""
    if mode == "L":
        return arr
    if mode == "LA":
        return np.ascontiguousarray(arr[..., 0])
    if mode == "1":
        return arr.astype(np.uint8) * 255
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette
        return _l_weights(pal)[arr]
    return _l_weights(arr[..., :3])  # RGB, RGBA


def read_rgb(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("RGB"))`."""
    return to_rgb(*decode(path))


# Pillow's 8-bit resampling (libImaging/Resample.c): double-precision filter
# weights normalised per output pixel, rounded to 22-bit fixed point.
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Resample.c's truncated sinc, `sinc(x) * sinc(x / 3)` on [-3, 3)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# filter name -> (filter, support), as Resample.c's `filter` structs
FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=32)
def _resample_coeffs(in_size: int, out_size: int, filt, support: float):
    """Resample.c `precompute_coeffs` + `normalize_coeffs_8bpc` for `filt` of
    `support` over the whole input: (xmin [out], weights [out, k] int64),
    cached (a folder's images share their sizes; callers do not write them)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0 else int(0.5 + w * (1 << _PRECISION_BITS))
        bounds[xx] = xmin
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, filter: str) -> np.ndarray:
    """One 8-bit pass along `axis` (1: horizontal, 0: vertical) of an [H, W]
    or [H, W, C] image, each channel with the same weights."""
    bounds, kk = _resample_coeffs(img.shape[axis], out_size, *FILTERS[filter])
    src = np.moveaxis(img, axis, 0).astype(np.int32)  # Resample.c accumulates in 32-bit ints
    idx = np.minimum(bounds[:, None] + np.arange(kk.shape[1]), img.shape[axis] - 1)  # weights past xmax are 0
    w = kk.astype(np.int32).reshape(kk.shape + (1,) * (src.ndim - 1))
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * w[:, j]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, size: Tuple[int, int], filter: str = "bicubic") -> np.ndarray:
    """`Image.resize(size, filter)` of an L [H, W] or RGB [H, W, 3] uint8
    image: the horizontal pass only when the width changes, the vertical
    only when the height does, a copy when neither."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1, filter)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0, filter)
    return out.copy() if out is img else out


def resize_l(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.resize(size)` of an L image [H, W] uint8 (Pillow's default BICUBIC)."""
    return resize(img, size, "bicubic")


def read_l_resized(path: str, size: Tuple[int, int]) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("L").resize(size))`."""
    return resize_l(to_l(*decode(path)), size)
