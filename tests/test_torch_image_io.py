"""The port's image decoding (`pasta_gan_tpu_torch/data/image_io.py` and its C
library `csrc/host_decode.c`) against PIL, bit for bit, on the CPU.

* JPEG: 4:4:4, 4:2:2 and 4:2:0 at qualities 75 and 95, sizes that are not a
  multiple of the MCU (down to 1x1, where the chroma is replicated rather
  than triangle-filtered), optimized Huffman tables (codes longer than the
  decoder's 9-bit lookahead), restart intervals, grey; random sizes,
  subsamplings and qualities through hypothesis.  Every file is written by
  PIL into tmp_path and PIL is the oracle.
* PNG: every colour type the decoder supports (8-bit grey, grey+alpha, RGB,
  RGBA; palette at 1, 2, 4 and 8 bits, read as indices; 1-bit grey, PIL's
  mode "1"), each with rows in all five filter types, written by this test's
  own encoder so that the filter of each row is known.
* `convert("RGB")`, `convert("L")` and the default (bicubic) `resize` of L
  images to larger, smaller and equal sizes; the LANCZOS `resize` of RGB
  images (`calc_metrics --resolution`), up and down, square and not.
* What the decoder refuses raises ValueError naming the file: progressive,
  lossless, arithmetic-coded, 12-bit and CMYK JPEG; 16-bit, interlaced and
  2-bit grey PNG.
"""

import os
import struct
import zlib

import numpy as np
import PIL.Image
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pasta_gan_tpu_torch.data import image_io


def _texture(rng, h, w):
    """Smooth stripes, a flat block with sharp edges and a little noise."""
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 13.0), 128 + 90 * np.cos(yy / 5.0), (xx * 3 + yy * 2) % 256], -1)
    img[h // 3 : h // 2, w // 4 : w // 2] = (200, 30, 60)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _same_as_pil(path, mode_too=True):
    im = PIL.Image.open(path)
    ref = np.asarray(im)
    arr, mode, _ = image_io.decode(path)
    assert arr.shape == ref.shape and arr.dtype == ref.dtype, (arr.shape, ref.shape, arr.dtype, ref.dtype)
    np.testing.assert_array_equal(arr, ref)
    if mode_too:
        assert mode == im.mode
    np.testing.assert_array_equal(image_io.read_rgb(path), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("hw", [(256, 192), (61, 45), (17, 23), (8, 8), (9, 3), (33, 1), (1, 40), (1, 1)])
def test_jpeg_matches_pil(tmp_path, subsampling, quality, hw):
    path = str(tmp_path / "a.jpg")
    PIL.Image.fromarray(_texture(np.random.default_rng(sum(hw)), *hw)).save(path, quality=quality,
                                                                           subsampling=subsampling)
    _same_as_pil(path)


@pytest.mark.parametrize("opts", [dict(optimize=True), dict(restart_marker_blocks=1), dict(restart_marker_blocks=5),
                                  dict(restart_marker_rows=1), dict(restart_marker_rows=2)],
                         ids=["optimized", "rst_blocks1", "rst_blocks5", "rst_rows1", "rst_rows2"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_jpeg_huffman_and_restart_intervals_match_pil(tmp_path, opts, subsampling):
    path = str(tmp_path / "a.jpg")
    PIL.Image.fromarray(_texture(np.random.default_rng(1), 77, 53)).save(path, quality=90, subsampling=subsampling,
                                                                         **opts)
    if "optimize" not in opts:
        assert b"\xff\xdd" in open(path, "rb").read()  # a DRI segment
    _same_as_pil(path)


@pytest.mark.parametrize("hw", [(256, 192), (13, 29), (1, 1)])
def test_grey_jpeg_matches_pil(tmp_path, hw):
    path = str(tmp_path / "g.jpg")
    PIL.Image.fromarray(_texture(np.random.default_rng(2), *hw)[..., 0]).save(path, quality=85)
    _same_as_pil(path)
    assert image_io.read_rgb(path).shape == hw + (3,)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), subsampling=st.sampled_from([0, 1, 2]),
       quality=st.integers(30, 100), seed=st.integers(0, 2**16))
def test_jpeg_random_sizes_match_pil(tmp_path_factory, h, w, subsampling, quality, seed):
    path = str(tmp_path_factory.mktemp("jpeg") / "r.jpg")
    PIL.Image.fromarray(_texture(np.random.default_rng(seed), h, w)).save(path, quality=quality,
                                                                         subsampling=subsampling)
    _same_as_pil(path)


# ------------------------------------------------------------------ PNG

def _png(path, rows, w, h, depth, ctype, palette=None, interlace=0, filters=(0, 1, 2, 3, 4)):
    """Write a PNG whose row y uses filter filters[y % len(filters)]; `rows`
    is [h, rowbytes] uint8 of raw (unfiltered) scanlines."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    raw, prev = b"", np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            pred = [np.zeros_like(cur), a, prev, (a + prev) >> 1][f]
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _pack(px, depth):
    """[h, w] values of `depth` bits -> [h, rowbytes] bytes, most significant first."""
    h, w = px.shape
    per = 8 // depth
    pad = np.zeros((h, (-w) % per), np.uint8)
    px = np.concatenate([px.astype(np.uint8), pad], 1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (px << shifts).sum(-1).astype(np.uint8)


PNG_CASES = [("L", 0, 8), ("RGB", 2, 8), ("LA", 4, 8), ("RGBA", 6, 8), ("1", 0, 1),
             ("P1", 3, 1), ("P2", 3, 2), ("P4", 3, 4), ("P8", 3, 8)]


@pytest.mark.parametrize("name,ctype,depth", PNG_CASES, ids=[c[0] for c in PNG_CASES])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_png_matches_pil(tmp_path, name, ctype, depth, filters):
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 23, 37
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = None
    if depth < 8:
        rows = _pack(rng.integers(0, 1 << depth, (h, w)), depth)
        if ctype == 3:
            palette = rng.integers(0, 256, (1 << depth, 3))
    else:
        img = _texture(rng, h, w)
        px = np.concatenate([img, img[..., :1] // 2], -1)[..., :channels]
        rows = px.reshape(h, w * channels)
        if ctype == 3:
            palette = rng.integers(0, 256, (256, 3))
    path = str(tmp_path / "a.png")
    _png(path, rows, w, h, depth, ctype, palette, filters=filters)
    _same_as_pil(path)


def test_png_written_by_pil_matches_pil(tmp_path):
    rng = np.random.default_rng(3)
    img = _texture(rng, 31, 29)
    for i, im in enumerate([PIL.Image.fromarray(img), PIL.Image.fromarray(img[..., 0]),
                            PIL.Image.fromarray(img).convert("LA"), PIL.Image.fromarray(img).convert("RGBA"),
                            PIL.Image.fromarray(img[..., 0] > 128), PIL.Image.fromarray(img).convert("P")]):
        for optimize in (False, True):
            path = str(tmp_path / f"{i}{optimize}.png")
            im.save(path, optimize=optimize)
            _same_as_pil(path)


# ------------------------------------------------------------------ convert("L") and resize

L_SIZES = [(256, 256), (45, 61), (30, 20), (100, 61), (7, 200), (29, 31)]


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "1", "P", "grey_jpeg", "rgb_jpeg"])
def test_convert_l_and_resize_match_pil(tmp_path, mode):
    img = _texture(np.random.default_rng(4), 31, 29)
    path = str(tmp_path / ("a.jpg" if mode.endswith("jpeg") else "a.png"))
    im = {"RGB": lambda: PIL.Image.fromarray(img), "L": lambda: PIL.Image.fromarray(img[..., 1]),
          "LA": lambda: PIL.Image.fromarray(img).convert("LA"), "RGBA": lambda: PIL.Image.fromarray(img).convert("RGBA"),
          "1": lambda: PIL.Image.fromarray(img[..., 2] > 100), "P": lambda: PIL.Image.fromarray(img).convert("P"),
          "grey_jpeg": lambda: PIL.Image.fromarray(img[..., 0]), "rgb_jpeg": lambda: PIL.Image.fromarray(img)}[mode]()
    im.save(path)
    ref = PIL.Image.open(path).convert("L")
    np.testing.assert_array_equal(image_io.to_l(*image_io.decode(path)), np.asarray(ref))
    for size in L_SIZES:
        np.testing.assert_array_equal(image_io.read_l_resized(path, size), np.asarray(ref.resize(size)),
                                      err_msg=str(size))


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 300), ow=st.integers(1, 300),
       seed=st.integers(0, 2**16))
def test_resize_random_sizes_match_pil(h, w, oh, ow, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.resize_l(img, (ow, oh)),
                                  np.asarray(PIL.Image.fromarray(img).resize((ow, oh))))


@pytest.mark.parametrize("hw,size", [((256, 192), (256, 256)), ((256, 192), (128, 96)), ((64, 64), (299, 299)),
                                     ((300, 200), (224, 224)), ((37, 53), (53, 37)), ((40, 40), (40, 17)),
                                     ((9, 31), (9, 31))],
                         ids=["pad_width", "half", "square_up", "down", "transpose", "height_only", "same"])
def test_lanczos_rgb_resize_matches_pil(tmp_path, hw, size):
    """`calc_metrics --resolution`'s resize: RGB, up and down, square and not,
    through the same coefficient code as the bicubic L resize."""
    img = _texture(np.random.default_rng(sum(hw)), *hw)
    path = str(tmp_path / "a.png")
    PIL.Image.fromarray(img).save(path)
    ref = np.asarray(PIL.Image.open(path).convert("RGB").resize(size, PIL.Image.LANCZOS))
    got = image_io.resize(image_io.read_rgb(path), size, "lanczos")
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 60), w=st.integers(1, 60), oh=st.integers(1, 90), ow=st.integers(1, 90),
       seed=st.integers(0, 2**16))
def test_lanczos_random_sizes_match_pil(h, w, oh, ow, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.resize(img, (ow, oh), "lanczos"),
                                  np.asarray(PIL.Image.fromarray(img).resize((ow, oh), PIL.Image.LANCZOS)))


def test_resize_filters_share_one_coefficient_path():
    for name, (filt, support) in image_io.FILTERS.items():
        bounds, kk = image_io._resample_coeffs(10, 4, filt, support)
        assert kk.shape == (4, int(np.ceil(support * 2.5)) * 2 + 1), name
        # every row's fixed-point weights sum to one within the rounding of each weight
        assert np.all(np.abs(kk.sum(1) - (1 << image_io._PRECISION_BITS)) <= kk.shape[1]), name


# ------------------------------------------------------------------ refusals


def _patched_jpeg(tmp_path, name, old, new):
    path = str(tmp_path / name)
    PIL.Image.fromarray(_texture(np.random.default_rng(5), 16, 16)).save(path, quality=90)
    data = open(path, "rb").read()
    assert old in data
    with open(path, "wb") as f:
        f.write(data.replace(old, new, 1))
    return path


def test_refused_jpeg_raises_naming_the_file(tmp_path):
    img = _texture(np.random.default_rng(6), 16, 16)
    prog = str(tmp_path / "prog.jpg")
    PIL.Image.fromarray(img).save(prog, progressive=True)
    cmyk = str(tmp_path / "cmyk.jpg")
    PIL.Image.fromarray(img).convert("CMYK").save(cmyk)
    cases = [(prog, "SOF2"), (cmyk, "4 components"),
             (_patched_jpeg(tmp_path, "lossless.jpg", b"\xff\xc0\x00\x11\x08", b"\xff\xc3\x00\x11\x08"), "SOF3"),
             (_patched_jpeg(tmp_path, "arith.jpg", b"\xff\xc0\x00\x11\x08", b"\xff\xc9\x00\x11\x08"), "SOF9"),
             (_patched_jpeg(tmp_path, "12bit.jpg", b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c"), "12-bit")]
    for path, what in cases:
        with pytest.raises(ValueError, match=what) as e:
            image_io.read_rgb(path)
        assert path in str(e.value)


def test_refused_png_raises_naming_the_file(tmp_path):
    rng = np.random.default_rng(7)
    sixteen = str(tmp_path / "16.png")
    PIL.Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)).save(sixteen)
    interlaced = str(tmp_path / "adam7.png")
    _png(interlaced, rng.integers(0, 256, (8, 8)).astype(np.uint8), 8, 8, 8, 0, interlace=1)
    grey2 = str(tmp_path / "grey2.png")
    _png(grey2, _pack(rng.integers(0, 4, (8, 8)), 2), 8, 8, 2, 0)
    for path, what in ((sixteen, "16-bit"), (interlaced, "interlaced"), (grey2, "2 bits")):
        with pytest.raises(ValueError, match=what) as e:
            image_io.read_image(path)
        assert path in str(e.value)
    other = str(tmp_path / "a.gif")
    PIL.Image.fromarray(rng.integers(0, 256, (8, 8)).astype(np.uint8)).save(other)
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        image_io.read_image(other)


def test_library_is_built_under_a_name_that_hashes_source_and_flags():
    compiler = image_io._compiler()
    path = image_io.library_path(compiler)
    image_io._library()
    assert os.path.exists(path) and os.path.dirname(path) == image_io.BUILD_DIR
    assert image_io.library_path(compiler[:1] + ("-O0",) + compiler[2:]) != path
