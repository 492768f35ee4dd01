"""Image grids of the training snapshots (counterpart of `pasta_gan_tpu/utils/__init__.py:
save_image_grid`, `parsing_to_rgb` and its palette), written without PIL, and
`open_url`, the reference's cached downloader (a copy of the JAX package's)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.image_io import write_png


def save_image_grid(images, path: str, drange=(-1, 1), grid_cols: Optional[int] = None) -> str:
    """Tile [N, H, W, C] images (C = 1 or 3, values in `drange`) row by row
    into one 8-bit PNG, `grid_cols` wide (default ceil(sqrt(N))); empty
    cells stay black."""
    lo, hi = drange
    imgs = (np.asarray(images, np.float32) - lo) / (hi - lo) * 255.0
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    N, H, W, C = imgs.shape
    cols = grid_cols or int(np.ceil(np.sqrt(N)))
    rows = int(np.ceil(N / cols))
    grid = np.zeros((rows * H, cols * W, C), np.uint8)
    for i in range(N):
        r, c = divmod(i, cols)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = imgs[i]
    write_png(grid[..., 0] if C == 1 else grid, path)
    return path


# LIP/CIHP human-parsing palette (the reference's `util_functions.py` label_colors)
PARSING_LABEL_COLORS = (
    (0, 0, 0), (128, 0, 0), (255, 0, 0), (0, 85, 0), (170, 0, 51),
    (255, 85, 0), (0, 0, 85), (0, 119, 221), (85, 85, 0), (0, 85, 85),
    (85, 51, 0), (52, 86, 128), (0, 128, 0), (0, 0, 255), (51, 170, 221),
    (0, 255, 255), (85, 255, 170), (170, 255, 85), (255, 255, 0), (255, 170, 0),
)


def parsing_to_rgb(parsing) -> np.ndarray:
    """Class indices [H, W] / [N, H, W] (or [..., 1]), or logits [..., H, W, K]
    (argmax over K), -> float32 RGB in [0, 1] through the label palette."""
    x = np.asarray(parsing)
    if x.dtype.kind not in "iu":
        x = x.astype(np.float32)
    if x.ndim >= 3 and x.shape[-1] > 1 and np.issubdtype(x.dtype, np.floating):
        x = np.argmax(x, axis=-1)
    elif x.ndim >= 3 and x.shape[-1] == 1:
        x = x[..., 0]
    x = x.astype(np.int64) % len(PARSING_LABEL_COLORS)
    palette = np.asarray(PARSING_LABEL_COLORS, np.float32) / 255.0
    return palette[x]


def _default_fetch(url: str):
    """One GET returning (content bytes, headers dict); split out so that the
    download logic is testable with an injected fetch."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as res:
        return res.read(), {k.title(): v for k, v in res.headers.items()}


def open_url(url_or_path: str, cache_dir: Optional[str] = None, num_attempts: int = 10, verbose: bool = True,
             return_filename: bool = False, cache: bool = True, _fetch=None):
    """The reference's `dnnlib.util.open_url` (`dnnlib/util.py:382-477`), as
    the JAX package has it: local paths and `file://` URLs open directly; a
    URL is looked up in the md5-keyed cache (`<md5(url)>_<name>` under
    `cache_dir`, default `~/.cache/pasta_gan_tpu`, the JAX package's, so a
    file placed there once serves both packages) and otherwise downloaded
    through `_fetch(url) -> (bytes, headers)` with retries, Google Drive's
    virus-check nag and quota page, Content-Disposition naming and an atomic
    write into the cache.  Returns an open binary file, or with
    `return_filename` its path."""
    import hashlib
    import html
    import io
    import re
    import uuid

    assert num_attempts >= 1
    assert not (return_filename and not cache)

    if not re.match(r"^[a-z]+://", url_or_path):
        return url_or_path if return_filename else open(url_or_path, "rb")
    if url_or_path.startswith("file://"):
        import urllib.parse

        filename = urllib.parse.urlparse(url_or_path).path
        if re.match(r"^/[a-zA-Z]:", filename):
            filename = filename[1:]  # windows file:///c:/foo.txt
        return filename if return_filename else open(filename, "rb")

    url = url_or_path
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache", "pasta_gan_tpu")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    if cache and os.path.isdir(cache_dir):
        for fname in sorted(os.listdir(cache_dir)):
            if fname.startswith(url_md5) and not fname.startswith("tmp_"):
                path = os.path.join(cache_dir, fname)
                return path if return_filename else open(path, "rb")

    fetch = _fetch or _default_fetch
    url_name = url_data = None
    for attempts_left in reversed(range(num_attempts)):
        try:
            content, headers = fetch(url)
            if len(content) == 0:
                raise IOError("No data received")
            if len(content) < 8192:
                content_str = content.decode("utf-8", errors="replace")
                if "download_warning" in headers.get("Set-Cookie", ""):
                    # Google Drive's virus-check nag page: follow the real link
                    links = [html.unescape(link) for link in content_str.split('"') if "export=download" in link]
                    if len(links) == 1:
                        import urllib.parse

                        url = urllib.parse.urljoin(url, links[0])
                        raise IOError("Google Drive virus checker nag")
                if "Google Drive - Quota exceeded" in content_str:
                    raise IOError("Google Drive download quota exceeded -- please try again later")
            match = re.search(r'filename="([^"]*)"', headers.get("Content-Disposition", ""))
            url_name = match[1] if match else url
            url_data = content
            break
        except KeyboardInterrupt:
            raise
        except Exception:
            if not attempts_left:
                raise

    if cache:
        safe_name = re.sub(r"[^0-9a-zA-Z-._]", "_", url_name)
        cache_file = os.path.join(cache_dir, url_md5 + "_" + safe_name)
        temp_file = os.path.join(cache_dir, "tmp_" + uuid.uuid4().hex + "_" + url_md5 + "_" + safe_name)
        os.makedirs(cache_dir, exist_ok=True)
        with open(temp_file, "wb") as f:
            f.write(url_data)
        os.replace(temp_file, cache_file)  # atomic
        if return_filename:
            return cache_file
    return io.BytesIO(url_data)
