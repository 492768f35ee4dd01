"""Framework utilities (counterpart of `pasta_gan_tpu/utils/__init__.py`; the
reference's `dnnlib/util.py` and `torch_utils/misc.py`): `EasyDict`, the
stdout/stderr tee `Logger`, `assert_shape`, `print_module_summary`; the image
grids of the training snapshots (`save_image_grid`, `parsing_to_rgb` and its
palette), written without PIL; and `open_url`, the reference's cached
downloader (a copy of the JAX package's)."""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.image_io import write_png


class EasyDict(dict):
    """Attribute-access dict (reference `dnnlib/util.py:40-52`)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


class Logger:
    """stdout/stderr tee into a log file (reference `dnnlib/util.py:56-112`):
    from construction on, everything written to either stream also goes to
    `file_name`; `close()` restores both streams."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w", should_flush: bool = True):
        self.file = open(file_name, mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write(self, text) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if self.file is not None:
            self.file.close()
            self.file = None
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr


def assert_shape(tensor, ref_shape: Sequence[Optional[int]]) -> None:
    """Inline shape contract (reference `torch_utils/misc.py:86-101`); None
    entries are wildcards."""
    if tensor.ndim != len(ref_shape):
        raise AssertionError(f"wrong rank: got {tensor.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref) in enumerate(zip(tensor.shape, ref_shape)):
        if ref is not None and int(size) != int(ref):
            raise AssertionError(f"wrong size for dim {idx}: got {size}, expected {ref}")


def print_module_summary(module: torch.nn.Module, *inputs, max_nesting: int = 3, skip_redundant: bool = True):
    """The reference's summary table (`torch_utils/misc.py:201-269`): run
    `module(*inputs)` with forward hooks on every submodule and print one row
    per submodule call up to `max_nesting` deep, in the order the calls
    return: its name, the parameters and buffers it holds that no earlier row
    counted, its output's shape and dtype (`name:i` rows for a call's further
    tensor outputs); rows that add nothing are skipped.  Returns the outputs."""
    entries, nesting = [], [0]

    def pre_hook(_mod, _inputs):
        nesting[0] += 1

    def post_hook(mod, _inputs, outputs):
        nesting[0] -= 1
        if nesting[0] <= max_nesting:
            outputs = list(outputs) if isinstance(outputs, (tuple, list)) else [outputs]
            entries.append(EasyDict(mod=mod, outputs=[t for t in outputs if isinstance(t, torch.Tensor)]))

    hooks = [m.register_forward_pre_hook(pre_hook) for m in module.modules()]
    hooks += [m.register_forward_hook(post_hook) for m in module.modules()]
    try:
        outputs = module(*inputs)
    finally:
        for h in hooks:
            h.remove()

    seen = set()
    for e in entries:
        e.params = [t for t in e.mod.parameters() if id(t) not in seen]
        e.buffers = [t for t in e.mod.buffers() if id(t) not in seen]
        e.new_outputs = [t for t in e.outputs if id(t) not in seen]
        seen |= {id(t) for t in e.params + e.buffers + e.new_outputs}
    if skip_redundant:
        entries = [e for e in entries if e.params or e.buffers or e.new_outputs]

    rows = [[type(module).__name__, "Parameters", "Buffers", "Output shape", "Datatype"], ["---"] * 5]
    names = {m: name for name, m in module.named_modules()}
    param_total = buffer_total = 0
    for e in entries:
        name = "<top-level>" if e.mod is module else names[e.mod]
        n_params, n_buffers = sum(t.numel() for t in e.params), sum(t.numel() for t in e.buffers)
        shapes = [str(list(t.shape)) for t in e.outputs]
        dtypes = [str(t.dtype).split(".")[-1] for t in e.outputs]
        rows.append([name + (":0" if len(e.outputs) >= 2 else ""), str(n_params) if n_params else "-",
                     str(n_buffers) if n_buffers else "-", (shapes + ["-"])[0], (dtypes + ["-"])[0]])
        rows += [[f"{name}:{i}", "-", "-", shapes[i], dtypes[i]] for i in range(1, len(e.outputs))]
        param_total += n_params
        buffer_total += n_buffers
    rows += [["---"] * 5, ["Total", str(param_total), str(buffer_total), "-", "-"]]
    widths = [max(len(cell) for cell in col) for col in zip(*rows)]
    print()
    for row in rows:
        print("  ".join(cell + " " * (w - len(cell)) for cell, w in zip(row, widths)))
    print()
    return outputs


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
