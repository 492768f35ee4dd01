"""Image grids of the training snapshots (counterpart of `pasta_gan_tpu/utils/__init__.py:
save_image_grid`, `parsing_to_rgb` and its palette), written without PIL."""

from __future__ import annotations

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
