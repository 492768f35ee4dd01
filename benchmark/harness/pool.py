"""Synthetic person records drawn from a seed at a cell's own frame.

A copy of the port's `data/dataset.py:SyntheticUvitonDataset._draw` (plausible
keypoints around a base pose, a parsing of simple shapes, an image coloured
by label with noise), generalised from 256x192 to any (H, W) frame: the base
pose and the shapes scale by H / 256 and sit centred across the width.  Each
record is (image [H, W, 3] uint8, keypoints [18, 3] float32, parsing [H, W]
uint8), what `host_sample` takes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BASE_KPS = {
    0: (96, 40), 1: (96, 70), 2: (70, 72), 3: (60, 105), 4: (56, 140),
    5: (122, 72), 6: (132, 105), 7: (136, 140), 8: (78, 140), 9: (74, 190),
    10: (72, 235), 11: (114, 140), 12: (118, 190), 13: (120, 235),
    14: (90, 34), 15: (102, 34), 16: (84, 38), 17: (108, 38),
}


def draw_person(seed: int, idx: int, frame: Tuple[int, int]):
    """Record `idx` of the pool of `seed` at frame (H, W)."""
    H, W = frame
    s = H / 256.0
    ox = (W - 192 * s) / 2.0
    rng = np.random.default_rng([seed, idx])
    kps = np.zeros((18, 3), np.float32)
    for i, (x, y) in BASE_KPS.items():
        kps[i] = (x * s + ox + rng.normal(0, 4 * s), y * s + rng.normal(0, 4 * s), 0.9)
    parsing = np.zeros((H, W), np.uint8)

    def rect(x0, y0, x1, y1, label):
        parsing[max(0, int(y0)): int(y1), max(0, int(x0)): int(x1)] = label

    # head circle (13), torso garment (5), pants (9), arms (14/15), legs (16/17), shoes (18/19)
    cx, cy = int(kps[0][0]), int(kps[0][1])
    yy, xx = np.ogrid[:H, :W]
    parsing[(yy - cy) ** 2 + (xx - cx) ** 2 < (18 * s) ** 2] = 13
    rect(kps[2][0], kps[2][1], kps[5][0], kps[8][1], 5)
    rect(kps[8][0] - 8 * s, kps[8][1], kps[11][0] + 8 * s, kps[9][1] + 20 * s, 9)
    rect(kps[3][0] - 6 * s, kps[3][1] - 10 * s, kps[3][0] + 6 * s, kps[4][1], 15)
    rect(kps[6][0] - 6 * s, kps[6][1] - 10 * s, kps[6][0] + 6 * s, kps[7][1], 14)
    rect(kps[9][0] - 7 * s, kps[9][1] + 20 * s, kps[9][0] + 7 * s, kps[10][1], 16)
    rect(kps[12][0] - 7 * s, kps[12][1] + 20 * s, kps[12][0] + 7 * s, kps[13][1], 17)
    rect(kps[10][0] - 8 * s, kps[10][1], kps[10][0] + 8 * s, H - 1, 18)
    rect(kps[13][0] - 8 * s, kps[13][1], kps[13][0] + 8 * s, H - 1, 19)

    colors = rng.integers(40, 215, (20, 3))
    image = np.full((H, W, 3), 255, np.uint8)
    for label in range(1, 20):
        image[parsing == label] = colors[label % 20]
    image = np.clip(image.astype(np.int32) + rng.integers(-12, 12, image.shape), 0, 255).astype(np.uint8)
    return image, kps, parsing


def draw_pairs(seed: int, pool: int, batch: int, n_batches: int):
    """[n_batches, batch] person and garment indices into a pool of `pool`
    records, person != garment; every seed draws the same sizes."""
    rng = np.random.default_rng([seed, 1])
    persons = rng.integers(0, pool, (n_batches, batch))
    garments = (persons + rng.integers(1, pool, (n_batches, batch))) % pool
    return persons, garments


def _host_record(args):
    seed, idx, frame = args
    from .names import PROGRAM, resolve

    host_sample = resolve(PROGRAM, "data.dataset:host_sample")
    return host_sample(*draw_person(seed, idx, frame), size=frame)


def host_pool(seed: int, n: int, frame: Tuple[int, int], workers: int = 8) -> list:
    """The pool's n records through the program's `host_sample` (set-up work),
    drawn by up to `workers` forked processes, which have all ended on return."""
    import multiprocessing as mp
    import os

    jobs = [(seed, i, tuple(frame)) for i in range(n)]
    workers = max(1, min(workers, os.cpu_count() or 1, n))
    if workers == 1:
        return [_host_record(j) for j in jobs]
    with mp.get_context("fork").Pool(workers) as pool:
        out = pool.map(_host_record, jobs, chunksize=max(1, n // (4 * workers)))
    return out
