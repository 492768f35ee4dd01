"""Feature statistics accumulator (a copy of `pasta_gan_tpu/metrics/feature_stats.py`;
reference `metrics/metric_utils.py:55-131`).

`FeatureStats` accumulates either raw features (`capture_all`) or running
float64 mean/covariance (`capture_mean_cov`) up to `max_items`, on the host.
The md5-keyed dataset stats cache keys on the extractor's tag, and every
extractor of this package has a tag of its own (`inception-torch-v1`, ...), so
the two packages never read each other's cached stats.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

import numpy as np


class FeatureStats:
    def __init__(self, capture_all=False, capture_mean_cov=False, max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros([num_features], np.float64)
        self.raw_cov = np.zeros([num_features, num_features], np.float64)

    def is_full(self) -> bool:
        return (self.max_items is not None) and (self.num_items >= self.max_items)

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if (self.max_items is not None) and (self.num_items + x.shape[0] > self.max_items):
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]

        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, pkl_file: str):
        with open(pkl_file, "wb") as f:
            pickle.dump(self.__dict__, f)

    @staticmethod
    def load(pkl_file: str) -> "FeatureStats":
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = FeatureStats(capture_all=s["capture_all"], max_items=s["max_items"])
        obj.__dict__.update(s)
        return obj


def stats_cache_path(cache_dir: str, dataset_tag: str, extractor_tag: str, **kwargs) -> str:
    """md5-keyed stats cache file (reference metric_utils.py:186-203)."""
    args = dict(dataset_tag=dataset_tag, extractor_tag=extractor_tag, **kwargs)
    md5 = hashlib.md5(repr(sorted(args.items())).encode("utf-8")).hexdigest()
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{dataset_tag}-{extractor_tag}-{md5}.pkl")
