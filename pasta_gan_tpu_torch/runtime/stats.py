"""Training statistics and the `stats.jsonl` writer (counterpart of
`pasta_gan_tpu/runtime/stats.py`, a copy: the port imports nothing of the
JAX package).

`Collector` accumulates three moments [n, sum(x), sum(x^2)] per name on the
host; `update()` snapshots them for the tick and starts the next one.
`JsonlLogger.write` appends one row per tick in the reference's format:
{name: {num, mean, std}} for every collected name, `timestamp`, and the
caller's flat extras (`Progress/*`, `Timing/*`).
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict

import numpy as np


class Collector:
    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}  # name -> [n, sum, sum_sq]
        self._cache: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        if not self._regex.fullmatch(name):
            return
        v = np.asarray(value, np.float64).reshape(-1)
        m = self._moments.setdefault(name, np.zeros(3))
        m += [v.size, v.sum(), np.square(v).sum()]

    def report_dict(self, stats: Dict[str, object]) -> None:
        for k, v in stats.items():
            self.report(k, np.asarray(v))

    def update(self) -> None:
        """Snapshot the current moments and reset them."""
        self._cache = {k: m.copy() for k, m in self._moments.items()}
        self._moments.clear()

    def names(self):
        return list(self._cache)

    def mean(self, name: str) -> float:
        m = self._cache.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._cache.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean**2, 0.0)
        return float(np.sqrt(var))

    def __getitem__(self, name: str) -> float:
        return self.mean(name)

    def as_dict(self) -> dict:
        """The stats.jsonl row format: {name: {num, mean, std}}."""
        return {
            name: dict(num=int(m[0]), mean=self.mean(name), std=self.std(name))
            for name, m in self._cache.items()
        }


class JsonlLogger:
    """Appends one stats.jsonl row per tick."""

    def __init__(self, path: str):
        self._f = open(path, "at")

    def write(self, collector: Collector, **extra) -> None:
        row = dict(collector.as_dict(), timestamp=time.time(), **extra)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
