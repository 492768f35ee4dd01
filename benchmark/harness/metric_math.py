"""Arithmetic the metric readers share: rates over the window, percentiles,
the kernels' roofline share and the whole step's share of the peak."""

from __future__ import annotations

import math
import os
import re
import sys
import importlib.util

from .env import BENCH_DIR

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet), at 700 W


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def units_per_s(record) -> float:
    """Units (images) of every request completed in the window over the window's seconds."""
    done = len(record.requests) - record.failed
    return done * record.units_per_request / record.window_s


def roofline_cost(kernel: str):
    """The `roofline/<kernel>.py` module, or None where the kernel has none."""
    path = os.path.join(BENCH_DIR, "roofline", f"{kernel}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"benchmark.roofline.{kernel}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_roofline(record):
    """Σ least time ÷ Σ device time, in %, over the hand-written kernels that
    ran in the traced segment and have a count under `roofline/`."""
    from ..roofline import PEAK_BYTES

    if record.trace is None or not record.launches:
        return None
    least, names = 0.0, {}
    for kernel, args in record.launches:
        mod = names.setdefault(kernel, roofline_cost(kernel))
        if mod is None:
            continue
        ops, nbytes = mod.cost(args)
        least += max(nbytes / PEAK_BYTES, ops / mod.PEAK_OPS)
    missing = sorted(k for k, m in names.items() if m is None)
    if missing:
        print(f"benchmark: no roofline count for {missing}; left out of kernel_roofline", file=sys.stderr)
    device = sum(s for name, s in record.trace.device_ops.items()
                 if any(m is not None and re.search(m.DEVICE_NAMES, name) for m in names.values()))
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def mfu(record):
    """The configuration's FLOPs per unit × units per second of the window, over the bf16 peak, in %."""
    if record.flops_per_unit is None or not record.requests or record.window_s <= 0:
        return None
    return 100.0 * record.flops_per_unit * units_per_s(record) / PEAK_BF16


def idle_share(record):
    if record.trace is None or record.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)


def mean_ms(record, span: str):
    v = record.spans.get(span)
    return 1e3 * sum(v) / len(v) if v else None
