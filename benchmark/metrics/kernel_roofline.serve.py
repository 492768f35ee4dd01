"""The hand-written kernels' share of their roofline in the traced serving segment, %."""

from benchmark.harness.metric_math import kernel_roofline


def read(record):
    return kernel_roofline(record) if record.traffic.get("kind") == "serve" else None
