"""The generator forward's FLOPs (counted by the reference) at the traced
run's image rate, over the H100's dense bf16 peak, %."""

from benchmark.harness.metric_math import mfu


def read(record):
    return mfu(record) if record.traffic.get("kind") == "serve" else None
