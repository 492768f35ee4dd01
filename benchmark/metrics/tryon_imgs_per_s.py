"""uint8 try-on images handed to the host over the whole window, per second."""

from benchmark.harness.metric_math import units_per_s


def read(record):
    if record.traffic.get("kind") != "serve" or not record.requests:
        return None
    return units_per_s(record)
