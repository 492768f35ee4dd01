"""95th percentile of every window batch's time, from handing its host
samples to routing until its uint8 images are on the host, in ms."""

from benchmark.harness.metric_math import percentile


def read(record):
    if record.traffic.get("kind") != "serve" or not record.requests:
        return None
    return percentile([1e3 * (b - a) for a, b in record.requests], 95)
