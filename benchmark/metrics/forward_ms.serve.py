"""Mean ms a batch of the traced run spends in the generator forward and the
uint8 copy to the host (from the routing's synchronise)."""

from benchmark.harness.metric_math import mean_ms


def read(record):
    return mean_ms(record, "forward")
