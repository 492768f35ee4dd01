"""Mean ms a batch of the traced run spends in collate + routing, ended by a synchronise."""

from benchmark.harness.metric_math import mean_ms


def read(record):
    return mean_ms(record, "routing")
