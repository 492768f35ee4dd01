"""Share of the traced serving segment in which no kernel ran on the card, %."""

from benchmark.harness.metric_math import idle_share


def read(record):
    return idle_share(record) if record.traffic.get("kind") == "serve" else None
