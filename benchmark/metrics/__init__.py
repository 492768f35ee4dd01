"""One reader per metric of `BENCHMARK.json`, found by the metric's name:
`read(record)` returns the value, or None where the run has nothing to read."""
