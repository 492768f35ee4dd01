"""The benchmark of `pasta_gan_tpu_torch` on NVIDIA H100 cards.

`python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of `BENCHMARK.json` once and prints one JSON line.  Every
configuration, traffic mix, per-layer metric, roofline count and check limit
is a file found by name (`configs/`, `traffic/`, `metrics/`, `roofline/`,
`checks/`); `reference/` is the plain PyTorch reference that decides
`correct`.
"""
