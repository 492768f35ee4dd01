"""Tiny cells for the CPU tests: a cell of BENCHMARK.json at thin widths,
small batches and a small pool, run on the CPU by calling its runner
directly (the harness's own entry point refuses the CPU)."""

from __future__ import annotations

import time

import torch

from benchmark.harness import env
from benchmark.run import load_json, load_spec

THIN = {"serve_full256_b16": dict(channel_base=512, channel_max=32),
        "serve_full512_b8": dict(channel_base=1024, channel_max=16)}


def tiny_spec(workload: str, seed: int = 7, seconds: float = 0.5, **traffic):
    spec = load_spec(load_json(env.ROOT, "BENCHMARK.json"), workload, seed, seconds, False)
    spec.config["model"]["kwargs"].update(THIN[workload])
    spec.traffic.update(dict(batch=2, pool=5, warmup_batches=1, check_batches=2), **traffic)
    return spec


def run_tiny(spec, **kw):
    from importlib import import_module

    kind = import_module(f"benchmark.kinds.{spec.traffic['kind']}")
    torch.manual_seed(0)
    return kind.run(spec, torch.device("cpu"), time.time(), **kw)
