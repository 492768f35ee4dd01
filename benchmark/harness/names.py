"""Resolving "module:attribute" names of a configuration file against the
program (`pasta_gan_tpu_torch`) or the reference (`benchmark.reference`)."""

from __future__ import annotations

import importlib

PROGRAM = "pasta_gan_tpu_torch"
REFERENCE = "benchmark.reference"


def resolve(package: str, name: str):
    module, attr = name.split(":")
    return getattr(importlib.import_module(f"{package}.{module}"), attr)
