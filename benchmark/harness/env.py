"""Process environment of a run: cache directories, the card check, the clock
since process start, and the guard against JAX in the process."""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the checkout
BENCH_DIR = os.path.join(ROOT, "benchmark")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")  # fixed, inside the checkout (gitignored)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pasta_gan_tpu")


def process_start_time() -> float:
    """time.time() at which this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat, counted after the command name
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout, at fixed
    paths, before torch is imported; `transformers` kept from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE_DIR, "nv_compute")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int):
    """The device of a run on `n` cards; exits (code 2, no result) without them."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false; the benchmark measures only on the card")
    if torch.cuda.device_count() < n:
        fail(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    """Modules whose top-level name (before the first dot) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_info() -> dict:
    """The card's name and power limit as `nvidia-smi` reads them ({} where it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
        name, limit = out[0].split(",")
        return {"name": name.strip(), "power_limit": limit.strip()}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return {}
