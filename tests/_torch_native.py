"""The JAX package's native host library, loaded, for the port's tests.

`pasta_gan_tpu.native._build` compiles `host_ops.cpp` with `g++ -o` straight
onto its cached path, which is not atomic.  Under pytest-xdist another worker
can `ctypes.CDLL` that path while g++ is still writing it; the load fails,
`_build_failed` is set for the rest of that worker's life, and from then on
`warp_perspective` and `fill_polygon` quietly run the JAX package's float32
`jnp` warp and numpy polygon fill.  A port test held to the JAX default
branch would then be held to another function.

`jax_native()` returns the module with its library loaded, never the
fallback.  It takes an `fcntl` lock on a file beside the build, so that the
port's tests build it one at a time; if the build gives None while a `.so`
sits on the cached path, a worker outside the lock was writing it, so it
waits (up to `WAIT_S`) until that file loads, resets the module's
`_build_failed` and `_lib` and builds again.  Only runtime state of this
process changes.  Every port test that compares against
`pasta_gan_tpu.native`, or against a JAX function that reaches it (the
masks' polygon fill and dilation, the host router's warp), calls it first.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import time

import pytest

from pasta_gan_tpu import native

WAIT_S = 120.0


def so_path() -> str:
    """The cached path `native._build` compiles to and loads from."""
    with open(native._SRC, "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()[:12]
    return os.path.join(native._HERE, f"host_ops-{digest}.so")


def _wait_until_loadable(path: str, deadline: float) -> bool:
    while True:
        try:
            ctypes.CDLL(path)
            return True
        except OSError:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.2)


def jax_native():
    """`pasta_gan_tpu.native` with its library loaded; raises AssertionError if it cannot be."""
    if native._lib is not None:
        return native
    path = so_path()
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if native._build() is None and os.path.exists(path):
                loadable = _wait_until_loadable(path, time.monotonic() + WAIT_S)
                assert loadable, f"{path} did not load within {WAIT_S:.0f} s"
                native._build_failed = False
                native._lib = None
                native._build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert native.available(), (
        f"the JAX package's native host library ({path}) is not loaded: its in-place g++ build races "
        "other test workers, and without it pasta_gan_tpu.native falls back to other functions, so the "
        "port has no oracle")
    return native


@pytest.fixture(scope="module", autouse=True)
def jax_native_oracle():
    """Autouse in the modules that import it: the native library, loaded before their first test."""
    return jax_native()
