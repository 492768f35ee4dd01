"""`tests/_torch_native.py:jax_native` gives the port's tests the JAX
package's native library even after a load in this process failed, which
is what a concurrent in-place g++ build of the library does to an xdist
worker: `native._build_failed` stays set and every entry point quietly
runs its fallback."""

import numpy as np

from pasta_gan_tpu import native

from _torch_native import jax_native, so_path


def test_jax_native_restores_the_library_after_a_failed_load():
    saved = native._build_failed, native._lib
    try:
        native._build_failed, native._lib = True, None
        assert not native.available()  # the quiet fallback
        assert jax_native() is native
        assert native._lib is not None and not native._build_failed
        assert native._lib._name == so_path()
        # the library's fill, not the numpy fallback's: a unit square's pixel centres
        square = np.array([[1.0, 1.0], [3.0, 1.0], [3.0, 3.0], [1.0, 3.0]])
        assert native.fill_polygon(square, 5, 5).dtype == np.float32
    finally:
        native._build_failed, native._lib = saved
