"""The ADA step checks of tests/test_torch_train_ada.py with the D calls one
by one and the exact warp (`ada.stack_calls` off, `ada.fast_geom` off): Gmain
and Dmain gradients, `train_step` and `d_r1_step` against the JAX package's
`GANTrainer` at the same tolerances.  A file of its own so that the test
workers run the two modes side by side.
"""

import pytest

from test_torch_train_ada import make_ada_pair
from test_torch_train_ada import test_ada_gmain_and_dmain_gradients_match_jax as _grads
from test_torch_train_ada import test_ada_train_step_and_r1_step_match_jax as _steps
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def ada_pair():
    return make_ada_pair("one_by_one")


def test_ada_one_by_one_gmain_and_dmain_gradients_match_jax(ada_pair):
    _grads(ada_pair)


def test_ada_one_by_one_train_step_and_r1_step_match_jax(ada_pair):
    _steps(ada_pair)
