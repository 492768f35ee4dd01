"""The port's 2x FIR resampling (ops/upfirdn_kernels.py) against the JAX package.

* `up2_reference` / `down2_reference` against the JAX package's TPU kernels
  `upsample2x_pallas` / `downsample2x_pallas`, run with `interpret=True` as
  tests/test_pallas.py runs them, and against JAX `upsample2d`,
  `downsample2d` and `conv2d_resample` at the three canonical cases the port
  routes to the kernels (ops/upfirdn2d.py:fir2x_route): fp32, atol 1e-5.
* The adjoint identities that make each kernel the other's gradient, and
  `gradcheck` / `gradgradcheck` of both Functions in float64.
* The routing decision itself, and gradcheck / gradgradcheck of the plain
  depthwise FIR (`DepthwiseFIR`, its own gradient) that the other cases run.
Layouts: JAX NHWC / HWIO, the port NCHW / OIHW.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pasta_gan_tpu import ops as jops
from pasta_gan_tpu.ops.pallas_upfirdn import downsample2x_pallas, upsample2x_pallas
from pasta_gan_tpu_torch.ops import conv2d_resample as tconv
from pasta_gan_tpu_torch.ops import upfirdn2d as tup
from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-5
TAPS = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (1, 8, 8, 4), (2, 4, 20, 3)])
def test_plain_versions_match_the_jax_tpu_kernels(shape):
    x = _x(0, shape)
    ref_up = upsample2x_pallas(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(_nhwc(uk.up2_reference(_nchw(x), 0)), np.asarray(ref_up), rtol=0, atol=ATOL)
    ref_down = downsample2x_pallas(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(_nhwc(uk.down2_reference(_nchw(x), 1)), np.asarray(ref_down), rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_canonical_cases_match_jax(size):
    """upsample2d, downsample2d, the up-conv (pre-FIR) and the 1x1 down-conv:
    the port routes each to up2 / down2 and agrees with JAX's depthwise path."""
    x = _x(size, (2, size, size, 6))
    f_t, f_j = tup.setup_filter(TAPS), jops.setup_filter(jnp.asarray(TAPS))
    xt, xj = _nchw(x), jnp.asarray(x)
    np.testing.assert_allclose(_nhwc(tup.upsample2d(xt, f_t)), np.asarray(jops.upsample2d(xj, f_j)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(_nhwc(tup.downsample2d(xt, f_t)), np.asarray(jops.downsample2d(xj, f_j)),
                               rtol=0, atol=ATOL)
    rng = np.random.default_rng(size + 1)
    for up, down, k in ((2, 1, 3), (1, 2, 1)):
        w = (rng.standard_normal((k, k, 6, 5)) * 0.3).astype(np.float32)
        ours = tconv.conv2d_resample(xt, torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                                     f=f_t, up=up, down=down, padding=k // 2, flip_weight=(up == 1))
        ref = jops.conv2d_resample(xj, jnp.asarray(w), f=f_j, up=up, down=down, padding=k // 2,
                                   flip_weight=(up == 1))
        np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=1e-5, atol=ATOL)


def test_fir2x_route_decides_from_filter_padding_and_gain():
    f = tup.setup_filter(TAPS)
    assert tup.fir2x_route(f, (2, 2), (1, 1), (2, 1, 2, 1), 4) == ("up2", 0)
    assert tup.fir2x_route(f, (2, 2), (1, 1), (3, 2, 3, 2), 4) == ("up2", 1)
    assert tup.fir2x_route(f, (1, 1), (2, 2), (1, 1, 1, 1), 1) == ("down2", 1)
    assert tup.fir2x_route(tup.setup_filter(TAPS[:3]), (2, 2), (1, 1), (2, 1, 2, 1), 4) is None
    assert tup.fir2x_route(f, (2, 2), (1, 1), (2, 1, 2, 1), 2) is None  # other gain
    assert tup.fir2x_route(f, (1, 1), (1, 1), (2, 2, 2, 2), 1) is None  # the 3x3 down-conv's FIR
    assert tup.fir2x_route(f, (1, 1), (2, 2), (1, 1, 1, 1), 1) == ("down2", 1)
    assert tup.fir2x_route(f * 2, (1, 1), (2, 2), (1, 1, 1, 1), 1) is None
    assert tup.fir2x_route(None, (1, 1), (2, 2), (1, 1, 1, 1), 1) is None


@pytest.mark.parametrize("size", [2, 3, 4, 8])
def test_adjoint_identities(size):
    """<up2(x), g> = <x, 4 down2(g, pad = 1 - e)> and <down2(y), h> =
    <y, 1/4 up2(h, extend = 1 - p)>, float64, to rounding."""
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.standard_normal((2, 3, size, size + 1)))
    for e in (0, 1):
        y = uk.up2_reference(x, e)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
        lhs, rhs = float((y * g).sum()), float((x * uk.down2_reference(g, 1 - e, 4.0)).sum())
        assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))
    if size % 2 == 0:
        for p in (0, 1):
            yd = torch.from_numpy(rng.standard_normal((2, 3, 2 * size + 2 * (1 - p), 2 * size)))
            d = uk.down2_reference(yd, p)
            h = torch.from_numpy(rng.standard_normal(tuple(d.shape)))
            lhs, rhs = float((d * h).sum()), float((yd * uk.up2_reference(h, 1 - p, 0.25)).sum())
            assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("arg", [0, 1])
def test_gradcheck_and_gradgradcheck(arg):
    x = torch.from_numpy(_x(arg, (1, 2, 4, 6)).astype(np.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: uk.up2(t, extend=arg, gain=1.5), (x,))
    assert torch.autograd.gradgradcheck(lambda t: uk.up2(t, extend=arg, gain=1.5) ** 2, (x,))
    assert torch.autograd.gradcheck(lambda t: uk.down2(t, pad=arg, gain=0.5), (x,))
    assert torch.autograd.gradgradcheck(lambda t: uk.down2(t, pad=arg, gain=0.5) ** 2, (x,))


def test_routed_gradients_match_the_depthwise_path():
    """Backward through the routed 1x1 down-conv and up-conv (down2 / up2 as
    each other's gradient) equals backward through the plain depthwise FIR,
    float64; so does R1's second derivative."""
    rng = np.random.default_rng(7)
    f = tup.setup_filter(TAPS).double()
    x0 = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)))
    w1 = torch.from_numpy(rng.standard_normal((4, 3, 1, 1)))
    w3 = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)))

    def plain(x):
        y = tup._depthwise_fir(x, f, (1, 1), (1, 1), (1, 1, 1, 1), False)
        a = torch.nn.functional.conv2d(y, w1, stride=2)
        up = tup._depthwise_fir(x, f * 4, (2, 2), (1, 1), (3, 2, 3, 2), False)
        b = torch.nn.functional.conv2d(up, w3.flip([2, 3]))
        return (a ** 2).sum() + (b ** 2).sum()

    def routed(x):
        a = tconv.conv2d_resample(x, w1, f=f, down=2)
        b = tconv.conv2d_resample(x, w3, f=f, up=2, padding=1, flip_weight=False)
        return (a ** 2).sum() + (b ** 2).sum()

    out = []
    for fn in (plain, routed):
        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x), x, create_graph=True)
        (gg,) = torch.autograd.grad((g * g).sum(), x)
        out.append((g.detach(), gg))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("padding,up,down", [
    ((2, 2, 2, 2), 1, 1),  # the 3x3 down-conv's full-resolution FIR
    ((-1, 2, 0, -1), 1, 1),  # crops
    ((1, 2, 0, 3), 2, 1),
    ((1, 2, 0, 3), 1, 2),
])
def test_plain_depthwise_fir_gradients(padding, up, down):
    """The plain path's FIR (the 3x3 down-convs' full-resolution filter, and
    every non-canonical case) differentiates to any order, float64."""
    f = tup.setup_filter(TAPS).double()
    x = torch.from_numpy(_x(1, (1, 1, 5, 6)).astype(np.float64)).requires_grad_(True)

    def fn(t):
        return tup._depthwise_fir(t, f, (up, up), (down, down), padding, False)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
