"""The port's ADA pipe (train/augment.py) against the JAX package's, on the CPU.

Same numpy-seeded inputs on both sides.  Bounds are max abs errors unless
stated:

* the two-pass affine resample (ops/shear_warp.py) against
  `affine_resample_two_pass` on float32 images in [0, 1], 64x64 -> 48x56,
  within 1e-5, for the axis-aligned maps of tests/test_shear_warp.py (cut to
  64x64), rotations (100 and -120 degrees take the transposed branch), a
  negative slope and a far offscreen shift.  The gradient of sum(out^2) is
  the exact adjoint of JAX's forward (which is exact in float32): the
  identity <grad, v> = <2 out, J v> holds within a relative 1e-5 for random
  v.  `jax.grad` itself carries the cotangents through the bf16 one-hot
  matmuls of the JAX code (its mantissa split covers only the forward), so
  the gradient is held to it within a relative L2 of 2^-8, bf16's
  precision;
* the exact warp (data/warp.py:warp_perspective_inv) against
  `warp_perspective_inv(..., "constant", False)`, with the same bounds;
* the whole pipe in debug mode (`debug_percentile`) for seven specs, fast and
  exact geometry, 2x64x64x3 images in [-1, 1], within 1e-4; the noise stage
  by the output's std within 20 % (the noise images differ); bf16 images
  within a relative L2 of 1e-2; p = 0, deterministic on both sides, within
  1e-4;
* the port's gate rates at p 0.5 and 1 over 4096 draws within 4 binomial
  sigma of the probabilities the JAX code gates with (p_rot for the two
  rotations).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.data.warp import warp_perspective_inv as jax_warp_perspective_inv
from pasta_gan_tpu.ops.shear_warp import affine_resample_two_pass as jax_two_pass
from pasta_gan_tpu.train.augment import AugmentPipe as JaxAugmentPipe
from pasta_gan_tpu_torch.data.warp import warp_perspective_inv
from pasta_gan_tpu_torch.ops.shear_warp import affine_resample_two_pass
from pasta_gan_tpu_torch.train.augment import AUGPIPE_SPECS, AugmentPipe

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

OUT_HW = (48, 56)


def _rot(deg, tx, ty):
    th = np.deg2rad(deg)
    return [[np.cos(th), -np.sin(th), tx], [np.sin(th), np.cos(th), ty]]


MATRICES = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "translate_frac": [[1, 0, 3.3], [0, 1, -2.7]],
    "scale": [[1.7, 0, -10], [0, 0.6, 4.0]],
    "xflip": [[-1, 0, 63], [0, 1, 0.0]],
    "yflip": [[1, 0, 0], [0, -1, 63.0]],
    "rot90_translate": [[0, -1, 55], [1, 0, 8.0]],
    "rot180": [[-1, 0, 63], [0, -1, 63.0]],
    "far_offscreen": [[1, 0, -400], [0, 1, 0.0]],
    "rot30": _rot(30, 20, -7),
    "rot45": _rot(45, 25, -20),
    "rot100": _rot(100, 60, 5),
    "rot-120": _rot(-120, 70, 60),
    "negative_slope": [[-0.7, 0.3, 50], [0.2, 0.9, 3.0]],
}


def _images(seed, n=1, lo=0.0, hi=1.0, size=64):
    return np.random.default_rng(seed).uniform(lo, hi, (n, size, size, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@jax.jit
def _jax_two_pass_sq(img, A):
    out = jax_two_pass(img, A, OUT_HW)
    return out, jax.grad(lambda im: jnp.sum(jnp.square(jax_two_pass(im, A, OUT_HW))))(img)


@jax.jit
def _jax_exact_sq(img, A3):
    def f(im):
        return jax_warp_perspective_inv(im, A3, OUT_HW, "constant", False)

    return f(img), jax.grad(lambda im: jnp.sum(jnp.square(f(im))))(img)


def _port_sq(fn, img, A):
    x = nchw(img).requires_grad_(True)
    out = fn(x, torch.from_numpy(A)[None])
    (g,) = torch.autograd.grad(out.square().sum(), x)
    return out[0].permute(1, 2, 0).detach().numpy(), g[0].permute(1, 2, 0).numpy()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_two_pass_resample_and_gradient_match_jax(name):
    img = _images(0)
    A = np.asarray(MATRICES[name], np.float32)
    ref, ref_g = (np.asarray(v) for v in _jax_two_pass_sq(jnp.asarray(img[0]), jnp.asarray(A)))
    out, g = _port_sq(lambda x, a: affine_resample_two_pass(x, a, OUT_HW), img, A)
    assert out.shape == ref.shape == OUT_HW + (3,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if np.abs(ref_g).max() == 0:  # far offscreen samples nothing
        assert np.abs(g).max() == 0
        return
    assert rel_l2(g, ref_g) <= 2.0 ** -8
    for seed in (10, 11):
        v = _images(seed)[0] - 0.5
        jv = np.asarray(_jax_two_pass_sq(jnp.asarray(v), jnp.asarray(A))[0], np.float64)
        lhs, rhs = float(np.sum(g * v, dtype=np.float64)), float(np.sum(2 * out * jv, dtype=np.float64))
        assert abs(lhs - rhs) <= 1e-5 * abs(rhs), (lhs, rhs)


@pytest.mark.parametrize("name", ["identity", "scale", "xflip", "rot30", "rot-120", "far_offscreen", "perspective"])
def test_exact_warp_and_gradient_match_jax(name):
    img = _images(1)
    if name == "perspective":
        A3 = np.asarray([[0.9, 0.1, 4.0], [-0.05, 1.1, 2.0], [0.002, -0.001, 1.0]], np.float32)
    else:
        A3 = np.concatenate([np.asarray(MATRICES[name], np.float32), [[0, 0, 1]]]).astype(np.float32)
    ref, ref_g = (np.asarray(v) for v in _jax_exact_sq(jnp.asarray(img[0]), jnp.asarray(A3)))
    out, g = _port_sq(lambda x, a: warp_perspective_inv(x, a, OUT_HW, "constant"), img, A3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if np.abs(ref_g).max() == 0:
        assert np.abs(g).max() == 0
    else:
        assert rel_l2(g, ref_g) <= 1e-5


def _both(spec, imgs, p, dp=None, fast=False, dtype=np.float32):
    jpipe = JaxAugmentPipe.from_spec(spec, fast_geom=fast)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jpipe(jnp.asarray(imgs, jdt), p, jax.random.PRNGKey(0), debug_percentile=dp)
    out = AugmentPipe.from_spec(spec, fast_geom=fast)(torch.from_numpy(imgs).to(tdt), p,
                                                      torch.Generator().manual_seed(0), debug_percentile=dp)
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("dp", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("spec", ["blit", "geom", "color", "filter", "cutout", "bgc", "bgcf"])
def test_pipe_debug_mode_matches_jax(spec, fast, dp):
    imgs = _images(2, n=2, lo=-1.0)
    out, ref = _both(spec, imgs, 1.0, dp, fast)
    assert out.shape == ref.shape == imgs.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    if dp != 0.5:  # the median draw is the identity for some stages
        assert np.abs(out - imgs).max() > 1e-2


def test_noise_debug_mode_matches_jax_by_std():
    imgs = _images(3, n=2, lo=-1.0)
    out, ref = _both("noise", imgs, 1.0, 0.4)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.std(), ref.std(), rtol=0.2)
    np.testing.assert_allclose((out - imgs).std(), (ref - imgs).std(), rtol=0.2)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_pipe_bf16_matches_jax_bf16(fast):
    imgs = _images(4, n=2, lo=-1.0)
    out, ref = _both("bgc", imgs, 1.0, 0.3, fast, dtype="bfloat16")
    assert rel_l2(out, ref) <= 1e-2


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("spec", ["bgc", "bgcfn", "cutout"])
def test_pipe_at_p0_matches_jax(spec, fast):
    # (the JAX pipe draws its keys from a split of 32, which bgcfnc overruns)
    imgs = _images(5, n=2, lo=-1.0)
    out, ref = _both(spec, imgs, 0.0, None, fast)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_gate_rates_match_the_jax_probabilities(p):
    n = 4096
    pipe = AugmentPipe.from_spec("bgcfnc")
    d = pipe.draw(n, 64, 64, 3, p, torch.Generator().manual_seed(7))
    pf = jnp.float32(p)
    p_rot = float(1 - jnp.sqrt(jnp.clip(1 - pipe.rotate * pf, 0, 1)))
    expected = {name: float(strength * pf) for name, strength in AUGPIPE_SPECS["bgcfnc"].items()
                if name not in ("rotate", "imgfilter")}
    expected.update(rotate=p_rot, rotate_post=p_rot,
                    **{f"imgfilter{i}": float(pipe.imgfilter * pf * b) for i, b in enumerate(pipe.imgfilter_bands)})
    assert sorted(d.gates) == sorted(expected)
    for name, e in expected.items():
        rate = float(d.gates[name].float().mean())
        assert abs(rate - e) <= 4 * np.sqrt(e * (1 - e) / n), (name, rate, e)
    # a gated-off sample keeps the identity: scale, rotation and xfrac leave G_inv alone
    closed = ~(d.gates["xflip"] | d.gates["rotate90"] | d.gates["xint"] | d.gates["scale"] | d.gates["rotate"]
               | d.gates["aniso"] | d.gates["rotate_post"] | d.gates["xfrac"])
    assert bool(closed.any()) == (p < 1)
    torch.testing.assert_close(d.G_inv[closed], torch.eye(3).expand(int(closed.sum()), 3, 3), rtol=0, atol=0)
