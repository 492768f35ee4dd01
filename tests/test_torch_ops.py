"""Port ops (pasta_gan_tpu_torch/ops, nn/layers) vs the JAX package on the CPU.

Same numpy inputs through the JAX function and its PyTorch counterpart; the
tolerances are those of tests/test_ops.py: rtol 1e-4, atol 1e-5 (bias_act
atol 1e-4).  Layouts: JAX NHWC/HWIO, port NCHW/OIHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import ops as jops
from pasta_gan_tpu.nn import layers as jlayers
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.nn import layers as tlayers
from pasta_gan_tpu_torch.ops import bias_act as tbias
from pasta_gan_tpu_torch.ops import conv2d_resample as tconv
from pasta_gan_tpu_torch.ops import modulated_conv2d as tmod
from pasta_gan_tpu_torch.ops import upfirdn2d as tup

RTOL, ATOL = 1e-4, 1e-5
TAPS = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("act", list(tbias.activation_funcs))
def test_bias_act_matches_jax(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 6), dtype=np.float32) * 2
    b = rng.standard_normal((6,), dtype=np.float32)
    ours = tbias.bias_act(_nchw(x), torch.from_numpy(b), act=act, gain=1.3, clamp=2.5)
    ref = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=1.3, clamp=2.5)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=1e-4)
    ours = tbias.bias_act(_nchw(x), act=act)  # default gain, no clamp
    ref = jops.bias_act(jnp.asarray(x), act=act)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=1e-4)


def test_setup_filter_matches_jax():
    for taps, kw in ((TAPS, {}), (TAPS, dict(flip_filter=True, gain=4.0)), (np.hanning(8) + 0.1, {})):
        ours = tup.setup_filter(taps.astype(np.float32), **kw)
        ref = jops.setup_filter(jnp.asarray(taps, jnp.float32), **kw)
        assert tuple(ours.shape) == tuple(ref.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize(
    "up,down,padding",
    [(1, 1, 0), (2, 1, (2, 1, 2, 1)), (1, 2, 1), (2, 2, (1, 1, 1, 1)), (4, 1, 3), (1, 1, (-1, 2, 0, -1))],
)
@pytest.mark.parametrize("flip", [False, True])
def test_upfirdn2d_matches_jax(up, down, padding, flip):
    x = np.random.default_rng(1).standard_normal((2, 12, 10, 3), dtype=np.float32)
    ours = tup.upfirdn2d(_nchw(x), tup.setup_filter(TAPS), up=up, down=down, padding=padding,
                         flip_filter=flip, gain=2.0)
    ref = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(jnp.asarray(TAPS)), up=up, down=down,
                         padding=padding, flip_filter=flip, gain=2.0)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_upfirdn2d_separable_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 16, 16, 2), dtype=np.float32)
    taps = (np.hanning(8) + 0.1).astype(np.float32)
    f = tup.setup_filter(taps)
    assert f.ndim == 1
    ours = tup.upfirdn2d(_nchw(x), f, up=2, padding=(3, 2, 3, 2))
    ref = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(jnp.asarray(taps)), up=2, padding=(3, 2, 3, 2))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("helper", ["filter2d", "upsample2d", "downsample2d"])
def test_resample_helpers_match_jax(helper):
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ours = getattr(tup, helper)(_nchw(x), tup.setup_filter(TAPS))
    ref = getattr(jops, helper)(jnp.asarray(x), jops.setup_filter(jnp.asarray(TAPS)))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "up,down,padding,kernel,groups",
    [(1, 1, 1, 3, 1), (2, 1, 1, 3, 1), (1, 2, 1, 3, 1), (1, 2, 0, 1, 1), (2, 1, 0, 1, 1), (1, 1, 0, 4, 2)],
)
@pytest.mark.parametrize("flip_weight", [True, False])
def test_conv2d_resample_matches_jax(up, down, padding, kernel, groups, flip_weight):
    rng = np.random.default_rng(4)
    N, I, O, H = 2, 6, 8, 10
    x = rng.standard_normal((N, H, H, I), dtype=np.float32)
    w = rng.standard_normal((kernel, kernel, I // groups, O), dtype=np.float32) * 0.3
    ours = tconv.conv2d_resample(_nchw(x), _oihw(w), f=tup.setup_filter(TAPS), up=up, down=down,
                                 padding=padding, groups=groups, flip_weight=flip_weight)
    ref = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jops.setup_filter(jnp.asarray(TAPS)),
                               up=up, down=down, padding=padding, groups=groups, flip_weight=flip_weight)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("spade", [False, True])
def test_modulated_conv2d_matches_jax(demodulate, up, spade):
    rng = np.random.default_rng(5)
    N, I, O, H, k = 3, 4, 6, 8, 3
    x = rng.standard_normal((N, H, H, I), dtype=np.float32)
    w = rng.standard_normal((k, k, I, O), dtype=np.float32) * 0.4
    s = rng.standard_normal((N, I), dtype=np.float32) * 0.5 + 1.0
    sp = rng.standard_normal((N, H, H, I), dtype=np.float32) if spade and up == 1 else None
    noise = rng.standard_normal((N, H * up, H * up, 1), dtype=np.float32) * 0.1
    ours = tmod.modulated_conv2d(
        _nchw(x), _oihw(w), torch.from_numpy(s), noise=_nchw(noise), up=up, padding=k // 2,
        resample_filter=tup.setup_filter(TAPS) if up > 1 else None, demodulate=demodulate,
        flip_weight=(up == 1), spade_styles=None if sp is None else _nchw(sp),
    )
    ref = jops.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), noise=jnp.asarray(noise), up=up, padding=k // 2,
        resample_filter=jops.setup_filter(jnp.asarray(TAPS)) if up > 1 else None,
        demodulate=demodulate, flip_weight=(up == 1), spade_styles=None if sp is None else jnp.asarray(sp),
    )
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_modulated_conv2d_prenorm_bf16_matches_jax():
    """The half-precision pre-normalization path, in bf16 on both sides; the
    tolerance is bf16's (8 mantissa bits), not the fp32 one."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 6, 8), dtype=np.float32)
    w = rng.standard_normal((3, 3, 8, 5), dtype=np.float32)
    s = rng.standard_normal((2, 8), dtype=np.float32) + 2
    ours = tmod.modulated_conv2d(_nchw(x).bfloat16(), _oihw(w).bfloat16(), torch.from_numpy(s).bfloat16(),
                                 padding=1)
    ref = jops.modulated_conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(s, jnp.bfloat16), padding=1)
    np.testing.assert_allclose(_nhwc(ours.float()), np.asarray(ref, np.float32), rtol=3e-2, atol=3e-2)


def test_norm_helpers_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 5, 3), dtype=np.float32) * 3 + 1
    np.testing.assert_allclose(_nhwc(tlayers.instance_norm_2d(_nchw(x))),
                               np.asarray(jlayers.instance_norm_2d(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    z = rng.standard_normal((4, 16), dtype=np.float32)
    np.testing.assert_allclose(tlayers.normalize_2nd_moment(torch.from_numpy(z)).numpy(),
                               np.asarray(jlayers.normalize_2nd_moment(jnp.asarray(z))), rtol=RTOL, atol=ATOL)


def _flax_vs_port(jmod, tmod_, jargs, targs, edit=None):
    """Init the flax module, load its params into the port module, run both.
    `edit(params)` may change the initial params first."""
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), *jargs))
    if edit is not None:
        edit(v["params"])
    tmod_.load_state_dict(state_dict_from_jax(v, tmod_.state_dict()), strict=True)
    with torch.no_grad():
        return jmod.apply(v, *jargs), tmod_(*targs)


@pytest.mark.parametrize(
    "kw", [dict(kernel_size=3), dict(kernel_size=3, down=2, activation="lrelu", conv_clamp=0.5),
           dict(kernel_size=1, up=2, use_bias=False), dict(kernel_size=7, activation="relu")],
)
def test_conv2d_layer_matches_jax(kw):
    x = np.random.default_rng(8).standard_normal((2, 8, 8, 4), dtype=np.float32)
    tkw = dict(kw)
    tkw["bias"] = tkw.pop("use_bias", True)
    ref, ours = _flax_vs_port(jlayers.Conv2dLayer(4, 6, **kw), tlayers.Conv2dLayer(4, 6, **tkw),
                              (jnp.asarray(x),), (_nchw(x),))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_fully_connected_layer_matches_jax():
    z = np.random.default_rng(9).standard_normal((3, 8), dtype=np.float32)
    ref, ours = _flax_vs_port(jlayers.FullyConnectedLayer(8, 5, activation="lrelu", lr_multiplier=0.01),
                              tlayers.FullyConnectedLayer(8, 5, activation="lrelu", lr_multiplier=0.01),
                              (jnp.asarray(z),), (torch.from_numpy(z),))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _set_gamma(params):
    params["gamma"] = np.float32(0.7)  # flax inits it to 0: make the branch count


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.ResBlock(16, 32, activation="relu", down=2),
        lambda m: m.DenseNorm(16, 16),
        lambda m: m.SelfAttention(16),
    ],
    ids=["resblock", "densenorm", "selfattention"],
)
def test_layer_blocks_match_jax(make):
    x = np.random.default_rng(10).standard_normal((2, 8, 8, 16), dtype=np.float32)
    jm, tm = make(jlayers), make(tlayers)
    edit = _set_gamma if isinstance(tm, tlayers.SelfAttention) else None
    ref, ours = _flax_vs_port(jm, tm, (jnp.asarray(x),), (_nchw(x),), edit)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=RTOL, atol=ATOL)
