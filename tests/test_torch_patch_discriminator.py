"""The patch discriminators of the port (pasta_gan_tpu_torch/nn/
patch_discriminator.py) against the JAX package's, on the CPU.

* Each layer (PDConvLayer plain, 3x3 and 1x1 downsampling, pad 0, without
  bias; PDResBlock; EqualLinearPD) within rtol 1e-4 / atol 1e-5.
* `random_patch_transform` and `sample_patches` on JAX's draws (the test
  reproduces JAX's key splits, `jax_draws`): patch 64 on 96x96 images (the
  crop-offset path, H mod s = 32) and on 64x64 images, within 5e-5 (the
  transform's 3x3 product is formed in another order than JAX's einsum, and
  a coordinate's last bit moves a bilinear sample by up to ~1.3e-5).
* The whole discriminator at capacity 1, max_nc 64, patch 32, 4 tiles, on
  80x80 images (offset path), batch 2: V1 real-only, real + fake and
  `fake_only`, and V2, on JAX's draws (the fake branch's from
  `fold_in(rng, 1)` with the real branch's tiles): features within 2e-4 of
  max |JAX| and the head within rtol / atol 2e-3 (the JAX package's patch
  discriminator test limits).
* The gradient of the fake logits' sum to the fake image against
  `jax.grad`, relative L2 <= 1e-4.
* The carrier `patch_discriminator_state_dict_from_jax`: names, layouts, the
  Blur buffers, and that the 1x1 skips reach the `down2` route (counted
  through `upfirdn_kernels._down2_apply`) and its gradient `up2`.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.nn import patch_discriminator as jpd
from pasta_gan_tpu_torch.io.from_jax import patch_discriminator_state_dict_from_jax
from pasta_gan_tpu_torch.nn import patch_discriminator as pd
from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk
from pasta_gan_tpu_torch.ops.upfirdn2d import is_canonical_filter

CFG = dict(scale_capacity=1.0, max_nc=64, patch_size=32, max_num_tiles=4)
B, HW = 2, 80
FEAT_REL, HEAD_TOL, GRAD_REL_L2 = 2e-4, 2e-3, 1e-4
WARP_ATOL = 5e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def jax_draws(rng, BT, H, W, s, T):
    """JAX `sample_patches`' draws from `rng`, as the port's `draws` dict:
    oy and ox from one key, the permutation's first T indices, then
    `random_patch_transform`'s reflection and rotation."""
    k_off, k_perm, k_tf = jax.random.split(rng, 3)
    oy = int(jax.random.randint(k_off, (), 0, max(H % s, 1)))
    ox = int(jax.random.randint(k_off, (), 0, max(W % s, 1)))
    indices = np.asarray(jax.random.permutation(k_perm, (H // s) * (W // s))[:T])
    k1, k2 = jax.random.split(k_tf)
    ref = np.asarray(jnp.round(jax.random.uniform(k1, (BT,))) * 2.0 - 1.0)
    max_rot = 30.0 * math.pi / 180.0
    rot = np.asarray(jax.random.uniform(k2, (BT,)) * (2 * max_rot) - max_rot)
    return dict(oy=oy, ox=ox, indices=torch.from_numpy(indices.astype(np.int64)),
                ref=torch.from_numpy(ref.copy()), rot=torch.from_numpy(rot.copy()))


def _random_params(shapes, rng):
    return jax.tree_util.tree_map(
        lambda l: (rng.standard_normal(l.shape) * (0.1 if len(l.shape) == 1 else 1.0)).astype(np.float32), shapes)


def _layer_state(params, port):
    """A single layer's JAX params -> the port layer's state_dict (the carrier's rules)."""
    sd = {}
    for k, v in port.state_dict().items():
        parts = k.split(".")
        if parts[-2:] == ["Blur", "kernel"]:
            sd[k] = v
            continue
        node = params
        for p in parts[:-2] if parts[-2] in ("Conv", "Act") else parts[:-1]:
            node = node[p]
        a = np.asarray(node[parts[-1]])
        sd[k] = torch.from_numpy(a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a.copy())
    port.load_state_dict(sd, strict=True)
    return port


LAYERS = {
    "conv3": (lambda: jpd.PDConvLayer(8, 16, 3), lambda: pd.PDConvLayer(8, 16, 3)),
    "conv3_down": (lambda: jpd.PDConvLayer(8, 16, 3, downsample=True), lambda: pd.PDConvLayer(8, 16, 3, downsample=True)),
    "skip1_down": (lambda: jpd.PDConvLayer(8, 16, 1, downsample=True, activate=False, use_bias=False),
                   lambda: pd.PDConvLayer(8, 16, 1, downsample=True, activate=False, bias=False)),
    "conv3_pad0": (lambda: jpd.PDConvLayer(8, 16, 3, pad=0), lambda: pd.PDConvLayer(8, 16, 3, pad=0)),
    "conv3_linear_bias": (lambda: jpd.PDConvLayer(8, 16, 3, activate=False),
                          lambda: pd.PDConvLayer(8, 16, 3, activate=False)),
    "conv3_lrelu_nobias": (lambda: jpd.PDConvLayer(8, 16, 3, use_bias=False),
                           lambda: pd.PDConvLayer(8, 16, 3, bias=False)),
    "resblock": (lambda: jpd.PDResBlock(8, 16), lambda: pd.PDResBlock(8, 16)),
    "resblock_same": (lambda: jpd.PDResBlock(8, 16, downsample=False), lambda: pd.PDResBlock(8, 16, downsample=False)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    rng = np.random.default_rng(sorted(LAYERS).index(name))
    jm, pm = LAYERS[name][0](), LAYERS[name][1]()
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    params = _random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], rng)
    _layer_state(params, pm)
    y = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        yp = pm(nchw(x))
    np.testing.assert_allclose(yp.numpy(), np.asarray(y).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activation", [None, "fused_lrelu"])
def test_equal_linear_matches_jax(activation):
    rng = np.random.default_rng(7)
    jm, pm = jpd.EqualLinearPD(24, 12, lr_mul=0.5, activation=activation), pd.EqualLinearPD(24, 12, 0.5, activation)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    params = _random_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], rng)
    pm.load_state_dict({k: torch.from_numpy(np.asarray(params[k])) for k in ("weight", "bias")}, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), np.asarray(jm.apply({"params": params}, x)),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [96, 64])
def test_sample_patches_and_transform_on_jax_draws(size):
    """patch 64: at 96x96 the crop offset is drawn in [0, 32), at 64x64 it is 0."""
    rng = np.random.default_rng(size)
    img = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    cfg = dict(scale_capacity=1.0, max_nc=64, patch_size=64, max_num_tiles=8)
    jD, D = jpd.StyleGAN2PatchDiscriminator(**cfg), pd.StyleGAN2PatchDiscriminator(**cfg)
    key = jax.random.PRNGKey(size)
    tiles_j, ids_j = jD.apply({}, jnp.asarray(img), key, method=jD.sample_patches)
    T = tiles_j.shape[1]
    draws = jax_draws(key, B * T, size, size, 64, 8)
    if size == 96:
        assert 0 < draws["oy"] < 32 and draws["oy"] == draws["ox"]  # one key draws both
    tiles, ids = D.sample_patches(nchw(img), draws)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(tiles.numpy(), np.asarray(tiles_j).transpose(0, 1, 4, 2, 3), rtol=1e-5, atol=WARP_ATOL)

    patches = rng.uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32)
    out_j = jpd.random_patch_transform(jnp.asarray(patches), key)
    k1, k2 = jax.random.split(key)  # random_patch_transform's own split of its key
    ref = torch.from_numpy(np.asarray(jnp.round(jax.random.uniform(k1, (6,))) * 2.0 - 1.0).copy())
    rot = torch.from_numpy(np.asarray(jax.random.uniform(k2, (6,)) * (math.pi / 3) - math.pi / 6).copy())
    out = pd.random_patch_transform(nchw(patches), ref, rot)
    assert bool((out == 0).any()), "a rotation leaves zero corners"
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j).transpose(0, 3, 1, 2), rtol=1e-5, atol=WARP_ATOL)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    out = {}
    for variant, jcls, pcls in (("v1", jpd.StyleGAN2PatchDiscriminator, pd.StyleGAN2PatchDiscriminator),
                                ("v2", jpd.StyleGAN2PatchDiscriminatorV2, pd.StyleGAN2PatchDiscriminatorV2)):
        jD = jcls(**CFG)
        shapes = jax.eval_shape(lambda: jD.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                                                rng=jax.random.PRNGKey(1)))
        v = {"params": _random_params(shapes["params"], rng)}
        D = pcls(**CFG)
        D.load_state_dict(patch_discriminator_state_dict_from_jax(v, D.state_dict()), strict=True)
        out[variant] = (jD, D, v)
    real = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    return out, real, fake


def _both_draws(key):
    T = CFG["max_num_tiles"]
    return (jax_draws(key, B * T, HW, HW, CFG["patch_size"], T),
            jax_draws(jax.random.fold_in(key, 1), B * T, HW, HW, CFG["patch_size"], T))


def test_features_match_jax(pair):
    (jD, D, v), rng = pair[0]["v1"], np.random.default_rng(1)
    patches = rng.standard_normal((B, 3, CFG["patch_size"], CFG["patch_size"], 3)).astype(np.float32) * 0.5
    feat_j = np.array(jD.apply(v, jnp.asarray(patches), method=jD.extract_features)).transpose(0, 3, 1, 2).copy()
    with torch.no_grad():
        feat = D.extract_features(torch.from_numpy(np.ascontiguousarray(patches.transpose(0, 1, 4, 2, 3)))).numpy()
    assert np.max(np.abs(feat - feat_j)) / np.abs(feat_j).max() <= FEAT_REL
    f2 = np.roll(feat_j, 1, axis=0)
    head_j = jD.apply(v, jnp.asarray(feat_j.transpose(0, 2, 3, 1)), jnp.asarray(f2.transpose(0, 2, 3, 1)),
                      method=jD.discriminate_features)
    with torch.no_grad():
        head = D.discriminate_features(torch.from_numpy(feat_j), torch.from_numpy(f2))
    np.testing.assert_allclose(head.numpy(), np.asarray(head_j), rtol=HEAD_TOL, atol=HEAD_TOL)


@pytest.mark.parametrize("mode", ["real_only", "real_fake", "fake_only", "v2"])
def test_forward_matches_jax(pair, mode):
    nets, real, fake = pair
    jD, D, v = nets["v2" if mode == "v2" else "v1"]
    key = jax.random.PRNGKey(11)
    draws = _both_draws(key)
    assert 0 < draws[0]["oy"] < 16  # 80 mod 32: the crop-offset path
    args_j = (jnp.asarray(real),) + ((jnp.asarray(fake),) if mode in ("real_fake", "fake_only") else ())
    args = (nchw(real),) + ((nchw(fake),) if mode in ("real_fake", "fake_only") else ())
    ref = jD.apply(v, *args_j, rng=key, fake_only=mode == "fake_only")
    with torch.no_grad():
        out = D(*args, fake_only=mode == "fake_only", draws=draws)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    if mode == "real_only":  # (pred_real, real_patches)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]).transpose(0, 1, 4, 2, 3), rtol=1e-5,
                                   atol=WARP_ATOL)
        ref, out = ref[:1], out[:1]
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=HEAD_TOL, atol=HEAD_TOL)


def test_gradient_to_fake_matches_jax(pair):
    nets, real, fake = pair
    jD, D, v = nets["v1"]
    key = jax.random.PRNGKey(12)
    gj = jax.grad(lambda f: jnp.sum(jD.apply(v, jnp.asarray(real), f, rng=key, fake_only=True)))(jnp.asarray(fake))
    f = nchw(fake).requires_grad_(True)
    D(nchw(real), f, fake_only=True, draws=_both_draws(key)).sum().backward()
    g, gj = f.grad.numpy(), np.asarray(gj).transpose(0, 3, 1, 2)
    rel = float(np.linalg.norm(g - gj) / np.linalg.norm(gj))
    print(f"patch discriminator: d(sum of the fake logits)/d fake, relative L2 against jax.grad {rel:.3g}")
    assert rel <= GRAD_REL_L2


def test_carrier_and_the_down2_route(pair, monkeypatch):
    nets, real, fake = pair
    jD, D, v = nets["v1"]
    sd = patch_discriminator_state_dict_from_jax(v)
    names = sorted({k.split(".")[1] for k in sd if k.startswith("convs.")})
    assert names == ["0", "2", "3", "4", "5", "6"]  # patch 32: no 64x64 level
    assert "convs.0.Act.bias" in sd and "convs.0.Conv.bias" not in sd
    assert "convs.2.skip.Conv.weight" in sd and not any(k.startswith("convs.2.skip.") and "bias" in k for k in sd)
    assert "convs.5.skip.Blur.kernel" not in sd and "convs.5.conv2.Blur.kernel" not in sd  # the level that keeps its size
    assert is_canonical_filter(sd["convs.2.skip.Blur.kernel"])
    np.testing.assert_array_equal(sd["pairlinear.0.weight"].numpy(), np.asarray(v["params"]["pairlinear_0"]["weight"]))
    np.testing.assert_array_equal(sd["convs.0.Conv.weight"].numpy(),
                                  np.asarray(v["params"]["convs_0"]["weight"]).transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match="collections"):
        patch_discriminator_state_dict_from_jax({**v, "spectral": {}})

    calls = {"up2": 0, "down2": 0}

    def counted(kind, fn):
        def run(*a):
            calls[kind] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(uk, "_down2_apply", counted("down2", uk._down2_apply))
    monkeypatch.setattr(uk, "_up2_apply", counted("up2", uk._up2_apply))
    f = nchw(fake).requires_grad_(True)
    pred_real, pred_fake = D(nchw(real), f, generator=torch.Generator().manual_seed(0))
    n_down_levels = len(names) - 3  # the halving ResBlocks
    assert calls == {"up2": 0, "down2": 2 * n_down_levels}  # one skip a level, real and fake
    pred_fake.sum().backward()
    assert calls == {"up2": 2 * n_down_levels, "down2": 2 * n_down_levels}  # pred_fake reads both branches
