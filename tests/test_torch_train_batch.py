"""The port's training batch (data/dataset.py:prepare_train_batch, with the
self-routing `data/warp.py:route_patches_batch`) against the JAX package's,
on the CPU, given the same host samples and the same three uniform draws of
the random erasure.  Tolerance atol 5e-5 (the routing tests'); the batch is
one whose denormalized mask values all keep farther than 1e-5 from 254.5/255,
so every pixel is compared.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import geometry as jg
from pasta_gan_tpu.data import warp as jw
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import warp as tw

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 5e-5
NEAR = 1e-5


def _host_batch(B=2, seed=4):
    ds = tds.SyntheticUvitonDataset(num_samples=B, seed=seed)
    host = tds.collate([ds[i] for i in range(B)])
    # one ACGPN mask, so the erasure's second source is exercised
    host["acgpn_mask"][0, 100:140, 90:130] = 1
    return host


def _jax_draws(rng, B):
    k1, k2, k3 = jax.random.split(rng, 3)
    return (np.asarray(jax.random.uniform(k1, (B, 1, 1, 1))), np.asarray(jax.random.uniform(k2, (B, 4, 1, 1, 1))),
            np.asarray(jax.random.uniform(k3, (B, 1, 1, 1))))


def _jax_self_denorm_masks(host):
    """The oracle's denorm mask values [B, 14, H, W] of the training route."""
    f = lambda k: jnp.asarray(host[k], jnp.float32)  # noqa: E731
    L = jg.LOWER_PART_START
    img, um, lm = f("image") / 255.0, f("upper_mask"), f("lower_mask")
    M, M_inv, v = jg.part_transforms(f("keypoints"), img_h=256, patch_w=64, patch_h=64, pad_x=32.0)
    out = []
    for b in range(img.shape[0]):
        wu = jw._warp_parts(jnp.concatenate([img[b] * um[b], um[b]], -1), M[b], (64, 64), "replicate", planar=True)
        wl = jw._warp_parts(jnp.concatenate([img[b] * lm[b], lm[b]], -1), M[b, L:], (64, 64), "replicate",
                            planar=True)
        srcs = jnp.concatenate([wu * v[b][:, None, None, None], wl * v[b, L:][:, None, None, None]])
        dn = jw.denorm_warp_parts(srcs, jnp.concatenate([M_inv[b], M_inv[b, L:]]),
                                  jnp.concatenate([v[b], v[b, L:]]), (256, 256), planar_in=True)
        out.append(np.asarray(dn[:, 3]))
    return np.stack(out)


def test_prepare_train_batch_matches_jax():
    host = _host_batch()
    rng = jax.random.PRNGKey(5)
    with jax.disable_jit():  # jit fusion reassociates the coordinate math (~8e-5 on patch values)
        ref = {k: np.asarray(v) for k, v in jds.prepare_train_batch(host, rng).items()}
        masks = _jax_self_denorm_masks(host)
    assert int((np.abs(masks - jw.MASK_SATURATION_THRESHOLD) <= NEAR).sum()) == 0, "pick another seed"
    draws = _jax_draws(rng, 2)
    ours = tds.prepare_train_batch(host, device="cpu", draws=draws)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_allclose(ours[k].numpy(), v, atol=TOL, err_msg=k)
    # the draws erased something: hands or the ACGPN square
    assert float((ours["denorm_upper_img"] == -1.0).float().mean()) > 0


def test_route_patches_batch_matches_jax():
    host = _host_batch(B=1, seed=6)
    f = lambda k: np.asarray(host[k], np.float32)  # noqa: E731
    img = f("image") / 255.0
    args = (img * f("upper_mask"), img * f("lower_mask"), f("upper_mask"), f("lower_mask"), f("keypoints"))
    with jax.disable_jit():
        ref = jw.route_patches_batch(*[jnp.asarray(a) for a in args])
    ours = tw.route_patches_batch(*[torch.from_numpy(a) for a in args])
    for name in ref._fields:
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32), atol=TOL, err_msg=name)


def test_erasure_draws_come_from_the_generator():
    host = _host_batch()
    a = tds.prepare_train_batch(host, torch.Generator().manual_seed(3), device="cpu")
    b = tds.prepare_train_batch(host, torch.Generator().manual_seed(3), device="cpu")
    draws = tds.erasure_draws(2, torch.Generator().manual_seed(3))
    c = tds.prepare_train_batch(host, device="cpu", draws=draws)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        torch.testing.assert_close(a[k], c[k], rtol=0, atol=0)
