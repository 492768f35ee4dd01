"""The try-on grids' routing and the grid writers of the port vs the JAX
package on the CPU (the snapshot grids' forwards: tests/test_torch_grids_snapshot.py;
`cli.train --img_snap 1`: tests/test_torch_grids_cli.py).

* `route_patches_mix_batch` for each `swap` and `prepare_tryon_grid_batch`
  against the JAX functions run op by op (`jax.disable_jit`, as
  tests/test_torch_v18.py does) on a synthetic batch of 2: atol 5e-5, the
  routing tolerance of tests/test_torch_routing.py, on every pixel (the
  pixels whose plain denorm mask value lies within 1e-5 of 254.5/255 are
  asserted to be none); the separate denorm route equals the fused one
  exactly on the CPU.
* `save_image_grid` writes the same pixels as the JAX package's PIL writer
  (both files decoded by the port's PNG decoder), for 3- and 1-channel
  images, both dranges and explicit columns; `parsing_to_rgb` equals the JAX
  function on logits, indices and single-channel indices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import utils as jutils
from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import warp as jw
from pasta_gan_tpu_torch import utils as tutils
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import image_io
from pasta_gan_tpu_torch.data import warp as tw
from pasta_gan_tpu_torch.ops import warp_kernels as wk

from _torch_native import jax_native_oracle  # noqa: F401  (autouse fixture)
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 5e-5
NEAR = 1e-5
SWAPS = ("lower", "full", "upper")


def _host_batch(B=2, seed=4):
    ds = jds.SyntheticUvitonDataset(num_samples=2 * B, seed=seed)
    return jds.collate([ds[i] for i in range(B)]), jds.collate([ds[B + i] for i in range(B)])


def _mix_args(person, garment):
    """The routing arguments `prepare_tryon_grid_batch` builds, as numpy."""
    f = lambda d, k: np.asarray(d[k], np.float32)  # noqa: E731
    args = []
    for d in (person, garment):
        img, up, lo = f(d, "image") / 255.0, f(d, "upper_mask"), f(d, "lower_mask")
        args += [img * up, img * lo, up, lo]
    return args + [f(person, "keypoints"), f(garment, "keypoints")]


def _near_pixels(r):
    """Pixels a near-threshold plain denorm mask value could flip (dilated by
    the 5x5 erosion for eroded parts), from a route's operands `r`."""
    patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"],
                                     r["patch_hw"])
    m = wk.denorm_warp_reference(patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"])[:, :, 3]
    near = ((m - wk.MASK_SATURATION_THRESHOLD).abs() <= NEAR).float()
    ero = [p for p, e in enumerate(r["erode_parts"]) if e]
    near[:, ero] = torch.nn.functional.max_pool2d(near[:, ero], 5, stride=1, padding=2)
    return int((near.amax(1) > 0).sum())


@pytest.mark.parametrize("swap", SWAPS)
def test_route_patches_mix_matches_jax(swap):
    args = _mix_args(*_host_batch())
    targs = [torch.from_numpy(a) for a in args]
    r = tw.mix_warp_inputs(*targs, swap=swap)
    assert r["hand_parts"] == (2, 3, 4, 5) and r["erode_parts"] == (True,) * 6 + (False,) * 8
    assert _near_pixels(r) == 0, "near-threshold pixels on this batch; pick another seed"
    with jax.disable_jit():
        ref = jw.route_patches_mix_batch(*[jnp.asarray(a) for a in args], swap=swap)
    ours = tw.route_patches_mix_batch(*targs, swap=swap)
    assert ours._fields == ref._fields
    for name in ours._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=TOL, err_msg=name)
    separate = tw.route_patches_mix_batch(*targs, swap=swap, denorm="separate")
    for name in ours._fields:
        torch.testing.assert_close(getattr(separate, name), getattr(ours, name), rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError, match="swap"):
        tw.route_patches_mix_batch(*targs, swap="sideways")


def test_prepare_tryon_grid_batch_matches_jax():
    person, garment = _host_batch(seed=6)
    with jax.disable_jit():
        ref = jds.prepare_tryon_grid_batch(person, garment, swap="full")
    ours = tds.prepare_tryon_grid_batch(person, garment, swap="full", device="cpu")
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), atol=TOL, err_msg=k)
    # the grid route keeps the person where nothing is swapped: "upper" keeps the person's pants
    upper = tds.prepare_tryon_grid_batch(person, garment, swap="upper", device="cpu")
    same = tds.prepare_tryon_grid_batch(person, person, swap="full", device="cpu")
    torch.testing.assert_close(upper["denorm_lower_img"], same["denorm_lower_img"], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["rgb", "rgb_cols", "grey", "unit_range"])
def test_save_image_grid_equals_the_jax_writer(tmp_path, case):
    rng = np.random.default_rng(0)
    n, c, drange, cols = {"rgb": (5, 3, (-1, 1), None), "rgb_cols": (6, 3, (-1, 1), 4),
                          "grey": (3, 1, (-1, 1), None), "unit_range": (4, 3, (0, 1), 2)}[case]
    images = rng.uniform(drange[0] - 0.2, drange[1] + 0.2, (n, 12, 10, c)).astype(np.float32)
    ours = tutils.save_image_grid(images, str(tmp_path / "ours.png"), drange=drange, grid_cols=cols)
    ref = jutils.save_image_grid(images, str(tmp_path / "ref.png"), drange=drange, grid_cols=cols)
    a, b = image_io.read_image(ours), image_io.read_image(ref)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_parsing_to_rgb_equals_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 7, 6)).astype(np.float32)
    labels = rng.integers(0, 25, (2, 9, 7))
    for x in (logits, labels, labels[..., None], labels[0]):
        a, b = tutils.parsing_to_rgb(x), jutils.parsing_to_rgb(x)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tutils.parsing_to_rgb(torch.from_numpy(logits).numpy()),
                                  jutils.parsing_to_rgb(logits))
