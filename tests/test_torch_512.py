"""The 512x320 region-selectable try-on slice's routing and dataset of the port
vs the JAX package on the CPU (Generator512: tests/test_torch_512_model.py;
`cli.test_512`: tests/test_torch_512_cli.py).

* `route_patches_512_batch` for each `change_region` at B = 1 on a 512x512
  frame of the committed fixture (a pair with two invalid person parts), and
  `prepare_tryon_batch_512` on another pair, against the JAX functions run
  op by op (`jax.disable_jit`: jit fusion reassociates the coordinate math by
  up to 5.3e-5 on patch values here): atol 5e-5, tests/test_torch_routing.py's
  routing tolerance, on every pixel; the pixels whose plain denorm mask value
  lies within 1e-5 of 254.5/255 are asserted to be none on these pairs.
* The separate denorm route equals the fused one exactly on the CPU.
* `UvitonDataset512Test` items equal the JAX dataset's, and the port's
  `load_sample(..., size=(512, 320))` equals MANIFEST.json's digests of the
  JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import warp as jw
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import warp as tw
from pasta_gan_tpu_torch.ops import warp_kernels as wk

from _torch_native import jax_native_oracle  # noqa: F401  (autouse fixture)
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "upt_mini")
TOL = 5e-5
NEAR = 1e-5
REGIONS = ("fullbody", "upperbody", "lowerbody")


def _pair(i):
    r = jds.UvitonDataset512Test(FIXTURE)[i]
    return jds.collate([r["person"]]), jds.collate([r["garment"]])


def _route_args(person, garment):
    """The routing arguments `prepare_tryon_batch_512` builds, as numpy."""
    f = lambda d, k: np.asarray(d[k], np.float32)  # noqa: E731
    args = []
    for d in (person, garment):
        img, up, lo = f(d, "image") / 255.0, f(d, "upper_mask"), f(d, "lower_mask")
        args += [img * up, img * lo, up, lo]
    return args + [f(person, "keypoints"), f(garment, "keypoints")]


def _near_pixels(r):
    """Pixels a near-threshold plain denorm mask value could flip (eroded
    parts: dilated by the 5x5 erosion), from a route's operands `r`."""
    patches = wk.norm_warp_reference(r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"],
                                     r["patch_hw"])
    m = wk.denorm_warp_reference(patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"])[:, :, 3]
    near = ((m - wk.MASK_SATURATION_THRESHOLD).abs() <= NEAR).float()
    near = torch.nn.functional.max_pool2d(near, 5, stride=1, padding=2)  # every 512 mask is eroded
    return int((near.amax(1) > 0).sum())


@pytest.mark.parametrize("region", REGIONS)
def test_route_patches_512_matches_jax(region):
    args = _route_args(*_pair(1))
    targs = [torch.from_numpy(a) for a in args]
    r = tw.warp_inputs_512(*targs, change_region=region)
    assert r["valid_denorm"].shape == (1, 15) and int(r["valid_denorm"].sum()) == 13  # two invalid parts
    assert r["n_upper"] == 10 and r["hand_parts"] == () and all(r["erode_parts"])
    assert _near_pixels(r) == 0, "near-threshold pixels on this pair; pick another"
    with jax.disable_jit():
        ref = jw.route_patches_512_batch(*[jnp.asarray(a) for a in args], change_region=region, pad_x=96.0)
    ours = tw.route_patches_512_batch(*targs, change_region=region)
    assert ours._fields == ref._fields
    for name in ours._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=name)
    assert ours.norm_img.shape == (1, 128, 128, 30) and ours.norm_img_lower.shape == (1, 128, 128, 15)
    assert float(ours.denorm_lower_img.abs().sum()) > 0


@pytest.mark.parametrize("region", REGIONS)
def test_separate_route_equals_fused_route_on_cpu(region):
    targs = [torch.from_numpy(a) for a in _route_args(*_pair(4))]
    fused = tw.route_patches_512_batch(*targs, change_region=region, denorm="fused")
    separate = tw.route_patches_512_batch(*targs, change_region=region, denorm="separate")
    for name in fused._fields:
        torch.testing.assert_close(getattr(separate, name), getattr(fused, name), rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError, match="change_region"):
        tw.route_patches_512_batch(*targs, change_region="headonly")


def test_prepare_tryon_batch_512_matches_jax():
    person, garment = _pair(2)
    r = tds.warp_inputs_512_batch(person, garment, "lowerbody", device="cpu")
    assert _near_pixels(r) == 0, "near-threshold pixels on this pair; pick another"
    with jax.disable_jit():
        ref = jds.prepare_tryon_batch_512(person, garment, change_region="lowerbody", pad_x=96.0)
    ours = tds.prepare_tryon_batch_512(person, garment, change_region="lowerbody", device="cpu")
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), atol=TOL, err_msg=k)
    assert ours["style_input"].shape == (1, 128, 128, 45) and ours["pose"].shape == (1, 512, 512, 6)


def test_dataset_512_equals_jax_and_the_manifest():
    ours, ref = tds.UvitonDataset512Test(FIXTURE, "upperbody"), jds.UvitonDataset512Test(FIXTURE, "upperbody")
    assert len(ours) == len(ref) == 8
    for i in (0, 5):
        a, b = ours[i], ref[i]
        assert {k: a[k] for k in ("person_name", "garment_name", "change_region")} == \
            {k: b[k] for k in ("person_name", "garment_name", "change_region")}
        for side in ("person", "garment"):
            assert sorted(a[side]) == sorted(b[side])
            for k in b[side]:
                np.testing.assert_array_equal(a[side][k], b[side][k], err_msg=f"{i} {side} {k}")
    assert a["person"]["image"].shape == (512, 512, 3) and int(a["person"]["left_padding"]) == 96
    assert len(tds.UvitonDataset512Test(FIXTURE, max_size=3)) == 3
    with pytest.raises(ValueError, match="change_region"):
        tds.UvitonDataset512Test(FIXTURE, "headonly")
    with pytest.raises(IOError):
        tds.UvitonDataset512Test(os.path.join(FIXTURE, "Zalando_256_192"))

    from test_torch_dataset_real import _fixture_script

    digest = _fixture_script().digest
    man = json.load(open(os.path.join(FIXTURE, "MANIFEST.json")))["records_512"]
    assert len(man) == 4
    for key, want in man.items():
        ds, person = key.split("/")
        sample = tds.load_sample(*tds.record_paths(FIXTURE, ds, person), size=(512, 320))
        assert {k: digest(v) for k, v in sample.items()} == want, key
