"""The port's host routing (pasta_gan_tpu_torch/data/host_router.py and its
warp, csrc/host_ops.cpp) against the JAX package's host route and its
native library, and against the port's own device route's plain path, on
the CPU.

* The warp against `pasta_gan_tpu.native.warp_perspective` at both borders,
  bit for bit: the same source built with the same flags.
* `route_patches_host_single` on JAX's M, M_inv and validity, with and
  without the erosion: every field equal to JAX's exactly.
* `route_patches_host_batch` / `route_patches_host_transfer_batch` against
  JAX's host route and against the port's device route run on CPU tensors
  (`data/warp.py`, the kernels' plain versions), by the JAX test's criterion
  (`tests/test_host_router.py:_compare`): >= 99.5 % of the values within
  rtol 1e-3 / atol 2e-3 and a mean |difference| < 2e-3.  The port's solve
  of M differs from JAX's in the last bits, so these are not exact.
* `HostRoutingPipeline`: order, the prefetcher working ahead of a slow
  consumer, an error raised on the consumer's side, `close()`.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pasta_gan_tpu import native
from pasta_gan_tpu.data import host_router as jhr
from pasta_gan_tpu_torch.data import host_router as hr
from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate
from pasta_gan_tpu_torch.data.warp import route_patches_batch, route_patches_transfer_batch

from test_host_router import _keypoints, _mask_blob

KEYS = ("norm_img", "norm_img_lower", "denorm_upper_img", "denorm_lower_img", "norm_clothes_masks")
B, H, W = 2, 128, 128


def compare(a_fields, b_fields, keys=KEYS):
    """The JAX host-route test's criterion."""
    for k in keys:
        a, b = np.asarray(a_fields[k], np.float32), np.asarray(b_fields[k], np.float32)
        frac = float(np.mean(np.isclose(a, b, rtol=1e-3, atol=2e-3)))
        mean = float(np.mean(np.abs(a - b)))
        print(f"  {k}: {frac:.5f} close, mean |difference| {mean:.3g}")
        assert frac >= 0.995, (k, frac)
        assert mean < 2e-3, (k, mean)


@pytest.mark.parametrize("border", ["constant", "replicate"])
def test_host_warp_equals_the_jax_native_warp(border):
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 1, (37, 53, 4)).astype(np.float32)
    for M in (np.array([[1.1, 0.1, -3.0], [0.05, 0.9, 2.0], [1e-4, 2e-4, 1.0]]),  # perspective, some samples outside
              np.array([[0.25, 0.0, 0.0], [0.0, 0.25, 0.0], [0.0, 0.0, 1.0]]),  # a 4x shrink (a norm warp)
              np.eye(3) * 2.0, np.zeros((3, 3))):  # uniform scale; singular (det clamped)
        for out_hw in ((64, 70), (200, 130)):  # one row task, and the row-threaded split
            a = native.warp_perspective(src, M, out_hw, border)
            b = hr.warp_perspective(src, M, out_hw, border)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="border"):
        hr.warp_perspective(src, np.eye(3), (4, 4), "reflect")


def _batch(seed, transfer=False):
    rng = np.random.default_rng(seed)
    kps = _keypoints(rng, B, H, W)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    um = _mask_blob(rng, B, H, W, H // 4, H // 2)
    lm = _mask_blob(rng, B, H, W, H // 2, 3 * H // 4)
    if not transfer:
        return img * um, img * lm, um, lm, kps
    img2 = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    return img * um, img2 * lm, um, lm, _keypoints(rng, B, H, W), kps


@pytest.mark.parametrize("erode_upper", [False, True])
def test_route_single_on_jax_geometry_is_exact(erode_upper):
    up, lo, um, lm, kps = _batch(1)
    M, M_inv, valid = jhr.part_transforms_np(kps, H, W >> 2, H >> 2)
    for i in range(B):
        args = (up[i], lo[i], um[i], lm[i], M[i], M_inv[i], valid[i])
        a = jhr.route_patches_host_single(*args, erode_upper=erode_upper)
        b = hr.route_patches_host_single(*args, erode_upper=erode_upper)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert float(a["denorm_upper_img"].sum()) > 0


def test_part_transforms_np_is_the_port_geometry():
    kps = _batch(2)[-1]
    M, M_inv, valid = hr.part_transforms_np(kps, H, W >> 2, H >> 2)
    Mj, M_invj, validj = jhr.part_transforms_np(kps, H, W >> 2, H >> 2)
    np.testing.assert_array_equal(valid, validj)
    np.testing.assert_allclose(M, Mj, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(M_inv, M_invj, rtol=1e-4, atol=1e-5)


def test_host_batch_matches_jax_host_and_the_device_route():
    up, lo, um, lm, kps = _batch(0)
    host = hr.route_patches_host_batch(up, lo, um, lm, kps, workers=2)
    print("host vs JAX host:")
    compare(host, jhr.route_patches_host_batch(up, lo, um, lm, kps, workers=2))
    dev = route_patches_batch(*[torch.from_numpy(a) for a in (up, lo, um, lm, kps)])
    print("host vs the port's device route (plain path):")
    compare(host, {k: getattr(dev, k).numpy() for k in KEYS})
    np.testing.assert_array_equal(host["valid"], dev.valid.numpy())
    assert float(host["denorm_upper_img"].sum()) > 0


def test_host_transfer_batch_matches_jax_host_and_the_device_route():
    g_up, p_lo, g_m, p_m, kps_g, kps_p = _batch(1, transfer=True)
    host = hr.route_patches_host_transfer_batch(g_up, p_lo, g_m, p_m, kps_g, kps_p, workers=2)
    print("host vs JAX host:")
    compare(host, jhr.route_patches_host_transfer_batch(g_up, p_lo, g_m, p_m, kps_g, kps_p, workers=2))
    dev = route_patches_transfer_batch(*[torch.from_numpy(a) for a in (g_up, p_lo, g_m, p_m, kps_g, kps_p)])
    print("host vs the port's device route (plain path):")
    compare(host, {k: getattr(dev, k).numpy() for k in KEYS + ("denorm_hand_masks",)},
            KEYS + ("denorm_hand_masks",))


def test_pipeline_keeps_order_and_routes_ahead():
    ds = SyntheticUvitonDataset(num_samples=8, resolution=64, seed=7)
    batches = [collate([ds[i], ds[i + 1]]) for i in range(0, 8, 2)]
    routed_at = []
    route = hr.training_route_fn(box_factor=2)

    def timed_route(hb, pool):
        out = route(hb, pool)
        routed_at.append(time.perf_counter())
        return out

    pipe = hr.HostRoutingPipeline(iter(batches), timed_route, depth=2, workers=2)
    seen, ahead = [], []
    for item in pipe:
        if not seen:  # a slow consumer of batch 0: the prefetcher routes batch 1 meanwhile
            deadline = time.perf_counter() + 30.0
            while len(routed_at) < 2 and time.perf_counter() < deadline:
                time.sleep(0.01)
            ahead.append(len(routed_at))
        seen.append(item)
    assert len(seen) == 4
    assert ahead[0] >= 2, "batch 1 was not routed while batch 0 was held"
    for got, want in zip(seen, batches):
        np.testing.assert_array_equal(got["host_batch"]["image"], want["image"])
        ref = hr.route_patches_host_batch(*[np.asarray(a, np.float32) for a in (
            want["image"] / 255.0 * want["upper_mask"], want["image"] / 255.0 * want["lower_mask"],
            want["upper_mask"], want["lower_mask"], want["keypoints"])])
        for k in KEYS:
            np.testing.assert_array_equal(got["routed"][k], ref[k])


def test_pipeline_surfaces_errors_after_the_good_batches():
    ds = SyntheticUvitonDataset(num_samples=2, resolution=64, seed=3)
    good = collate([ds[0], ds[1]])

    def loader():
        yield good
        yield {"image": np.zeros((2, 64, 64, 3), np.uint8)}  # no masks, no keypoints

    pipe = hr.HostRoutingPipeline(loader(), hr.training_route_fn(), depth=1, workers=1)
    assert next(pipe)["host_batch"] is good
    with pytest.raises(KeyError):
        next(pipe)


def test_pipeline_close_stops_the_prefetcher():
    started = threading.Event()

    def endless():
        while True:
            started.set()
            yield {}

    pipe = hr.HostRoutingPipeline(endless(), lambda hb, pool: hb, depth=1, workers=1)
    assert started.wait(5.0)
    next(pipe)
    pipe.close()
    pipe._thread.join(timeout=5.0)
    assert not pipe._thread.is_alive()
