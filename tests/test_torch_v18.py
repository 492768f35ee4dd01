"""The released-256 (V18) try-on slice of the port vs the JAX package on the
CPU, the two denorm routes, and the serving CLI's `--generator v18`.

* `route_patches_v19_batch` and `prepare_tryon_batch_v18`, each on the fused
  and the separate denorm route, against the JAX functions (whose CPU path is
  the separate pass): atol 5e-5 on every pixel whose oracle denorm mask value
  lies farther than 1e-5 from 254.5/255 (dilated by the 5x5 erosion for
  parts 0-5); the count of excluded pixels is asserted to be 0 on this
  batch, so every pixel is compared.
* The separate route equals the fused route exactly on the CPU for all three
  port routes (both run the plain versions there; on the card chip_smoke.py
  compares the two kernels' routes).
* `cli.test.main(["--generator", "v18", ...])` on 2 synthetic pairs writes
  the same finite PNGs with either `--denorm`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import geometry as jg
from pasta_gan_tpu.data import warp as jw
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import warp as tw
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.models import GeneratorV18

from test_torch_tryon import _near_threshold, _read_png
from _torch_native import jax_native_oracle  # noqa: F401  (autouse fixture)

TOL = 5e-5
THIN = dict(img_resolution=256, channel_base=512, channel_max=32)


def _host_batch(B=2, seed=1):
    ds = jds.SyntheticUvitonDataset(num_samples=2 * B, seed=seed)
    return jds.collate([ds[i] for i in range(B)]), jds.collate([ds[B + i] for i in range(B)])


def _v19_args(person, garment):
    """The routing arguments `prepare_tryon_batch_v18` builds, as numpy."""
    f = lambda d, k: np.asarray(d[k], np.float32)  # noqa: E731
    g_m, p_m = f(garment, "upper_mask"), f(person, "lower_test_mask")
    return [f(garment, "image") / 255.0 * g_m, g_m, f(garment, "pose") / 255.0,
            f(person, "image") / 255.0 * p_m, p_m, f(person, "pose") / 255.0,
            f(garment, "keypoints"), f(person, "keypoints")]


def _jax_v19_denorm_masks(args):
    """The oracle's denorm mask values [B, 10, H, W]: route_patches_v19_single's
    norm warps, then `denorm_warp_parts`, as the JAX CPU path runs them."""
    g_img, g_m, _, p_img, p_m, _, g_kp, p_kp = (jnp.asarray(a) for a in args)
    L, N = jg.LOWER_PART_START, jg.NUM_PARTS
    kw = dict(img_h=256, patch_w=64, patch_h=64, pad_x=32.0, knee_fallbacks=True)
    Mg, _, vg = jg.part_transforms(g_kp, **kw)
    Mp, Mp_inv, vp = jg.part_transforms(p_kp, **kw)
    warp = jax.vmap(jw.warp_perspective, in_axes=(0, 0, None, None))
    out = []
    for b in range(g_img.shape[0]):
        g_src = jnp.concatenate([g_img[b], g_m[b]], -1)[None].repeat(L, 0)
        p_src = jnp.concatenate([p_img[b], p_m[b]], -1)[None].repeat(N - L, 0)
        M = jnp.concatenate([Mg[b, :L], Mp[b, L:]])
        v = jnp.concatenate([vg[b, :L], vp[b, L:]]).astype(jnp.float32)
        patches = warp(jnp.concatenate([g_src, p_src]), M, (64, 64), "replicate") * v[:, None, None, None]
        out.append(np.asarray(jw.denorm_warp_parts(patches, Mp_inv[b], vp[b], (256, 256))[:, 3]))
    return np.stack(out)


@pytest.fixture(scope="module")
def oracle():
    """One host batch, the JAX routing and batch on it, and the pixels that
    a near-threshold mask value could flip (asserted to be none)."""
    person, garment = _host_batch()
    args = _v19_args(person, garment)
    with jax.disable_jit():  # jit fusion reassociates the coordinate math (~3e-5 on patch values)
        routed = jw.route_patches_v19_batch(*[jnp.asarray(a) for a in args])
        batch = jds.prepare_tryon_batch_v18(person, garment)
        near = _near_threshold(_jax_v19_denorm_masks(args))
    assert int(near.sum()) == 0, "near-threshold pixels on this batch; pick another seed"
    return dict(person=person, garment=garment, args=args,
                routed={k: np.asarray(v) for k, v in routed._asdict().items()},
                batch={k: np.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("denorm", ["fused", "separate"])
def test_route_patches_v19_matches_jax(oracle, denorm):
    ours = tw.route_patches_v19_batch(*[torch.from_numpy(a) for a in oracle["args"]], denorm=denorm)
    assert ours._fields == tuple(oracle["routed"])
    for name, ref in oracle["routed"].items():
        a = getattr(ours, name).numpy()
        assert a.shape == ref.shape, name
        np.testing.assert_allclose(a, ref, atol=TOL, err_msg=name)


@pytest.mark.parametrize("denorm", ["fused", "separate"])
def test_prepare_tryon_batch_v18_matches_jax(oracle, denorm):
    ours = tds.prepare_tryon_batch_v18(oracle["person"], oracle["garment"], device="cpu", denorm=denorm)
    assert sorted(ours) == sorted(oracle["batch"])
    for k, ref in oracle["batch"].items():
        assert tuple(ours[k].shape) == ref.shape, k
        np.testing.assert_allclose(ours[k].numpy(), ref, atol=TOL, err_msg=k)
    assert ours["style_input"].shape[-1] == 60 and ours["pose"].shape[-1] == 6


def _route_args(route):
    person, garment = _host_batch(seed=2)
    t = lambda d, k: torch.as_tensor(d[k]).float()  # noqa: E731
    if route == "v19":
        return tw.route_patches_v19_batch, [torch.from_numpy(a) for a in _v19_args(person, garment)]
    g_m, p_m = t(garment, "upper_mask"), t(person, "lower_test_mask")
    g_img, p_img = t(garment, "image") / 255.0, t(person, "image") / 255.0
    if route == "transfer":
        return tw.route_patches_transfer_batch, [g_img * g_m, p_img * p_m, g_m, p_m, t(garment, "keypoints"),
                                                 t(person, "keypoints")]
    p_u = t(person, "upper_mask")
    return tw.route_patches_batch, [p_img * p_u, p_img * p_m, p_u, p_m, t(person, "keypoints")]


@pytest.mark.parametrize("route", ["transfer", "self", "v19"])
def test_separate_route_equals_fused_route_on_cpu(route):
    fn, args = _route_args(route)
    fused, separate = fn(*args, denorm="fused"), fn(*args, denorm="separate")
    for name in fused._fields:
        torch.testing.assert_close(getattr(separate, name), getattr(fused, name), rtol=0, atol=0, msg=name)
    assert float(fused.denorm_upper_img.abs().sum()) > 0
    with pytest.raises(ValueError, match="denorm"):
        fn(*args, denorm="sideways")


def test_cli_serves_v18_on_cpu_with_either_denorm_route(tmp_path):
    gen = GeneratorV18(**THIN).reset_parameters(torch.Generator().manual_seed(0))
    w_avg = 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1))
    snap = str(tmp_path / "snap.pt")
    save_snapshot(snap, gen.state_dict(), w_avg, {"model": gen.config, "generator": gen.variant})
    pngs = {}
    for denorm in ("fused", "separate"):
        written = cli.main(["--network", snap, "--generator", "v18", "--denorm", denorm, "--synthetic", "2",
                            "--batchsize", "2", "--outdir", str(tmp_path / denorm), "--device", "cpu"])
        assert [os.path.basename(p) for p in written] == ["s0__s1.png", "s1__s0.png"]
        pngs[denorm] = [_read_png(p) for p in written]
        assert all(p.shape == (256, 192, 3) for p in pngs[denorm])
    for a, b in zip(pngs["fused"], pngs["separate"]):
        np.testing.assert_array_equal(a, b)

    loaded, _ = cli.load_generator(snap, "cpu")  # the snapshot's record picks the class
    assert type(loaded) is GeneratorV18
    with pytest.raises(ValueError, match="v18"):
        cli.load_generator(snap, "cpu", generator="full")
