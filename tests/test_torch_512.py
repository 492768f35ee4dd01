"""The 512x320 region-selectable try-on slice of the port vs the JAX package on the CPU.

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
* `Generator512` against the JAX `Generator512` at thin widths
  (img_resolution 256, channel_base 2048, channel_max 64), the JAX side run
  with `pack_tail` on and off: (img, pred_parsing) rtol 1e-2 / atol 5e-3,
  finetune_img rtol 1e-2 / atol 1e-2 (tests/test_torch_generator_v18.py's
  tolerances); at full width the port's state_dict goes back through the
  JAX package's `convert_generator_full` to every JAX leaf, bit for bit.
* `cli.test_512` at a thin width on the fixture: triptych shapes, finite
  values, the result panel equal to a direct forward, and the `--quant` /
  `--dp` refusals; its nearest resize equals `jax.image.resize`.
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
from pasta_gan_tpu.io.torch_import import convert_generator_full
from pasta_gan_tpu.models import Generator512 as JaxGenerator512
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.cli import test_512 as cli512
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import warp as tw
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models import Generator512, GeneratorFull
from pasta_gan_tpu_torch.ops import warp_kernels as wk

from test_torch_generator import KEYS, _inputs, _jax_variables
from test_torch_tryon import _read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "upt_mini")
TOL = 5e-5
NEAR = 1e-5
REGIONS = ("fullbody", "upperbody", "lowerbody")
THIN = dict(img_resolution=256, channel_base=2048, channel_max=64)


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


# ---------------------------------------------------------------- Generator512


def _inputs_512(seed, N=1, R=256):
    inp = _inputs(seed=seed, N=N, R=R)
    inp["c"] = np.random.default_rng(seed + 100).standard_normal((N, R // 4, R // 4, 45)).astype(np.float32) * 0.5
    return inp


def _port_from_jax(variables, **cfg):
    gen = Generator512(**cfg)
    gen.load_state_dict(state_dict_from_jax(variables, gen.state_dict()), strict=True)
    return gen.eval()


def test_state_dict_round_trip_full_width():
    cfg = dict(img_resolution=512)
    inp = _inputs_512(0, R=512)
    v = _jax_variables(JaxGenerator512(**cfg), inp)
    port = _port_from_jax(v, **cfg)
    sd = port.state_dict()
    assert tuple(sd["synthesis.b8.const"].shape) == (512, 8, 8) and "synthesis.b4.const" not in sd
    assert tuple(sd["style_encoding.model.0.weight"].shape)[1] == 45 and "style_encoding.model.7.weight" not in sd
    assert "const_encoding.model.6.weight" in sd and "synthesis.b32.merge_conv.weight" not in sd
    assert port.num_ws == 2 * 7 - 1 + 1  # blocks 8 ... 512, one w for the first, plus the last ToRGB's
    back = convert_generator_full({k: t.numpy() for k, t in sd.items()}, v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(sd)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("pack_tail", [True, False])
def test_forward_matches_jax(pack_tail):
    jgen = JaxGenerator512(pack_tail=pack_tail, **THIN)
    inp = _inputs_512(seed=1)
    v = _jax_variables(jgen, inp, seed=2)
    ref = jax.jit(lambda v, x: jgen.apply(v, None, **x, noise_mode="none"))(
        v, {k: jnp.asarray(a) for k, a in inp.items()})
    port = _port_from_jax(v, **THIN)
    with torch.no_grad():
        ours = port(None, *[torch.from_numpy(inp[k]) for k in KEYS], noise_mode="none")
    assert len(ours) == len(ref) == 3
    for name, a, b, atol in zip(("img", "finetune_img", "pred_parsing"), ours, ref, (5e-3, 1e-2, 5e-3)):
        assert tuple(a.shape) == tuple(b.shape), name
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2, atol=atol, err_msg=name)


# ------------------------------------------------------------------- cli.test_512


def _snapshot(tmp_path, **cfg):
    gen = Generator512(**cfg).reset_parameters(torch.Generator().manual_seed(0))
    snap = str(tmp_path / "snap512.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1)),
                  {"model": gen.config, "generator": gen.variant})
    return snap


def test_cli_test_512_serves_the_fixture_on_cpu(tmp_path):
    snap = _snapshot(tmp_path, img_resolution=512, channel_base=1024, channel_max=16)
    # the fixture's 512 records with a pair list of its own (the encoders' 64 channels at 512x512 are slow here)
    root, ds = tmp_path / "upt", "UPT_subset1_512_320"
    os.makedirs(root / ds)
    for sub in ("image", "keypoints", "parsing"):
        os.symlink(os.path.join(FIXTURE, ds, sub), root / ds / sub)
    (root / ds / "test_pairs_front_list_shuffle_0508.txt").write_text(
        "upt512_0003.jpg upt512_0002.jpg\nupt512_0001.jpg upt512_0003.jpg\n")
    written = cli512.main(["--network", snap, "--dataroot", str(root), "--change_region", "upperbody",
                           "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["upt512_0003__upt512_0002.png", "upt512_0001__upt512_0003.png"]
    pngs = [_read_png(p) for p in written]
    assert all(p.shape == (512, 3 * 320, 3) for p in pngs)

    gen, w_avg = cli.load_generator(snap, "cpu")
    assert type(gen) is Generator512
    r = tds.UvitonDataset512Test(str(root), "upperbody")[1]
    batch = tds.prepare_tryon_batch_512(tds.collate([r["person"]]), tds.collate([r["garment"]]),
                                        change_region="upperbody", device="cpu")
    out = cli.tryon_forward(gen, w_avg, batch)
    assert bool(torch.isfinite(out).all())
    expect = np.clip((out[0, :, 96:416].numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert int(np.abs(pngs[1][:, 640:].astype(np.int32) - expect).max()) <= 1  # batch 2 vs batch 1 rounding
    assert int(np.abs(pngs[1][:, :320].astype(np.int32) - r["garment"]["image"][:, 96:416]).max()) <= 1
    person_panel = np.clip((batch["person_img"][0, :, 96:416].numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(pngs[1][:, 320:640], person_panel)

    with pytest.raises(SystemExit, match="cli.test_512"):  # the 256 CLI refuses a 512 snapshot
        cli.main(["--network", snap, "--synthetic", "1", "--outdir", str(tmp_path), "--device", "cpu"])


def test_cli_test_512_refusals_and_resize(tmp_path, monkeypatch, capsys):
    snap = _snapshot(tmp_path, **THIN)
    base = ["--network", snap, "--synthetic", "2", "--outdir", str(tmp_path / "out"), "--device", "cpu"]
    # int8 serving: calibrated on the one batch of a synthetic pair, then served
    written = cli512.main(["--network", snap, "--synthetic", "1", "--outdir", str(tmp_path / "int8"),
                           "--device", "cpu", "--quant", "int8_static"])
    assert len(written) == 1 and _read_png(written[0]).shape == (256, 3 * 160, 3)
    assert "calibrated int8 activation scales on 1 batches" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="§A 11"):
        cli512.main(base + ["--dp"])
    full = GeneratorFull(img_resolution=256, channel_base=512, channel_max=32)
    save_snapshot(str(tmp_path / "full.pt"), full.state_dict(), torch.zeros(512), {"model": full.config})
    with pytest.raises(ValueError, match="512"):
        cli512.main(["--network", str(tmp_path / "full.pt")] + base[2:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the entry points default to the card
    person, garment = _pair(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_batch_512(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_grid_batch(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        cli512.main(base[:-2])
    monkeypatch.undo()
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
    for size in ((16, 16), (4, 4), (10, 7)):
        np.testing.assert_array_equal(cli512.resize_nearest(torch.from_numpy(x), size).numpy(),
                                      np.asarray(jax.image.resize(x, (2, *size, 3), "nearest")))
