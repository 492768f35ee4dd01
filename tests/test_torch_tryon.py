"""The whole try-on slice of the port vs the JAX package on the CPU, the
serving CLI, and the port's import hygiene.

* One host batch, made once by the JAX package's `SyntheticUvitonDataset`,
  goes through both `prepare_tryon_batch` functions (atol 5e-5 on every pixel
  whose oracle denorm mask value lies farther than 1e-5 from 254.5/255,
  dilated by the 5x5 erosion for parts 0-5; the count of excluded pixels is
  asserted to be 0 on this batch), then each batch through its own
  package's GeneratorFull with the CLI's encode_style / encode_pose / map_ws /
  synthesize sequence: img and pred_parsing rtol 1e-2 / atol 5e-3,
  finetune_img rtol 1e-2 / atol 1e-2.
* The port's copy of the synthetic fixture (masks and stickman) equals the
  JAX package's, run through its default native and cv2 branches, sample for
  sample.
* The port and `chip_smoke.py` import neither JAX, flax, orbax, cv2, PIL nor
  the JAX package, and entry points refuse to run on a missing card unless
  the CPU was asked for.
"""

import ast
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import geometry as jg
from pasta_gan_tpu.data import warp as jw
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu.models import cat_feats_dict as jax_cat_feats_dict
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.cli import calc_metrics as cli_calc_metrics
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.metrics import SimpleConvFeatures
from pasta_gan_tpu_torch.models import GeneratorFull, cat_feats_dict

from test_torch_generator import _jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-5
NEAR = 1e-5
THIN = dict(img_resolution=256, channel_base=512, channel_max=32)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "cv2", "PIL", "pasta_gan_tpu")


def _host_batch(B=2):
    ds = jds.SyntheticUvitonDataset(num_samples=2 * B, seed=1)
    person = jds.collate([ds[i] for i in range(B)])
    garment = jds.collate([ds[B + i] for i in range(B)])
    return person, garment


def _jax_denorm_masks(person, garment):
    """The oracle's denorm mask values [B, 14, H, W]: route_patches_single's
    norm warps then `denorm_warp_parts`, per sample, as the JAX CPU path runs."""
    f = lambda d, k: jnp.asarray(d[k], jnp.float32)  # noqa: E731
    L = jg.LOWER_PART_START
    g_m, p_m = f(garment, "upper_mask"), f(person, "lower_test_mask")
    g_img, p_img = f(garment, "image") / 255.0 * g_m, f(person, "image") / 255.0 * p_m
    kw = dict(img_h=256, patch_w=64, patch_h=64, pad_x=32.0, knee_fallbacks=True)
    Mg, _, vg = jg.part_transforms(f(garment, "keypoints"), **kw)
    Mp, Mp_inv, vp = jg.part_transforms(f(person, "keypoints"), **kw)
    out = []
    for b in range(g_img.shape[0]):
        wu = jw._warp_parts(jnp.concatenate([g_img[b], g_m[b]], -1), Mg[b], (64, 64), "replicate", planar=True)
        wl = jw._warp_parts(jnp.concatenate([p_img[b], p_m[b]], -1), Mp[b, L:], (64, 64), "replicate", planar=True)
        srcs = jnp.concatenate([wu * vg[b][:, None, None, None], wl * vp[b, L:][:, None, None, None]])
        dn = jw.denorm_warp_parts(srcs, jnp.concatenate([Mp_inv[b], Mp_inv[b, L:]]),
                                  jnp.concatenate([vp[b], vp[b, L:]]), (256, 256), planar_in=True)
        out.append(np.asarray(dn[:, 3]))
    return np.stack(out)


def _near_threshold(masks):
    """[B, H, W] bool: pixels a near-threshold oracle mask value can reach."""
    near = torch.from_numpy((np.abs(masks - jw.MASK_SATURATION_THRESHOLD) <= NEAR).astype(np.float32))
    ero = list(range(jg.LOWER_PART_START))
    near[:, ero] = torch.nn.functional.max_pool2d(near[:, ero], 5, stride=1, padding=2)
    return (near.amax(1) > 0).numpy()


def _jax_tryon_forward(jgen, variables, batch, w_avg, psi):
    """pasta_gan_tpu/cli/test.py:forward_impl, returning all three outputs."""
    stylecode, feats = jgen.apply(variables, batch["style_input"], batch["retain"], method=jgen.encode_style)
    pose_feat = jgen.apply(variables, batch["pose"], method=jgen.encode_pose)
    ws, _ = jgen.apply(variables, None, stylecode, w_avg=w_avg, truncation_psi=psi, method=jgen.map_ws)
    return jgen.apply(variables, ws, pose_feat, jax_cat_feats_dict(feats), batch["denorm_upper_img"],
                      batch["denorm_lower_img"], batch["denorm_upper_mask"], batch["denorm_lower_mask"],
                      method=jgen.synthesize, noise_mode="none")


def test_synthetic_fixture_matches_jax():
    """Against the JAX package's default drawing branches: the native host
    library's polygon fill and dilation, and cv2.line for the limbs."""
    from pasta_gan_tpu import native
    from pasta_gan_tpu.data import stickman

    assert native.available(), "the JAX package's native host library did not build: no oracle for the masks"
    assert stickman._HAS_CV2, "cv2 is missing: no oracle for the stickman's limbs"
    ours, ref = tds.SyntheticUvitonDataset(num_samples=3, seed=2), jds.SyntheticUvitonDataset(num_samples=3, seed=2)
    for i in range(3):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_tryon_slice_matches_jax():
    person, garment = _host_batch()
    with jax.disable_jit():  # jit fusion reassociates the coordinate math (~3e-5 on patch values)
        ref = {k: np.asarray(v) for k, v in jds.prepare_tryon_batch(person, garment).items()}
        masks = _jax_denorm_masks(person, garment)
    ours = tds.prepare_tryon_batch(person, garment, device="cpu")
    near = _near_threshold(masks)
    assert int(near.sum()) == 0, "near-threshold pixels on this batch; pick another seed"
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_allclose(ours[k].numpy(), v, atol=TOL, err_msg=k)

    jgen = JaxGeneratorFull(**THIN)
    variables = _jax_variables(jgen, _gen_shapes(), seed=5)
    w_avg = np.random.default_rng(6).standard_normal(512).astype(np.float32) * 0.1
    outs_ref = jax.jit(lambda v, b: _jax_tryon_forward(jgen, v, b, jnp.asarray(w_avg), 0.7))(
        variables, {k: jnp.asarray(v) for k, v in ref.items()})
    port = GeneratorFull(**THIN)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()), strict=True)
    with torch.no_grad():
        port.eval()
        stylecode, feats = port.encode_style(ours["style_input"], ours["retain"])
        ws, _ = port.map_ws(None, stylecode, w_avg=torch.from_numpy(w_avg), truncation_psi=0.7)
        outs = port.synthesize(ws, port.encode_pose(ours["pose"]), cat_feats_dict(feats),
                               ours["denorm_upper_img"], ours["denorm_lower_img"], ours["denorm_upper_mask"],
                               ours["denorm_lower_mask"], noise_mode="none")
        served = cli.tryon_forward(port, torch.from_numpy(w_avg), ours, truncation_psi=0.7)
    torch.testing.assert_close(served, outs[1], rtol=0, atol=0)
    for name, a, b, atol in zip(("img", "finetune_img", "pred_parsing"), outs, outs_ref, (5e-3, 1e-2, 5e-3)):
        assert tuple(a.shape) == tuple(b.shape), name
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2, atol=atol, err_msg=name)


def _gen_shapes():
    """Zero inputs of the generator's NHWC shapes, for tracing its variables."""
    R = THIN["img_resolution"]
    z = lambda *s: np.zeros((1,) + s, np.float32)  # noqa: E731
    return dict(c=z(R // 4, R // 4, 42), retain=z(R, R, 3), pose=z(R, R, 6), denorm_upper_input=z(R, R, 3),
                denorm_lower_input=z(R, R, 3), denorm_upper_mask=z(R, R, 1), denorm_lower_mask=z(R, R, 1))


def _read_png(path):
    """Decode an 8-bit RGB PNG without filters (what `save_image` writes)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0] == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_cli_serves_synthetic_pairs_on_cpu(tmp_path):
    gen = GeneratorFull(**THIN).reset_parameters(torch.Generator().manual_seed(0))
    w_avg = 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1))
    snap = str(tmp_path / "snap.pt")
    save_snapshot(snap, gen.state_dict(), w_avg, {"model": gen.config})
    written = cli.main(["--network", snap, "--synthetic", "3", "--batchsize", "2",
                        "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["s0__s1.png", "s1__s2.png", "s2__s0.png"]

    ds = tds.SyntheticUvitonDataset(num_samples=3)
    batch = tds.prepare_tryon_batch(tds.collate([ds[2]]), tds.collate([ds[0]]), device="cpu")
    with torch.no_grad():
        img = cli.tryon_forward(gen.eval(), w_avg, batch)[0, :, 32:224].numpy()
    png = _read_png(written[2])
    assert png.shape == (256, 192, 3)
    expect = np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert int(np.abs(png.astype(np.int32) - expect).max()) <= 1  # batch 2 vs batch 1 rounding


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_cv2_pil_or_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pasta_gan_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    later_slices = {f"pasta_gan_tpu_torch/{m}.py" for m in (
        "ops/cuda_kernels", "ops/upfirdn_kernels", "nn/discriminator", "runtime/config", "train/losses",
        "train/vgg", "train/state", "train/step", "train/loop", "cli/train", "models/generator_v18",
        "train/augment", "ops/shear_warp", "models/generator_512", "cli/test_512", "utils/__init__",
        "metrics/__init__", "metrics/formulas", "metrics/feature_stats", "metrics/detectors_manifest",
        "metrics/inception", "metrics/vgg16", "metrics/extractors", "metrics/ppl", "metrics/metric_main",
        "cli/calc_metrics", "nn/flow", "models/generator_v1", "nn/patch_discriminator", "data/host_router",
        "cli/dataset_tool", "cli/draw_point")}
    assert later_slices <= rel, sorted(later_slices - rel)
    bad = [(os.path.relpath(f, REPO), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    person, garment = _host_batch(1)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_batch(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.tryon_warp_inputs(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_batch_v18(person, garment, denorm="separate")
    with pytest.raises(RuntimeError, match="cuda"):
        tds.tryon_warp_inputs_v18(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--network", str(tmp_path / "missing.pt"), "--synthetic", "1", "--outdir", str(tmp_path)])
    gen = GeneratorFull(**THIN)
    save_snapshot(str(tmp_path / "snap.pt"), gen.state_dict(), torch.zeros(512), {"model": gen.config})
    with pytest.raises(RuntimeError, match="cuda"):
        cli.load_generator(str(tmp_path / "snap.pt"))
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_train_batch(person)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--outdir", str(tmp_path / "runs"), "--synthetic", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_calc_metrics.main(["--network", str(tmp_path / "snap.pt"), "--synthetic", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        SimpleConvFeatures()
