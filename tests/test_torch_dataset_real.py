"""The port's real-data host path against the JAX package on the CPU.

* The limb rasterizer equals `cv2.line(img, p0, p1, color, 2)` (hypothesis:
  random endpoints, inside the frame, outside it and equal), the stickman
  equals the JAX package's (its cv2 branch), and `_fill_polygon` and
  `_dilate` equal `pasta_gan_tpu.native`, bit for bit.  The port's
  `build_sample_masks` takes at most 3x the JAX native branch's time on the
  same sample (medians of interleaved runs on this CPU).
* On the committed fixture tree `tests/fixtures/upt_mini` (written by
  `scripts/make_upt_fixture.py`): `load_sample` equals the JAX package's on
  every record, key for key and bit for bit; `UvitonDatasetFull` and
  `UvitonDataset256Test` equal the JAX datasets' `__getitem__`;
  MANIFEST.json equals what PIL and the JAX package give now, and the port's
  decoders and `load_sample` match its digests.
* `InfiniteLoader` with 3 worker processes emits the JAX loader's first 4
  batches; a worker's failure reaches `__next__`; `close()` stops the workers.
* One real test batch through both `prepare_tryon_batch` and a thin
  GeneratorFull, at `test_tryon_slice_matches_jax`'s tolerances.
* `cli.test --dataroot` (Full, and V18 on the separate denorm route) writes
  JAX-named PNGs; `cli.train --data` runs at a thin width and saves a
  snapshot inside the run and one at its end.
"""

import importlib.util
import json
import os
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from pasta_gan_tpu import native
from pasta_gan_tpu.data import dataset as jds
from pasta_gan_tpu.data import masks as jmasks
from pasta_gan_tpu.data import stickman as jstickman
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu.train.loop import InfiniteLoader as JaxInfiniteLoader
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import image_io
from pasta_gan_tpu_torch.data import masks as tmasks
from pasta_gan_tpu_torch.data import stickman as tstickman
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.models import GeneratorFull, GeneratorV18
from pasta_gan_tpu_torch.train.loop import InfiniteLoader

from test_torch_generator import _jax_variables
from test_torch_tryon import THIN, TOL, _gen_shapes, _jax_denorm_masks, _jax_tryon_forward, _near_threshold, _read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "upt_mini")


@pytest.fixture(scope="module", autouse=True)
def oracles():
    assert native.available(), "the JAX package's native host library did not build: no oracle for the masks"
    assert jstickman._HAS_CV2, "cv2 is missing: no oracle for the stickman's limbs"


def _assert_samples_equal(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


# ------------------------------------------------------------------ drawing


@settings(max_examples=300, deadline=None)
@given(p=st.lists(st.one_of(st.integers(-3000, 3000), st.integers(-40, 300), st.integers(0, 191)),
                  min_size=4, max_size=4),
       same=st.booleans(), color=st.sampled_from(jstickman.KPT_COLORS))
@example(p=[40, 123, -6, 203], same=False, color=[255, 0, 0])  # cv2 plots an edge's end after ordering its points
def test_limb_rasterizer_equals_cv2_line(p, same, color):
    p0, p1 = (p[0], p[1]), ((p[0], p[1]) if same else (p[2], p[3]))
    ref = np.zeros((256, 192, 3), np.uint8)
    cv2.line(ref, p0, p1, color, 2)
    ours = np.zeros_like(ref)
    tstickman._draw_limb(ours, p0, p1, color)
    np.testing.assert_array_equal(ours, ref)


def test_stickman_equals_jax_cv2_branch():
    rng = np.random.default_rng(0)
    for _ in range(40):
        k = np.zeros((18, 3), np.float32)
        k[:, 0], k[:, 1], k[:, 2] = rng.uniform(-20, 212, 18), rng.uniform(-20, 276, 18), rng.uniform(0, 1, 18)
        np.testing.assert_array_equal(tstickman.draw_pose_from_cords(k, (256, 192)),
                                      jstickman.draw_pose_from_cords(k, (256, 192)))


@settings(max_examples=150, deadline=None)
@given(pts=st.lists(st.tuples(st.floats(-60, 320, width=32), st.floats(-60, 320, width=32)), min_size=3, max_size=6))
def test_fill_polygon_equals_native(pts):
    pts = np.asarray(pts, np.float32)
    np.testing.assert_array_equal(tmasks._fill_polygon(pts, 256, 256),
                                  native.fill_polygon(pts.astype(np.float64), 256, 256)[..., None])


@pytest.mark.parametrize("ksize", [1, 2, 3, 16, 25])
def test_dilate_equals_native(ksize):
    rng = np.random.default_rng(ksize)
    m = (rng.random((256, 256, 1)) > 0.997).astype(np.float32) * 255.0
    m[0, 0], m[-1, -1], m[100, -1] = 255.0, 255.0, 7.0
    np.testing.assert_array_equal(tmasks._dilate(m, ksize), native.dilate_box(m, ksize))


def test_masks_equal_and_within_3x_of_the_native_branch():
    _, kpt_path, parsing_path = tds.record_paths(FIXTURE, "Zalando_256_192", "000010_0.jpg")
    parsing, left = tds.pad_to_square(image_io.read_image(parsing_path), 0)
    kps = jstickman.load_keypoints(kpt_path)
    kps[:, 0] += left
    _assert_samples_equal(tmasks.build_sample_masks(kps, parsing), jmasks.build_sample_masks(kps, parsing))
    times = {"port": [], "jax": []}
    for _ in range(7):
        for name, fn in (("port", tmasks.build_sample_masks), ("jax", jmasks.build_sample_masks)):
            t0 = time.perf_counter()
            fn(kps, parsing)
            times[name].append(time.perf_counter() - t0)
    port, ref = float(np.median(times["port"])), float(np.median(times["jax"]))
    print(f"build_sample_masks on this CPU: port {port * 1e3:.2f} ms, JAX native branch {ref * 1e3:.2f} ms")
    assert port <= 3 * ref, (port, ref)


# ------------------------------------------------------------------ the fixture tree


def _records():
    man = json.load(open(os.path.join(FIXTURE, "MANIFEST.json")))
    out = []
    for key in sorted(man["records"]):
        ds, person = key.split("/")
        out.append((key, tds.record_paths(FIXTURE, ds, person, ".png" if ds == "MPV_256_192" else "_label.png")))
    return out


def _fixture_script():
    spec = importlib.util.spec_from_file_location("make_upt_fixture", os.path.join(REPO, "scripts", "make_upt_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_manifest_is_what_pil_and_jax_give_now():
    committed = json.load(open(os.path.join(FIXTURE, "MANIFEST.json")))
    assert committed == {"seed": committed["seed"], **_fixture_script().manifest(FIXTURE)}
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE) for n in ns)
    assert size < 512 * 1024, size


def test_port_decoders_and_load_sample_match_the_manifest():
    _digest = _fixture_script().digest
    man = json.load(open(os.path.join(FIXTURE, "MANIFEST.json")))
    for rel, d in man["files"].items():
        assert _digest(image_io.read_image(os.path.join(FIXTURE, rel))) == d, rel
    for rel, d in man["acgpn_l256"].items():
        assert _digest(image_io.read_l_resized(os.path.join(FIXTURE, rel), (256, 256))) == d, rel
    for key, rec in _records():
        sample = tds.load_sample(*rec)
        assert {k: _digest(v) for k, v in sample.items()} == man["records"][key], key


def test_load_sample_equals_jax():
    for key, rec in _records():
        _assert_samples_equal(tds.load_sample(*rec), jds.load_sample(*rec), key)


def test_datasets_equal_jax_getitem():
    ours, ref = tds.UvitonDatasetFull(FIXTURE, random_seed=3), jds.UvitonDatasetFull(FIXTURE, random_seed=3)
    assert len(ours) == len(ref) == 8
    for i in range(len(ref)):
        _assert_samples_equal(ours[i], ref[i], f"train {i}")
    ours_t, ref_t = tds.UvitonDataset256Test(FIXTURE), jds.UvitonDataset256Test(FIXTURE)
    assert len(ours_t) == len(ref_t) == 16
    for i in (0, 5, 11):
        a, b = ours_t[i], ref_t[i]
        assert (a["person_name"], a["garment_name"]) == (b["person_name"], b["garment_name"])
        _assert_samples_equal(a["person"], b["person"], f"test {i} person")
        _assert_samples_equal(a["garment"], b["garment"], f"test {i} garment")
    assert tds.UvitonDataset256Test(FIXTURE, max_size=3).__len__() == 3
    with pytest.raises(IOError):
        tds.UvitonDatasetFull(os.path.join(FIXTURE, "Zalando_256_192"))


def test_acgpn_masks_are_zero_without_their_folder(tmp_path):
    root = tmp_path / "upt"
    os.makedirs(root)
    os.symlink(os.path.join(FIXTURE, "MPV_256_192"), root / "MPV_256_192")
    sample = tds.UvitonDatasetFull(str(root))[1]
    assert sample["acgpn_mask"].shape == (256, 256, 1) and not sample["acgpn_mask"].any()


# ------------------------------------------------------------------ the loader


def test_infinite_loader_emits_the_jax_loaders_batches():
    ours_ds, ref_ds = tds.UvitonDatasetFull(FIXTURE), jds.UvitonDatasetFull(FIXTURE)
    ref = JaxInfiniteLoader(ref_ds, 3, seed=7, num_workers=3)
    with InfiniteLoader(ours_ds, 3, seed=7, num_workers=3) as ours:
        for b in range(4):  # 12 samples over 8 records: crosses an epoch
            _assert_samples_equal(next(ours), next(ref), f"batch {b}")


def test_infinite_loader_surfaces_a_worker_error_and_closes(tmp_path):
    """A corrupt JPEG in the first batch: its worker's traceback, naming the
    file, comes out of `__next__`; `close()` stops every worker process."""
    import shutil

    shutil.copytree(os.path.join(FIXTURE, "MPV_256_192"), tmp_path / "MPV_256_192")
    broken = tmp_path / "MPV_256_192" / "image" / "mpv_0002.jpg"
    broken.write_bytes(broken.read_bytes()[:600])
    loader = InfiniteLoader(tds.UvitonDatasetFull(str(tmp_path)), 2, seed=0, num_workers=3)
    with pytest.raises(RuntimeError, match="loader worker 0 failed building batch 0") as e:
        next(loader)
    assert "mpv_0002.jpg" in str(e.value) and "ValueError" in str(e.value)
    loader.close()
    assert not any(p.is_alive() for p in loader._procs)


# ------------------------------------------------------------------ serving and training


def _test_batch():
    ds = tds.UvitonDataset256Test(FIXTURE)
    pairs = [ds[i] for i in (0, 5)]
    return (tds.collate([p["person"] for p in pairs]), tds.collate([p["garment"] for p in pairs]))


def test_real_tryon_slice_matches_jax():
    person, garment = _test_batch()
    with jax.disable_jit():
        ref = {k: np.asarray(v) for k, v in jds.prepare_tryon_batch(person, garment).items()}
        masks = _jax_denorm_masks(person, garment)
    ours = tds.prepare_tryon_batch(person, garment, device="cpu")
    near = _near_threshold(masks)
    assert int(near.sum()) == 0, "near-threshold pixels on this batch; pick other pairs"
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_allclose(ours[k].numpy(), v, atol=TOL, err_msg=k)
    assert float(np.abs(ref["denorm_upper_img"] + 1).sum()) > 0  # garments were routed

    jgen = JaxGeneratorFull(**THIN)
    variables = _jax_variables(jgen, _gen_shapes(), seed=5)
    w_avg = np.random.default_rng(6).standard_normal(512).astype(np.float32) * 0.1
    outs_ref = jax.jit(lambda v, b: _jax_tryon_forward(jgen, v, b, jnp.asarray(w_avg), 0.7))(
        variables, {k: jnp.asarray(v) for k, v in ref.items()})
    port = GeneratorFull(**THIN)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()), strict=True)
    with torch.no_grad():
        finetune = cli.tryon_forward(port.eval(), torch.from_numpy(w_avg), ours, truncation_psi=0.7)
    assert bool(torch.isfinite(finetune).all())
    np.testing.assert_allclose(finetune.numpy(), np.asarray(outs_ref[1]), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("variant,denorm,n_pairs", [("full", "fused", 16), ("v18", "separate", 3)])
def test_cli_serves_real_pairs_on_cpu(tmp_path, variant, denorm, n_pairs):
    """Every pair of the fixture's list on the Full interface (two batches,
    the second short); the first 3 (a copy of the list beside the same
    records) on the V18 one, whose separate route is the slower one here."""
    root = FIXTURE
    pairs = [line.split() for line in open(os.path.join(FIXTURE, "UPT_subset1_256_192",
                                                         "test_pairs_front_list_shuffle_0508.txt"))][:n_pairs]
    if n_pairs < 16:
        root = str(tmp_path / "upt")
        os.makedirs(os.path.join(root, "UPT_subset1_256_192"))
        for sub in ("image", "keypoints", "parsing"):
            os.symlink(os.path.join(FIXTURE, "UPT_subset1_256_192", sub), os.path.join(root, "UPT_subset1_256_192", sub))
        with open(os.path.join(root, "UPT_subset1_256_192", "test_pairs_front_list_shuffle_0508.txt"), "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in pairs)
    gen = {"full": GeneratorFull, "v18": GeneratorV18}[variant](**THIN).reset_parameters(
        torch.Generator().manual_seed(0))
    snap = str(tmp_path / "snap.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1)),
                  {"model": gen.config, "generator": gen.variant})
    written = cli.main(["--network", snap, "--dataroot", root, "--batchsize", "10", "--denorm", denorm,
                        "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == [f"{a.split('.')[0]}__{b.split('.')[0]}.png" for a, b in pairs]
    assert all(_read_png(p).shape == (256, 192, 3) for p in written[:3])


def test_cli_train_on_real_data_saves_snapshots_by_tick(tmp_path, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cli_train.main(["--outdir", str(tmp_path), "--data", FIXTURE, "--workers", "3", "--batch", "2",
                              "--kimg", "0.006", "--kimg_per_tick", "0.002", "--snap", "1", "--gamma", "5",
                              "--device", "cpu", "--fmaps", str(256 / 32768), "--vgg_weight", "0", "--aug", "noaug",
                              "--img_snap", "0"])
    finally:
        torch.set_num_threads(n)
    records, state = out["records"], out["state"]
    assert state.step == 3 and len(records) == 3 and "Loss/r1_penalty" in records[0]
    assert out["trainer"].config.loss.r1_gamma == 5 and out["trainer"].config.data_workers == 3
    assert all(np.isfinite(v) for r in records for v in r.values())
    ticks = [json.loads(line) for line in open(os.path.join(out["run_dir"], "stats.jsonl"))]
    assert [t["Progress/step"] for t in ticks] == [1, 2, 3]
    saved = [line for line in capsys.readouterr().out.splitlines() if line.startswith("saved ")]
    assert [line.rsplit(" ", 1)[1] for line in saved] == ["2", "3"]  # tick 1 (--snap 1; not tick 0), then the end
    assert os.path.exists(os.path.join(out["run_dir"], "network-snapshot-000000.pt"))
    assert os.path.exists(os.path.join(out["run_dir"], "train-state-latest.pt"))
    with pytest.raises(SystemExit, match="--data DIR or --synthetic N"):
        cli_train.main(["--outdir", str(tmp_path), "--device", "cpu"])
