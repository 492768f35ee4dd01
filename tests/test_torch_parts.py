"""The port's conditional-metrics preprocessing (data/parts.py, without PIL)
and `cli.calc_metrics --conditional` against the JAX package's, on the CPU.

* `square_pad`, `build_part_masks`, `build_part_images`, `pose_disc_heatmap`
  and `sanitize_openpose_keypoints` equal JAX's on the same arrays, exactly:
  tests/test_parts.py's synthetic parsing map and keypoints, and the
  committed fixture's parsing maps and OpenPose files.
* `PartsFolderDataset` items equal JAX's key by key, exactly, over a folder
  written with PIL (JPEG images, PNG parsing maps, keypoint JSON) at
  `resolution` None and at a downscale (LANCZOS, and the heatmap drawn anew),
  and over the fixture's UPT_subset1_256_192 images laid flat with their
  `_label.png` and `_keypoints.json` beside them (7 of its 8: `upt_0004`'s
  OpenPose file lists no person, and both packages raise IndexError on it,
  as the reference's `people[0]` does).
* `cli.calc_metrics --conditional --real_dir` gives JAX's FID on the same
  folders with the same feature extractor (the SimpleConvFeatures stand-in,
  the JAX kernels carried into the port's) within
  tests/test_torch_calc_metrics.py's METRIC_RTOL.
"""

import json
import os
import shutil

import numpy as np
import PIL.Image
import pytest

from pasta_gan_tpu.cli import calc_metrics as jcli
from pasta_gan_tpu.data import parts as jparts
from pasta_gan_tpu_torch.cli import calc_metrics as cli
from pasta_gan_tpu_torch.data import parts as tparts

from test_parts import _keypoints, _synthetic_parsing
from test_torch_calc_metrics import METRIC_RTOL, _rows, _write_folder
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "upt_mini", "UPT_subset1_256_192")
EMPTY = "upt_0004"  # its keypoint file lists no people


def _flat_fixture(root, with_empty=False):
    """The fixture's test images laid flat, each with its parsing and keypoints
    beside it; `upt_0004`, whose OpenPose file holds no person, only with
    `with_empty`."""
    os.makedirs(root)
    for name in sorted(os.listdir(os.path.join(FIXTURE, "image"))):
        stem = os.path.splitext(name)[0]
        if stem == EMPTY and not with_empty:
            continue
        shutil.copy(os.path.join(FIXTURE, "image", name), root)
        shutil.copy(os.path.join(FIXTURE, "parsing", f"{stem}_label.png"), root)
        shutil.copy(os.path.join(FIXTURE, "keypoints", f"{stem}_keypoints.json"), root)
    return str(root)


def _pil_folder(root, h=96, w=64):
    """tests/test_parts.py's folder: two JPEGs with a PNG parsing map and keypoints."""
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for i in range(2):
        stem = os.path.join(root, f"img{i}")
        PIL.Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(stem + ".jpg")
        PIL.Image.fromarray(_synthetic_parsing(h, w, seed=i)).save(stem + "_label.png")
        with open(stem + "_keypoints.json", "w") as f:
            json.dump({"people": [{"pose_keypoints_2d": _keypoints(h, w).reshape(-1).tolist()}]}, f)
    return str(root)


def _fixture_arrays():
    out = []
    for name in sorted(os.listdir(os.path.join(FIXTURE, "image")))[:3]:
        stem = os.path.splitext(name)[0]
        parsing = np.asarray(PIL.Image.open(os.path.join(FIXTURE, "parsing", f"{stem}_label.png")), np.uint8)
        with open(os.path.join(FIXTURE, "keypoints", f"{stem}_keypoints.json")) as f:
            raw = json.load(f)["people"][0]["pose_keypoints_2d"]
        img = np.asarray(PIL.Image.open(os.path.join(FIXTURE, "image", name)).convert("RGB"))
        out.append((img, parsing, raw))
    rng = np.random.RandomState(1)
    out.append((rng.uniform(0, 255, (96, 64, 3)).astype(np.uint8), _synthetic_parsing(), _keypoints().reshape(-1)))
    return out


def test_functions_equal_jax():
    for shape in ((5, 3, 2), (3, 5), (4, 4, 1), (7, 2, 3)):
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(tparts.square_pad(x, 0.5), jparts.square_pad(x, 0.5))
    for img, parsing, raw in _fixture_arrays():
        kps = tparts.sanitize_openpose_keypoints(raw)
        np.testing.assert_array_equal(kps, jparts.sanitize_openpose_keypoints(raw))
        a, b = tparts.build_part_masks(parsing, kps), jparts.build_part_masks(parsing, kps)
        assert sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype for k in b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        padded = tparts.square_pad(img.astype(np.float32))
        for x, y in zip(tparts.build_part_images(padded, parsing, kps), jparts.build_part_images(padded, parsing, kps)):
            np.testing.assert_array_equal(x, y)
        for sigma in (8, 3.5):
            hm = tparts.pose_disc_heatmap(kps, img.shape[:2], sigma)
            assert hm.dtype == np.uint8
            np.testing.assert_array_equal(hm, jparts.pose_disc_heatmap(kps, img.shape[:2], sigma))
        assert a["palm"].sum() >= 0 and a["top"].sum() > 0


def _equal_items(root, resolution):
    ours, ref = tparts.PartsFolderDataset(root, resolution), jparts.PartsFolderDataset(root, resolution)
    assert ours.fnames == ref.fnames
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b) == sorted(["image", "keypoints", "pose_heatmap", "head_img", "top_img",
                                                 "pant_img", "palm_img"])
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    return len(ref)


@pytest.mark.parametrize("resolution", [None, 48])
def test_dataset_items_equal_jax_on_a_pil_folder(tmp_path, resolution):
    assert _equal_items(_pil_folder(tmp_path / "parts"), resolution) == 2


@pytest.mark.parametrize("resolution", [None, 128])
def test_dataset_items_equal_jax_on_the_fixture(tmp_path, resolution):
    assert _equal_items(_flat_fixture(tmp_path / "flat"), resolution) == 7


def test_dataset_without_a_person_raises_like_jax(tmp_path):
    """The reference reads `people[0]` (dataset.py:412), as both packages do."""
    root = _flat_fixture(tmp_path / "flat", with_empty=True)
    ours, ref = tparts.PartsFolderDataset(root), jparts.PartsFolderDataset(root)
    i = [os.path.basename(f) for f in ref.fnames].index(f"{EMPTY}.jpg")
    for ds in (ours, ref):
        with pytest.raises(IndexError):
            ds[i]


def test_cli_conditional_fid_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on their default SimpleConvFeatures stand-in, the port's
    carrying the JAX kernels (an InceptionV3 on the CPU takes most of a
    minute here, and tests/test_torch_calc_metrics.py holds it)."""
    import torch  # noqa: F401  (the port's extractor)

    from pasta_gan_tpu.metrics.extractors import SimpleConvFeatures as JaxSimpleConv
    from pasta_gan_tpu_torch import metrics as tmetrics
    from pasta_gan_tpu_torch.io.from_jax import simpleconv_state_dict_from_jax

    def carried_extractor(detector_path=None, device="cpu"):
        jx, port = JaxSimpleConv(), tmetrics.SimpleConvFeatures(device=device)
        port.load_state_dict(simpleconv_state_dict_from_jax(jx.kernels, jx.proj, port.state_dict()), strict=True)
        return port

    monkeypatch.setattr(tmetrics, "default_extractor", carried_extractor)
    real_dir = _flat_fixture(tmp_path / "real")
    gen_dir = _write_folder(tmp_path / "gen", 3, [(256, 192)] * 7)
    argv = ["--gen_dir", gen_dir, "--real_dir", real_dir, "--conditional", "--resolution", "128", "--batch", "4",
            "--metrics", "fid50k_full"]
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    cli.main(argv + ["--device", "cpu", "--run_dir", str(tmp_path / "port")])
    jcli.main(argv + ["--run_dir", str(tmp_path / "jax")])
    got, ref = _rows(tmp_path / "port")["fid50k_full"], _rows(tmp_path / "jax")["fid50k_full"]
    print(f"--conditional FID: port {got['results']['fid50k_full']!r}, JAX {ref['results']['fid50k_full']!r}")
    assert np.isfinite(got["results"]["fid50k_full"]) and got["results"]["fid50k_full"] > 0
    assert abs(got["results"]["fid50k_full"] - ref["results"]["fid50k_full"]) <= \
        METRIC_RTOL * abs(ref["results"]["fid50k_full"])
