"""The port's dataset tools (pasta_gan_tpu_torch/cli/dataset_tool.py,
cli/draw_point.py) against the JAX package's, on the CPU.

The JAX CLI's own cases (tests/test_dataset_tool.py: a folder with labels
and a crop, a zip scaled to its own size, CIFAR-10, MNIST, center-crop-wide,
the CLI entry point), plus the BOX filter against Pillow, convert-by-txts
and `draw_point` against JAX.  Each conversion runs through both packages
on the same source: the outputs must have the same member names and
`dataset.json`, and equal decoded pixels (the PNG bytes differ: the port
deflates, Pillow's `compress_level=0` stores).
"""

import gzip
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np
import PIL.Image
import pytest

from pasta_gan_tpu.cli import dataset_tool as jtool
from pasta_gan_tpu.cli import draw_point as jdraw
from pasta_gan_tpu_torch.cli import dataset_tool as tool
from pasta_gan_tpu_torch.cli import draw_point
from pasta_gan_tpu_torch.data import image_io

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "upt_mini", "UPT_subset1_256_192")


def _write_images(d, n=5, hw=(48, 64), fmt="png"):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(n):
        img = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
        name = f"im{i:03d}.{'jpg' if fmt == 'jpeg' else fmt}"
        PIL.Image.fromarray(img).save(os.path.join(d, name), **({"quality": 90} if fmt == "jpeg" else {}))
        names.append(name)
    return names


def _members(dest):
    """{name: bytes} of a zip or a folder output."""
    if str(dest).endswith(".zip"):
        with zipfile.ZipFile(dest) as z:
            return {n: z.read(n) for n in z.namelist()}
    out = {}
    for root, _, files in os.walk(dest):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), dest)] = fh.read()
    return out


def assert_same_output(ours, ref):
    a, b = _members(ours), _members(ref)
    assert sorted(a) == sorted(b)
    assert json.loads(a["dataset.json"]) == json.loads(b["dataset.json"])
    for name in a:
        if name.endswith(".png"):
            ref_px = np.asarray(PIL.Image.open(io.BytesIO(b[name])))
            np.testing.assert_array_equal(image_io.decode_bytes(a[name])[0], ref_px, err_msg=name)
            np.testing.assert_array_equal(np.asarray(PIL.Image.open(io.BytesIO(a[name]))), ref_px, err_msg=name)
    return a


def both(tmp_path, dest_name, run):
    """`run(module, dest)` with the port's and with JAX's tool, into dest_name
    and jax_<dest_name>: (the image count, the port's output members)."""
    ours, ref = tmp_path / dest_name, tmp_path / f"jax_{dest_name}"
    n = run(tool, str(ours))
    assert n == run(jtool, str(ref))
    return n, assert_same_output(ours, ref)


def test_convert_folder_with_labels_and_crop(tmp_path):
    src = tmp_path / "src"
    names = _write_images(str(src))
    lp = tmp_path / "labels.json"
    lp.write_text(json.dumps({"labels": [[n, i] for i, n in enumerate(names)]}))
    n, out = both(tmp_path, "out.zip", lambda m, d: m.convert_dataset(str(src), d, resolution=32, labels_path=str(lp)))
    assert n == 5
    meta = json.loads(out["dataset.json"])
    assert len(meta["labels"]) == 5
    assert image_io.decode_bytes(out[meta["labels"][0][0]])[0].shape == (32, 32, 3)


def test_convert_zip_source_scale_default(tmp_path):
    src = tmp_path / "in.zip"
    imgs = np.arange(2 * 32 * 32 * 3, dtype=np.uint8).reshape(2, 32, 32, 3)
    with zipfile.ZipFile(src, "w") as z:
        for i, im in enumerate(imgs):
            buf = io.BytesIO()
            PIL.Image.fromarray(im).save(buf, format="png")
            z.writestr(f"a/{i}.png", buf.getvalue())
    n, out = both(tmp_path, "outdir", lambda m, d: m.convert_dataset(str(src), d))
    assert n == 2 and json.loads(out["dataset.json"])["labels"] is None
    assert os.path.join("00000", "img00000000.png") in out


def test_cifar10_source(tmp_path):
    tarball = tmp_path / "cifar-10-python.tar.gz"
    rng = np.random.default_rng(1)
    with tarfile.open(tarball, "w:gz") as tar:
        for b in range(1, 6):
            blob = pickle.dumps({"data": rng.integers(0, 255, (4, 3072), dtype=np.uint8),
                                 "labels": [int(x) for x in rng.integers(0, 10, 4)]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{b}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    n, out = both(tmp_path, "cifar.zip", lambda m, d: m.convert_dataset(str(tarball), d, max_images=12))
    meta = json.loads(out["dataset.json"])
    assert n == 12 and len(meta["labels"]) == 12
    assert image_io.decode_bytes(out[meta["labels"][0][0]])[0].shape == (32, 32, 3)


def test_mnist_source(tmp_path):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, (6, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 6).astype(np.uint8)
    ip, lp = tmp_path / "train-images-idx3-ubyte.gz", tmp_path / "train-labels-idx1-ubyte.gz"
    with gzip.open(ip, "wb") as f:
        f.write(b"\x00" * 16 + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(b"\x00" * 8 + labels.tobytes())
    n, out = both(tmp_path, "mnist", lambda m, d: m.convert_dataset(str(ip), d))
    meta = json.loads(out["dataset.json"])
    assert n == 6 and [l for _, l in meta["labels"]] == [int(x) for x in labels]
    img = image_io.decode_bytes(out[meta["labels"][0][0]])[0]
    assert img.shape == (32, 32) and img[:2].max() == 0
    np.testing.assert_array_equal(img[2:30, 2:30], imgs[0])


@pytest.mark.parametrize("resize_filter", ["lanczos", "box"])
def test_center_crop_wide_drops_small_and_pads(resize_filter):
    tf, jtf = (m.make_transform("center-crop-wide", 64, 32, resize_filter) for m in (tool, jtool))
    small = np.zeros((16, 16, 3), np.uint8)
    assert tf(small) is None and jtf(small) is None
    rng = np.random.default_rng(3)
    wide = rng.integers(1, 255, (64, 128, 3), dtype=np.uint8)
    out = tf(wide)
    assert out.shape == (64, 64, 3) and out[:16].max() == 0 and out[-16:].max() == 0
    np.testing.assert_array_equal(out, jtf(wide))


@pytest.mark.parametrize("shape,size", [((48, 64), (32, 32)), ((256, 192), (64, 64)), ((37, 53), (20, 11)),
                                        ((30, 30), (64, 50)), ((100, 80), (33, 77))])
def test_box_resize_equals_pillow(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(image_io.resize(img, size, "box"),
                                  np.asarray(PIL.Image.fromarray(img).resize(size, PIL.Image.BOX)))


def test_cli_entrypoint_with_jpegs_and_box(tmp_path):
    src = tmp_path / "src"
    _write_images(str(src), n=3, hw=(40, 56), fmt="jpeg")
    dest, jdest = tmp_path / "o.zip", tmp_path / "jax_o.zip"
    argv = ["convert", "--source", str(src), "--transform", "center-crop", "--width", "24", "--height", "24",
            "--resize-filter", "box"]
    tool.main(argv + ["--dest", str(dest)])
    jtool.main(argv + ["--dest", str(jdest)])
    out = assert_same_output(dest, jdest)
    assert len([n for n in out if n.endswith(".png")]) == 3


def test_convert_by_txts(tmp_path):
    roots = []
    for r in range(2):
        root = tmp_path / f"root{r}"
        names = _write_images(str(root / "image"), n=3, hw=(64, 48))
        lines = [f"{names[0]} train half front", f"{names[1]} test half front", names[2], ""]
        (root / "train_pairs_front_list_0508.txt").write_text("\n".join(lines))
        roots.append(str(root))
    n, out = both(tmp_path, "txts.zip", lambda m, d: m.convert_dataset_load_by_txts(roots, d, resolution=32))
    assert n == 4  # the tagged line and the bare name of each root
    assert image_io.decode_bytes(out["00000/img00000003.png"])[0].shape == (32, 32, 3)


def test_lmdb_source_is_refused_without_lmdb(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_lmdb(name, *a, **kw):
        if name == "lmdb":
            raise ImportError("no lmdb")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_lmdb)
    (tmp_path / "bedroom_lmdb").mkdir()
    with pytest.raises(SystemExit, match="lmdb sources need the 'lmdb' package"):
        tool.convert_dataset(str(tmp_path / "bedroom_lmdb"), str(tmp_path / "o.zip"))


def test_draw_point_matches_jax(tmp_path):
    image = os.path.join(FIXTURE, "image", sorted(os.listdir(os.path.join(FIXTURE, "image")))[0])
    stem = os.path.splitext(os.path.basename(image))[0]
    kps = os.path.join(FIXTURE, "keypoints", f"{stem}_keypoints.json")
    out, jout = tmp_path / "overlay.png", tmp_path / "jax_overlay.png"
    ours = draw_point.main(["--image", image, "--keypoints", kps, "--out", str(out)])
    jdraw.main(["--image", image, "--keypoints", kps, "--out", str(jout)])
    ref = np.asarray(PIL.Image.open(jout))
    np.testing.assert_array_equal(image_io.read_image(str(out)), ref)
    np.testing.assert_array_equal(ours, ref)
    assert int((ref != np.asarray(PIL.Image.open(image).convert("RGB"))).any(-1).sum()) > 100  # a stickman was drawn
