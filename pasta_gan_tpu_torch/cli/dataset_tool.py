"""Dataset packing CLI (counterpart of `pasta_gan_tpu/cli/dataset_tool.py`;
reference `dataset_tool.py:110-618`), without PIL.

convert: a source -> a zip (or folder) of PNGs `00000/img00000000.png` ...
with a `dataset.json` label index.  Sources (reference `open_dataset`,
dataset_tool.py:257-271): an image folder, an image zip, an LSUN lmdb
directory (`*_lmdb`, needs the optional `lmdb` package), CIFAR-10's
`cifar-10-python.tar.gz` and MNIST's `train-images-idx3-ubyte.gz`.
Transforms (reference `make_transform`, dataset_tool.py:201-249): plain
scale, center-crop, center-crop-wide.  convert-by-txts: the multi-root txt
pair lists filtered by the "train half front" tags.

Images are decoded by `data/image_io.py` (JPEG and PNG, as Pillow decodes
them), resized by its Pillow-exact LANCZOS or BOX filter and written by
`image_io.png_bytes`; the PNG bytes differ from Pillow's `compress_level=0`
ones, the decoded pixels do not.

  python -m pasta_gan_tpu_torch.cli.dataset_tool convert --source ./imgs --dest out.zip
  python -m pasta_gan_tpu_torch.cli.dataset_tool convert --source cifar-10-python.tar.gz \\
      --dest cifar.zip --transform center-crop --width 32 --height 32
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np

from ..data import image_io

_EXTS = (".png", ".jpg", ".jpeg")


def _iter_image_blobs(source: str):
    if os.path.isdir(source):
        for root, _, files in sorted(os.walk(source)):
            for f in sorted(files):
                if f.lower().endswith(_EXTS):
                    full = os.path.join(root, f)
                    with open(full, "rb") as fh:
                        yield os.path.relpath(full, source), fh.read()
    else:
        with zipfile.ZipFile(source) as z:
            for name in sorted(z.namelist()):
                if name.lower().endswith(_EXTS):
                    yield name, z.read(name)


def _decode_rgb(blob: bytes, name: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(BytesIO(blob)).convert("RGB"))`."""
    return image_io.to_rgb(*image_io.decode_bytes(blob, name))


def _iter_folder_or_zip(source: str):
    for rel, blob in _iter_image_blobs(source):
        yield rel, _decode_rgb(blob, rel), None


def _iter_cifar10(tarball: str):
    """cifar-10-python.tar.gz: five pickled train batches of [N, 3072] uint8
    (reference open_cifar10, dataset_tool.py:138-167)."""
    with tarfile.open(tarball, "r:gz") as tar:
        for batch in range(1, 6):
            with tar.extractfile(tar.getmember(f"cifar-10-batches-py/data_batch_{batch}")) as f:
                data = pickle.load(f, encoding="latin1")
            imgs = np.asarray(data["data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            for img, label in zip(imgs, data["labels"]):
                yield None, img, int(label)


def _iter_mnist(images_gz: str):
    """train-images-idx3-ubyte.gz and its sibling labels: 28x28 uint8 padded
    to 32x32 (reference open_mnist, dataset_tool.py:171-197)."""
    labels_gz = images_gz.replace("-images-idx3-ubyte.gz", "-labels-idx1-ubyte.gz")
    with gzip.open(images_gz, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16).reshape(-1, 28, 28)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant")
    for img, label in zip(images, labels):
        yield None, img, int(label)


def _iter_lmdb(lmdb_dir: str):
    """An LSUN lmdb directory of encoded images (reference open_lmdb,
    dataset_tool.py:110-135); the `lmdb` package is imported only here."""
    try:
        import lmdb
    except ImportError as e:
        raise SystemExit("lmdb sources need the 'lmdb' package (pip install lmdb)") from e

    with lmdb.open(lmdb_dir, readonly=True, lock=False).begin(write=False) as txn:
        for key, value in txn.cursor():
            try:
                img = _decode_rgb(bytes(value), repr(key))
            except ValueError as e:  # an entry the decoders refuse: skipped, as the reference does
                print(f"skipping lmdb entry: {e}")
                continue
            yield None, img, None


def open_source(source: str):
    """The sample iterator of a source path (reference open_dataset)."""
    if os.path.isdir(source):
        if source.rstrip("/").endswith("_lmdb"):
            return _iter_lmdb(source)
        return _iter_folder_or_zip(source)
    base = os.path.basename(source)
    if base == "cifar-10-python.tar.gz":
        return _iter_cifar10(source)
    if base.endswith("-images-idx3-ubyte.gz"):
        return _iter_mnist(source)
    if source.lower().endswith(".zip"):
        return _iter_folder_or_zip(source)
    raise SystemExit(f"unsupported source {source}")


def make_transform(transform, width, height, resize_filter="lanczos"):
    """None (plain scale), "center-crop" or "center-crop-wide"; a transform
    returns None to drop an image (reference make_transform)."""
    if resize_filter not in ("box", "lanczos"):
        raise SystemExit(f"unknown resize filter {resize_filter}")

    def resize(img, w, h):
        return image_io.resize(img, (w, h), resize_filter)

    def scale(img):
        h, w = img.shape[:2]
        ww, hh = width or w, height or h
        if (ww, hh) == (w, h):
            return img
        return resize(img, ww, hh)

    def center_crop(img):
        crop = min(img.shape[:2])
        img = img[(img.shape[0] - crop) // 2 : (img.shape[0] + crop) // 2,
                  (img.shape[1] - crop) // 2 : (img.shape[1] + crop) // 2]
        return resize(img, width, height)

    def center_crop_wide(img):
        ch = int(np.round(width * img.shape[0] / img.shape[1]))
        if img.shape[1] < width or ch < height:
            return None
        img = img[(img.shape[0] - ch) // 2 : (img.shape[0] + ch) // 2]
        canvas = np.zeros([width, width, 3], dtype=np.uint8)
        canvas[(width - height) // 2 : (width + height) // 2, :] = resize(img, width, height)
        return canvas

    if transform is None:
        return scale
    if transform in ("center-crop", "center-crop-wide"):
        if not (width and height):
            raise SystemExit(f"--width/--height required for {transform}")
        return center_crop if transform == "center-crop" else center_crop_wide
    raise SystemExit(f"unknown transform {transform}")


class _Writer:
    def __init__(self, dest: str):
        self.is_zip = dest.lower().endswith(".zip")
        self.dest = dest
        if self.is_zip:
            self.zf = zipfile.ZipFile(dest, "w", compression=zipfile.ZIP_STORED)
        else:
            os.makedirs(dest, exist_ok=True)

    def write(self, name: str, data: bytes):
        if self.is_zip:
            self.zf.writestr(name, data)
        else:
            path = os.path.join(self.dest, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)

    def close(self, labels):
        meta = json.dumps({"labels": labels if labels else None})
        if self.is_zip:
            self.zf.writestr("dataset.json", meta)
            self.zf.close()
        else:
            with open(os.path.join(self.dest, "dataset.json"), "w") as f:
                f.write(meta)


def _archive_name(count: int) -> str:
    return f"{count // 1000:05d}/img{count:08d}.png"


def convert_dataset(source: str, dest: str, resolution=None, max_images=None, labels_path=None, transform=None,
                    width=None, height=None, resize_filter="lanczos"):
    """Pack `source` into `dest`; returns the image count.  `resolution` is
    the square shorthand (center-crop then resize unless `transform` says
    otherwise); labels come from the source (CIFAR-10, MNIST) or from a
    `dataset.json`-style `labels_path`, and are kept only if every image has
    one (reference dataset_tool.py:88-96)."""
    if resolution is not None and width is None:
        width = height = resolution
        transform = transform or "center-crop"
    tf = make_transform(transform, width, height, resize_filter)

    file_labels = {}
    if labels_path and os.path.exists(labels_path):
        with open(labels_path) as f:
            file_labels = dict(json.load(f).get("labels") or [])

    writer = _Writer(dest)
    out_labels, count = [], 0
    for rel, img, label in open_source(source):
        if max_images is not None and count >= max_images:
            break
        img = tf(img)
        if img is None:
            continue
        name = _archive_name(count)
        writer.write(name, image_io.png_bytes(img))
        if label is not None:
            out_labels.append([name, label])
        elif rel in file_labels:
            out_labels.append([name, file_labels[rel]])
        count += 1
    writer.close(out_labels if len(out_labels) == count else [])
    print(f"packed {count} images -> {dest}")
    return count


def convert_dataset_load_by_txts(sources, dest, txt_name="train_pairs_front_list_0508.txt",
                                 tags=("train", "half", "front"), resolution=None):
    """The images named by each root's txt pair list (lines carrying every
    tag, or a bare name), center-cropped to `resolution` when given
    (reference dataset_tool.py:458-618)."""
    writer = _Writer(dest)
    count = 0
    for root in sources:
        txt = os.path.join(root, txt_name)
        if not os.path.exists(txt):
            continue
        with open(txt) as f:
            lines = f.read().splitlines()
        for line in lines:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) > 1 and tags and not all(t in line for t in tags):
                continue
            fname = os.path.join(root, "image", parts[0])
            if not os.path.exists(fname):
                continue
            img = image_io.read_rgb(fname)
            if resolution is not None:
                img = make_transform("center-crop", resolution, resolution)(img)
            writer.write(_archive_name(count), image_io.png_bytes(img))
            count += 1
    writer.close([])
    print(f"packed {count} images -> {dest}")
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="pack an image folder/zip/lmdb/cifar/mnist source")
    c.add_argument("--source", required=True)
    c.add_argument("--dest", required=True)
    c.add_argument("--resolution", type=int, default=None,
                   help="square output size: center-crop then resize (pass --transform to pick another)")
    c.add_argument("--max-images", type=int, default=None)
    c.add_argument("--labels", default=None)
    c.add_argument("--transform", choices=["center-crop", "center-crop-wide"], default=None)
    c.add_argument("--width", type=int, default=None)
    c.add_argument("--height", type=int, default=None)
    c.add_argument("--resize-filter", choices=["box", "lanczos"], default="lanczos")

    t = sub.add_parser("convert-by-txts", help="pack via txt pair lists")
    t.add_argument("--sources", nargs="+", required=True)
    t.add_argument("--dest", required=True)
    t.add_argument("--resolution", type=int, default=None)

    args = p.parse_args(argv)
    if args.cmd == "convert":
        return convert_dataset(args.source, args.dest, args.resolution, args.max_images, args.labels,
                               args.transform, args.width, args.height, args.resize_filter)
    return convert_dataset_load_by_txts(args.sources, args.dest, resolution=args.resolution)


if __name__ == "__main__":
    main()
