#!/usr/bin/env python3
"""Write the small UPT-layout fixture tree the port's real-data path is tested on.

  python scripts/make_upt_fixture.py [--out tests/fixtures/upt_mini] [--seed 0]

Needs PIL and the JAX package (it is the oracle; the port never imports this
script).  Deterministic from `--seed`.  The tree holds, in the UPT 256x192
layout:

* Zalando_256_192 (6 records) and MPV_256_192 (2 records, ".png" parsing
  names), each record a JPEG, an OpenPose JSON and a parsing PNG, listed in
  train_pairs_front_list_0508.txt;
* train_random_mask_acgpn/ with 3 masks at 256x192 (modes L, 1 and RGB);
* UPT_subset1_256_192 with 8 persons and 16 lines of
  test_pairs_front_list_shuffle_0508.txt;
* UPT_subset1_512_320 with 4 persons at 512x320 (the same figure scaled 2x
  about the frame's centre line) and 8 lines of
  test_pairs_front_list_shuffle_0508.txt, written after everything else so
  that the 256 files do not depend on them.

The records cover JPEGs at 4:2:0, 4:2:2 and 4:4:4 and at qualities 75 and 95
(one with optimized Huffman tables, one with restart markers), one grey JPEG,
parsing maps in P and L mode, one record with a joint under the 0.1
confidence, one with a joint outside the frame and one with `"people": []`.
Images mix smooth texture with flat regions and sharp label edges.

MANIFEST.json holds, for every image file, the shape, dtype and sha256 of
`np.asarray(PIL.Image.open(p))` (boolean arrays hashed as 0/1 bytes); for every ACGPN mask, those of
`np.asarray(PIL.Image.open(p).convert("L").resize((256, 256)))`; and for
every 256 record, those of each array of the JAX package's `load_sample`
("records"), and for every 512 record those of `load_sample(...,
size=(512, 320))` ("records_512").
"""

import argparse
import hashlib
import json
import os
import shutil

import sys

import numpy as np
import PIL.Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX package's synthetic keypoints (x, y) in the 192x256 frame
BASE_KPS = {
    0: (96, 40), 1: (96, 70), 2: (70, 72), 3: (60, 105), 4: (56, 140),
    5: (122, 72), 6: (132, 105), 7: (136, 140), 8: (78, 140), 9: (74, 190),
    10: (72, 235), 11: (114, 140), 12: (118, 190), 13: (120, 235),
    14: (90, 34), 15: (102, 34), 16: (84, 38), 17: (108, 38),
}

# (dataset, person, JPEG options, parsing mode, keypoint case)
TRAIN = [
    ("Zalando_256_192", "000010_0.jpg", dict(quality=95, subsampling=2), "P", "ok"),
    ("Zalando_256_192", "000020_0.jpg", dict(quality=75, subsampling=0), "L", "ok"),
    ("Zalando_256_192", "000030_0.jpg", dict(quality=75, subsampling=2, optimize=True), "P", "low_conf"),
    ("Zalando_256_192", "000040_0.jpg", dict(quality=95, grey=True), "L", "ok"),
    ("Zalando_256_192", "000050_0.jpg", dict(quality=95, subsampling=1, restart_marker_rows=2), "P", "outside"),
    ("Zalando_256_192", "000060_0.jpg", dict(quality=75, subsampling=2), "L", "empty"),
    ("MPV_256_192", "mpv_0001.jpg", dict(quality=95, subsampling=0), "L", "ok"),
    ("MPV_256_192", "mpv_0002.jpg", dict(quality=75, subsampling=2), "P", "low_conf"),
]
TEST = [("UPT_subset1_256_192", f"upt_{i:04d}.jpg",
         dict(quality=(95, 75)[i % 2], subsampling=(2, 0, 2, 1)[i % 4]), "LP"[i % 2],
         ("ok", "ok", "low_conf", "ok", "empty", "ok", "outside", "ok")[i]) for i in range(8)]
TEST_512 = [("UPT_subset1_512_320", f"upt512_{i:04d}.jpg", dict(quality=(75, 90)[i % 2], subsampling=(2, 1)[i // 2]),
             "LP"[i % 2], ("ok", "low_conf", "ok", "outside")[i]) for i in range(4)]
SIZE_512 = (512, 320)


def keypoints(rng, case, size=(256, 192)):
    """The synthetic figure's joints in a frame of `size` (H, W): drawn in
    the 256x192 frame, then scaled by H / 256 about the vertical centre line."""
    k = np.zeros((18, 3), np.float32)
    for i, (x, y) in BASE_KPS.items():
        k[i] = (x + rng.normal(0, 5), y + rng.normal(0, 5), rng.uniform(0.4, 0.95))
    if case == "low_conf":
        k[6, 2] = 0.05  # left elbow below MIN_CONF: its limbs and the forearm mask are skipped
    if case == "outside":
        k[4, :2] = (-6.5, 150.25)  # right wrist left of the frame, confident
    if size != (256, 192):
        s = size[0] / 256
        k[:, 0] = (k[:, 0] - 96) * s + size[1] / 2
        k[:, 1] *= s
    return k


def parsing_map(k, size=(256, 192)):
    """19-label parsing painted from the keypoints: head, upper garment,
    pants, arms (14, 15), legs, shoes, neck; widths scale with the frame."""
    H, W = size
    s = H / 256
    p = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[:H, :W]

    def rect(x0, y0, x1, y1, label):
        p[max(0, int(y0)):max(0, int(y1)), max(0, int(x0)):max(0, int(x1))] = label

    p[(yy - k[0][1]) ** 2 + (xx - k[0][0]) ** 2 < (17 * s) ** 2] = 13
    rect(k[1][0] - 6 * s, k[1][1] - 12 * s, k[1][0] + 6 * s, k[1][1], 10)
    rect(k[2][0], k[2][1], k[5][0], k[8][1], 5)
    rect(k[8][0] - 8 * s, k[8][1], k[11][0] + 8 * s, k[9][1] + 20 * s, 9)
    rect(k[3][0] - 6 * s, k[3][1] - 10 * s, k[3][0] + 6 * s, k[4][1] + 8 * s, 15)
    rect(k[6][0] - 6 * s, k[6][1] - 10 * s, k[6][0] + 6 * s, k[7][1] + 8 * s, 14)
    rect(k[9][0] - 7 * s, k[9][1] + 20 * s, k[9][0] + 7 * s, k[10][1], 16)
    rect(k[12][0] - 7 * s, k[12][1] + 20 * s, k[12][0] + 7 * s, k[13][1], 17)
    rect(k[10][0] - 8 * s, k[10][1], k[10][0] + 8 * s, H - 1, 18)
    rect(k[13][0] - 8 * s, k[13][1], k[13][0] + 8 * s, H - 1, 19)
    p[(yy - k[0][1] + 12 * s) ** 2 + (xx - k[0][0]) ** 2 < (9 * s) ** 2] = 2  # hair
    return p


def person_image(rng, p):
    """Flat white background, a smooth gradient per label and sinusoidal
    stripes on the garments (AC coefficients and chroma edges)."""
    H, W = p.shape
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    img = np.full((H, W, 3), 250.0, np.float32)
    for label in np.unique(p)[1:]:
        base = rng.uniform(40, 215, 3)
        m = p == label
        shade = 18 * np.sin(yy / rng.uniform(9, 30)) + 12 * np.cos(xx / rng.uniform(7, 25))
        if label in (5, 9):
            shade += 30 * np.sin((xx + yy) / rng.uniform(3, 6))
        img[m] = np.clip(base[None] + shade[m][:, None] * rng.uniform(0.5, 1.0, 3)[None], 0, 255)
    return img.round().astype(np.uint8)


def save_jpeg(arr, path, opts):
    opts = dict(opts)
    img = PIL.Image.fromarray(arr)
    if opts.pop("grey", False):
        img = img.convert("L")
    img.save(path, **opts)


def save_parsing(p, path, mode):
    if mode == "P":
        img = PIL.Image.fromarray(p, "P")
        pal = np.random.default_rng(1).integers(0, 256, (256, 3)).astype(np.uint8)
        img.putpalette(pal.flatten().tolist())
    else:
        img = PIL.Image.fromarray(p, "L")
    img.save(path)


def digest(a):
    """Shape, dtype and sha256 of an array's values (a boolean array hashed as
    0/1 bytes: PIL stores True as 0xFF)."""
    a = np.asarray(a)
    raw = np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool else a)
    return {"shape": list(a.shape), "dtype": str(a.dtype), "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def write_record(rng, root, ds, person, jpeg_opts, parsing_mode, case, size=(256, 192)):
    base = os.path.join(root, ds)
    for sub in ("image", "keypoints", "parsing"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    k = keypoints(rng, case, size)
    p = parsing_map(k, size)
    save_jpeg(person_image(rng, p), os.path.join(base, "image", person), jpeg_opts)
    people = [] if case == "empty" else [{"person_id": [-1], "pose_keypoints_2d": [round(float(v), 3) for v in k.flatten()]}]
    with open(os.path.join(base, "keypoints", person.replace(".jpg", "_keypoints.json")), "w") as f:
        json.dump({"version": 1.3, "people": people}, f)
    suffix = ".png" if ds == "MPV_256_192" else "_label.png"
    save_parsing(p, os.path.join(base, "parsing", person.replace(".jpg", suffix)), parsing_mode)


def acgpn_masks(rng, root):
    d = os.path.join(root, "train_random_mask_acgpn")
    os.makedirs(d)
    yy, xx = np.mgrid[:256, :192]
    for i, mode in enumerate(("L", "1", "RGB")):
        m = np.zeros((256, 192), np.uint8)
        for _ in range(4):
            cx, cy, r = rng.uniform(0, 192), rng.uniform(0, 256), rng.uniform(10, 40)
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] = 255
        if mode == "1":
            PIL.Image.fromarray(m > 0).save(os.path.join(d, f"{i:05d}.png"))
        elif mode == "RGB":
            PIL.Image.fromarray(np.stack([m, m // 2, m // 3], -1)).save(os.path.join(d, f"{i:05d}.png"))
        else:
            PIL.Image.fromarray(m).save(os.path.join(d, f"{i:05d}.png"))


def manifest(root):
    from pasta_gan_tpu.data.dataset import load_sample  # the oracle

    out = {"files": {}, "acgpn_l256": {}, "records": {}, "records_512": {}}
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith((".jpg", ".png")):
                out["files"][rel] = digest(np.asarray(PIL.Image.open(path)))
            if rel.startswith("train_random_mask_acgpn"):
                out["acgpn_l256"][rel] = digest(np.asarray(PIL.Image.open(path).convert("L").resize((256, 256))))
    for key, recs, size in (("records", TRAIN + TEST, (256, 192)), ("records_512", TEST_512, SIZE_512)):
        for ds, person, *_ in recs:
            suffix = ".png" if ds == "MPV_256_192" else "_label.png"
            rec = (os.path.join(root, ds, "image", person),
                   os.path.join(root, ds, "keypoints", person.replace(".jpg", "_keypoints.json")),
                   os.path.join(root, ds, "parsing", person.replace(".jpg", suffix)))
            out[key][f"{ds}/{person}"] = {k: digest(v) for k, v in load_sample(*rec, size=size).items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "upt_mini"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.out)
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    rng = np.random.default_rng(args.seed)
    for rec in TRAIN + TEST:
        write_record(rng, root, *rec)
    for ds in ("Zalando_256_192", "MPV_256_192"):
        with open(os.path.join(root, ds, "train_pairs_front_list_0508.txt"), "w") as f:
            f.writelines(f"{person} {person}\n" for d, person, *_ in TRAIN if d == ds)
    with open(os.path.join(root, "UPT_subset1_256_192", "test_pairs_front_list_shuffle_0508.txt"), "w") as f:
        f.writelines(f"{TEST[i % 8][1]} {TEST[(3 * i + 1) % 8][1]}\n" for i in range(16))
    acgpn_masks(rng, root)
    for rec in TEST_512:
        write_record(rng, root, *rec, size=SIZE_512)
    with open(os.path.join(root, "UPT_subset1_512_320", "test_pairs_front_list_shuffle_0508.txt"), "w") as f:
        f.writelines(f"{TEST_512[i % 4][1]} {TEST_512[(i + 1 + i // 4) % 4][1]}\n" for i in range(8))
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        json.dump({"seed": args.seed, **manifest(root)}, f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(root) for n in ns)
    print(f"wrote {root}: {size} bytes")


if __name__ == "__main__":
    main()
