"""Metrics CLI (counterpart of `pasta_gan_tpu/cli/calc_metrics.py`; reference `calc_metrics.py`).

Computes FID/KID/IS/PR over generated try-on images against dataset reals,
and PPL (ppl2_wend and its variants) over w-space paths of a network.
Generated images come from `--gen_dir` (a folder, e.g. `cli.test`'s output)
or `--network` (a GeneratorFull snapshot, run over the test pairs of
`--dataroot` or over `--synthetic N` pairs); reals from `--real_dir` or
`--synthetic`.  The detector is `--detector` (InceptionV3 weights on disk,
or `auto` to look them up, metrics/detectors_manifest.py) or the
SimpleConvFeatures stand-in; the PPL distance is `--ppl_detector` (vgg16 /
LPIPS weights, or `auto`) or the float-path stand-in.  Everything runs on
`--device` (default `cuda`), in float32 with TF32 off.

  python -m pasta_gan_tpu_torch.cli.calc_metrics --metrics fid50k_full,kid50k_full \\
      --gen_dir ./test_results --real_dir /data/UPT_256/.../image --detector auto
  python -m pasta_gan_tpu_torch.cli.calc_metrics --metrics ppl2_wend \\
      --network runs/.../network-snapshot-000123.pt --dataroot /data/UPT_test

The network source yields the whole 256x256 frame as uint8 (the JAX
source's frame; `cli.test` un-pads its PNGs to 256x192) and refuses a
snapshot that does not hold a `full` generator.  It loads each batch's pairs
when it reaches them (the JAX source loads every pair first).
`--conditional` reads the reals through `data/parts.py:PartsFolderDataset`
(each image with its `<stem>_label.png` parsing and `<stem>_keypoints.json`
pose beside it: the square-padded image, resized by LANCZOS to
`--resolution`, feeds the detector; the part images and the pose heatmap are
built for each item as the reference's conditional dataset builds them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device


def _folder_source(path: str, batch: int = 32, resolution=None):
    """Every .png/.jpg/.jpeg under `path`, sorted, decoded to RGB and, with
    `resolution`, resized to resolution x resolution by Pillow's LANCZOS
    (`data/image_io.py`): uint8 [B, H, W, 3] numpy batches."""
    from ..data.image_io import read_rgb, resize

    exts = (".png", ".jpg", ".jpeg")
    fnames = sorted(os.path.join(root, f) for root, _, files in os.walk(path) for f in files
                    if f.lower().endswith(exts))
    if not fnames:
        raise SystemExit(f"no images under {path}")

    def source():
        buf = []
        for fn in fnames:
            img = read_rgb(fn)
            if resolution is not None:
                img = resize(img, (resolution, resolution), "lanczos")
            buf.append(img)
            if len(buf) == batch:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    return source


def _parts_source(path: str, batch: int = 32, resolution=None):
    """The reals of `--conditional` (JAX `cli/calc_metrics.py:283-300`):
    each `PartsFolderDataset(path, resolution)` item's `image`, in uint8
    [B, S, S, 3] numpy batches."""
    from ..data.parts import PartsFolderDataset

    ds = PartsFolderDataset(path, resolution=resolution)

    def source():
        buf = []
        for i in range(len(ds)):
            buf.append(ds[i]["image"])
            if len(buf) == batch:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)

    return source


def _pairs(dataroot, synthetic: int):
    """(number of pairs, pair(i) -> (person, garment) host samples): the
    synthetic pairs (sample i wears sample i + 1's garment) or the UPT test
    pairs of `dataroot`, loaded when asked for."""
    from ..data.dataset import SyntheticUvitonDataset, UvitonDataset256Test

    if synthetic:
        ds = SyntheticUvitonDataset(num_samples=synthetic)
        return len(ds), lambda i: (ds[i], ds[(i + 1) % len(ds)])
    if dataroot is None:
        raise SystemExit("--network needs --dataroot DIR or --synthetic N")
    tds = UvitonDataset256Test(dataroot)

    def pair(i):
        r = tds[i]
        return r["person"], r["garment"]

    return len(tds), pair


def _full_generator(network: str, device):
    from .test import load_generator

    return load_generator(network, device, "full")  # raises, naming the variant, for any other


def _network_source(network: str, dataroot, synthetic: int, batch: int, device="cuda"):
    """Try-on images generated on the fly (the reference's generator path):
    route each batch (`prepare_tryon_batch`, fused denorm route), run the
    fp32 forward with noise off and psi 1 (`cli/test.py:tryon_forward`) and
    yield clip((out + 1) * 127.5) as uint8 [B, 256, 256, 3] on the device."""
    from ..data.dataset import collate, prepare_tryon_batch
    from .test import tryon_forward

    device = resolve_device(device)
    gen, w_avg = _full_generator(network, device)
    n, pair = _pairs(dataroot, synthetic)

    def source():
        for i in range(0, n, batch):
            chunk = [pair(k) for k in range(i, min(i + batch, n))]
            b = prepare_tryon_batch(collate([c[0] for c in chunk]), collate([c[1] for c in chunk]), device=device)
            out = tryon_forward(gen, w_avg, b).float()
            yield ((out + 1) * 127.5).clamp(0, 255).to(torch.uint8)

    return source


def _ppl_sampler(network: str, dataroot, synthetic: int, batch: int, device="cuda"):
    """PPL sampler factory for MetricOptions (reference
    `perceptual_path_length.py:36-95` for the style-conditioned generators):
    a w-space pair is the mapped codes of the same person wearing garments i
    and i + 1; pose, retain features and the denorm inputs stay those of the
    first garment while w interpolates.  The pair stream cycles, so any
    sample count is reachable from a finite pair list."""
    from ..data.dataset import collate, prepare_tryon_batch
    from ..models.generator_full import cat_feats_dict

    device = resolve_device(device)
    gen, _ = _full_generator(network, device)
    n, pair = _pairs(dataroot, synthetic)

    @torch.no_grad()
    def embed(b):
        stylecode, feats = gen.encode_style(b["style_input"], b["retain"])
        pose_feat = gen.encode_pose(b["pose"])
        ws, _ = gen.map_ws(None, stylecode)
        return ws, pose_feat, feats

    @torch.no_grad()
    def synth(ws, aux):
        return gen.synthesize(ws, aux["pose_feat"], aux["cat_feats"], aux["du"], aux["dl"], aux["dum"], aux["dlm"],
                              noise_mode="none")[1]

    def sampler(space: str):
        if space != "w":
            raise SystemExit(
                f"{space}-space PPL is unavailable: the config of record has z_dim=0 (style-conditioned "
                "mapping; metrics/ppl.py) -- use ppl2_wend / ppl_wfull / ppl_wend")

        def pair_iter():
            while True:
                for i in range(0, n, batch):
                    first = [pair((i + k) % n) for k in range(batch)]
                    persons = collate([p for p, _ in first])
                    b_a = prepare_tryon_batch(persons, collate([g for _, g in first]), device=device)
                    b_b = prepare_tryon_batch(persons, collate([pair((i + k + 1) % n)[1] for k in range(batch)]),
                                              device=device)
                    ws0, pose_feat, feats = embed(b_a)
                    ws1, _, _ = embed(b_b)
                    aux = dict(pose_feat=pose_feat, cat_feats=cat_feats_dict(feats),
                               du=b_a["denorm_upper_img"], dl=b_a["denorm_lower_img"],
                               dum=b_a["denorm_upper_mask"], dlm=b_a["denorm_lower_mask"])
                    yield ws0, ws1, aux

        return synth, pair_iter()

    return sampler


def _synthetic_real_source(synthetic: int, batch: int):
    from ..data.dataset import SyntheticUvitonDataset

    ds = SyntheticUvitonDataset(num_samples=synthetic)

    def source():
        imgs = np.stack([ds[i]["image"] for i in range(len(ds))])
        for i in range(0, len(imgs), batch):
            yield imgs[i : i + batch]

    return source


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metrics", default="fid50k_full", help="comma-separated metric list")
    p.add_argument("--gen_dir", default=None)
    p.add_argument("--network", default=None)
    p.add_argument("--dataroot", default=None)
    p.add_argument("--real_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--detector", default=None,
                   help="inception weights on disk (TorchScript .pt / state_dict / .npz) for reference-protocol "
                        "FID/KID/IS; 'auto' searches $PASTA_GAN_DETECTORS, ./weights and "
                        "~/.cache/pasta_gan_tpu/detectors (metrics/detectors_manifest.py)")
    p.add_argument("--run_dir", default=None, help="where to append metric-*.jsonl")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--resolution", type=int, default=None, help="resize folder images (LANCZOS)")
    p.add_argument("--conditional", action="store_true",
                   help="reals from --real_dir with part images + pose heatmaps (data/parts.py)")
    p.add_argument("--ppl_detector", default=None,
                   help="vgg16 (+ optional LPIPS heads) weights for the LPIPS distance (metrics/ppl.py "
                        "lpips_distance), or 'auto'; without it PPL uses the float-path stand-in distance "
                        "(NOT LPIPS-calibrated)")
    p.add_argument("--ppl_samples", type=int, default=None, help="override the 50k PPL sample protocol")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # FID is sensitive to TF32: the reference's calc_metrics pins it off for the run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..metrics import calc_metric, default_extractor, is_valid_metric, report_metric
    from ..metrics.detectors_manifest import find_detector, verify_detector

    if args.detector == "auto":
        args.detector = find_detector("inception")
        if args.detector:
            print(f"inception detector: {args.detector} (sha256 {verify_detector('inception', args.detector)})")
        else:
            print("no inception weights found (see metrics/detectors_manifest.py); using the SimpleConvFeatures "
                  "stand-in: numbers are NOT reference-comparable")
    if args.ppl_detector == "auto":
        args.ppl_detector = find_detector("vgg16")
        if args.ppl_detector:
            print(f"vgg16/LPIPS detector: {args.ppl_detector} (sha256 {verify_detector('vgg16', args.ppl_detector)})")
        else:
            print("no vgg16 weights found; PPL uses the float-path stand-in distance: NOT LPIPS-calibrated")

    metrics = [m.strip() for m in args.metrics.split(",")]
    for metric in metrics:
        if not is_valid_metric(metric):
            raise SystemExit(f"unknown metric {metric}")
    ppl_only = all(m.startswith("ppl") for m in metrics)

    ppl_kwargs = {}
    if any(m.startswith("ppl") for m in metrics):
        if not args.network:
            raise SystemExit("PPL metrics need --network (w-space pairs come from mapped style codes)")
        ppl_kwargs["ppl_sampler"] = _ppl_sampler(args.network, args.dataroot, args.synthetic, args.batch, device)
        if args.ppl_samples:
            ppl_kwargs["ppl_num_samples"] = args.ppl_samples
        if args.ppl_detector:
            from ..metrics.ppl import lpips_distance
            from ..metrics.vgg16 import load_state_dict_file

            ppl_kwargs["ppl_distance"] = lpips_distance(load_state_dict_file(args.ppl_detector), device=device)

    if args.gen_dir:
        gen_source = _folder_source(args.gen_dir, args.batch, args.resolution)
    elif args.network and not ppl_only:
        gen_source = _network_source(args.network, args.dataroot, args.synthetic, args.batch, device)
    elif ppl_only:
        gen_source = None
    else:
        raise SystemExit("--gen_dir or --network required")

    if ppl_only:
        real_source = None
    elif args.real_dir and args.conditional:
        real_source = _parts_source(args.real_dir, args.batch, args.resolution)
    elif args.real_dir:
        real_source = _folder_source(args.real_dir, args.batch, args.resolution)
    elif args.synthetic:
        real_source = _synthetic_real_source(args.synthetic, args.batch)
    else:
        raise SystemExit("--real_dir or --synthetic required")

    extractor = default_extractor(args.detector, device=device)
    results = []
    for metric in metrics:
        result = calc_metric(metric, real_source=real_source, gen_source=gen_source, extractor=extractor,
                             device=device, **ppl_kwargs)
        report_metric(result, run_dir=args.run_dir, snapshot=args.network or args.gen_dir)
        results.append(result)
    return results


if __name__ == "__main__":
    main()
