"""512x320 region-selectable try-on serving CLI (counterpart of `pasta_gan_tpu/cli/test_512.py`).

Loads a Generator512 network snapshot, pairs persons with garments, routes
the region's garment pieces into each person's pose on the device
(`prepare_tryon_batch_512`), runs the generator's explicit encode_style /
encode_pose / map_ws / synthesize sequence and writes one
garment | person | result triptych per pair, each panel un-padded from the
square canvas to the 512x320 aspect (96/512 of the width off each side):

  python -m pasta_gan_tpu_torch.cli.test_512 --network snapshot.pt --dataroot /path/to/UPT \\
      --outdir ./test_512 --batchsize 8 --change_region upperbody [--denorm separate]

`--change_region` picks which pieces route: `fullbody` (the garment's top
and pants), `upperbody` (its top, the person's own pants) or `lowerbody`
(the person's own top, its pants).  `--dataroot DIR` serves the pairs of
UPT_subset{1,2}_512_320/test_pairs_front_list_shuffle_0508.txt
(`UvitonDataset512Test`); `--synthetic N` serves N synthetic pairs instead,
drawn at 256x192 (left padding 32) and resized to the model's resolution by
nearest neighbour, as the JAX CLI does.  Output files are named
`<person>__<garment>.png`.  `--denorm` picks the routing's denorm route, as in
`cli/test.py`.  int8 serving (`--quant`) and several cards (`--dp`) are not
ported yet and refuse.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .test import load_generator, save_image, tryon_forward


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, *size, C] by nearest neighbour at half-pixel
    centres (`jax.image.resize(..., "nearest")`)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="nearest-exact").permute(0, 2, 3, 1)


def main(argv=None):
    from ..data.warp import CHANGE_REGIONS, DENORM_ROUTES

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--network", required=True, help="network snapshot of a Generator512 (io/checkpoints.py)")
    p.add_argument("--dataroot", default=None, help="root of the UPT 512x320 test layout")
    p.add_argument("--synthetic", type=int, default=0, help="serve N synthetic person/garment pairs instead")
    p.add_argument("--outdir", required=True)
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--change_region", default="fullbody", choices=CHANGE_REGIONS)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--denorm", choices=DENORM_ROUTES, default="fused",
                   help="denorm route of the patch routing: one fused composite kernel, or the "
                        "denorm_warp kernel then separate threshold / erosion / composite passes")
    p.add_argument("--quant", choices=["int8", "int8_static"], default=None, help="int8 serving (not ported yet)")
    p.add_argument("--dp", action="store_true", help="serving over several cards (not ported yet)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.quant is not None:
        raise SystemExit(f"--quant {args.quant}: int8 serving is a later slice of the port (ROADMAP §A 8)")
    if args.dp:
        raise SystemExit("--dp: serving over several cards is a later slice of the port (ROADMAP §A 11)")
    if args.synthetic <= 0 and args.dataroot is None:
        raise SystemExit("--dataroot DIR or --synthetic N is required")
    device = resolve_device(args.device)

    from ..data.dataset import SyntheticUvitonDataset, UvitonDataset512Test, collate, prepare_tryon_batch_512

    os.makedirs(args.outdir, exist_ok=True)
    gen, w_avg = load_generator(args.network, device, "512")
    res = gen.config["img_resolution"]
    if args.synthetic > 0:
        ds = SyntheticUvitonDataset(num_samples=args.synthetic)
        n_pairs = len(ds)

        def pair(i):
            return ds[i], ds[(i + 1) % len(ds)], f"s{i}.jpg", f"s{(i + 1) % len(ds)}.jpg"
    else:
        test_ds = UvitonDataset512Test(args.dataroot, change_region=args.change_region)
        n_pairs = len(test_ds)

        def pair(i):
            r = test_ds[i]
            return r["person"], r["garment"], r["person_name"], r["garment_name"]

    written = []
    for i in range(0, n_pairs, args.batchsize):
        chunk = [pair(k) for k in range(i, min(i + args.batchsize, n_pairs))]
        person, garment = collate([c[0] for c in chunk]), collate([c[1] for c in chunk])
        # the samples' square-padding x offset: 96 at 512x320, 32 for 256x192 samples
        batch = prepare_tryon_batch_512(person, garment, change_region=args.change_region,
                                        pad_x=float(person["left_padding"][0]), device=device, denorm=args.denorm)
        if batch["pose"].shape[1] != res:  # samples drawn at another size: every image to the model's, as JAX does
            batch = {k: resize_nearest(v, (res, res)) for k, v in batch.items()}
        out = tryon_forward(gen, w_avg, batch, args.truncation_psi).float()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the generator produced non-finite try-on images")
        g_img = torch.as_tensor(garment["image"]).float() / 127.5 - 1.0
        if g_img.shape[1] != res:
            g_img = resize_nearest(g_img, (res, res))
        g_img = g_img.numpy()
        p_img = batch["person_img"].float().cpu().numpy()
        out = out.cpu().numpy()
        crop = slice((res * 96) // 512, (res * (512 - 96)) // 512)
        for j, (_, _, pname, gname) in enumerate(chunk):
            strip = np.concatenate([g_img[j][:, crop], p_img[j][:, crop], out[j][:, crop]], axis=1)
            name = f"{os.path.basename(pname).split('.')[0]}__{os.path.basename(gname).split('.')[0]}.png"
            path = os.path.join(args.outdir, name)
            save_image(strip, path)
            written.append(path)
    print(f"wrote {len(written)} triptychs to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
