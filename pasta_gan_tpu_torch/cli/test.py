"""256x192 unpaired try-on serving CLI (counterpart of `pasta_gan_tpu/cli/test.py`).

Loads a network snapshot, pairs persons with garments, routes the garment
patches into each person's pose on the device, runs the generator's explicit
encode_style / encode_pose / map_ws / synthesize sequence, un-pads the
256x256 canvas to 256x192 and writes `person__garment.png` files.

  python -m pasta_gan_tpu_torch.cli.test --network snapshot.pt --dataroot /path/to/UPT \\
      --outdir ./test_results --batchsize 16 [--generator v18] [--denorm separate]

`--generator` names the interface: `full` (GeneratorFull, 42-channel style
input, `prepare_tryon_batch`) or `v18` (the released-256 checkpoint's
GeneratorV18, 60-channel style input, `prepare_tryon_batch_v18`); by default
the one the snapshot records.  `--denorm` picks the routing's denorm route:
`fused` (one composite kernel, the default) or `separate` (the denorm_warp
kernel, then threshold, erosion and composite as separate passes).

`--dataroot DIR` serves the unpaired test pairs of the UPT 256x192 layout
(`UvitonDataset256Test`: UPT_subset{1,2}_256_192/test_pairs_front_list_shuffle_0508.txt),
decoded on the host a batch at a time; output files are named
`<person>__<garment>.png` after the two image names without their
extensions.  `--synthetic N` serves N synthetic pairs instead; one of the two
is required.  int8 and multi-card serving come later.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


def save_image(arr: np.ndarray, path: str) -> None:
    """Write an HxWx3 image in [-1, 1] as an 8-bit RGB PNG (`data/image_io.py:write_png`)."""
    from ..data.image_io import write_png

    write_png(np.clip((np.asarray(arr, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8), path)


def load_generator(network: str, device="cuda", generator: Optional[str] = None):
    """Build the generator a snapshot holds (its recorded variant, "full" for
    a snapshot that records none) on `device`; returns (generator, w_avg).
    `generator`, when given, must name that variant."""
    from ..io.checkpoints import load_snapshot
    from ..models import GENERATORS

    device = resolve_device(device)
    state_dict, w_avg, config = load_snapshot(network)
    variant = config.get("generator", "full")
    if generator is not None and generator != variant:
        raise ValueError(f"{network} holds a {variant!r} generator, not {generator!r}")
    gen = GENERATORS[variant](**config.get("model", {}))  # the constructor arguments `save_snapshot` was given
    gen.load_state_dict(state_dict, strict=True)
    return gen.to(device).eval(), w_avg.to(device)


@torch.no_grad()
def tryon_forward(gen, w_avg, batch, truncation_psi: float = 1.0) -> torch.Tensor:
    """The explicit style / pose / mapping / synthesis calls; returns the
    finetune image [B, H, W, 3] (NHWC) of either interface."""
    from ..models.generator_full import cat_feats_dict

    stylecode, feats = gen.encode_style(batch["style_input"], batch["retain"])
    pose_feat = gen.encode_pose(batch["pose"])
    ws, _ = gen.map_ws(None, stylecode, w_avg=w_avg, truncation_psi=truncation_psi)
    return gen.synthesize(
        ws, pose_feat, cat_feats_dict(feats),
        batch["denorm_upper_img"], batch["denorm_lower_img"],
        batch["denorm_upper_mask"], batch["denorm_lower_mask"],
        noise_mode="none",
    )[1]


def main(argv=None):
    from ..data.warp import DENORM_ROUTES

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--network", required=True, help="network snapshot file (io/checkpoints.py)")
    p.add_argument("--dataroot", default=None, help="root of the UPT 256x192 test layout")
    p.add_argument("--synthetic", type=int, default=0, help="serve N synthetic person/garment pairs instead")
    p.add_argument("--outdir", required=True)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--generator", choices=["full", "v18"], default=None,
                   help="full: GeneratorFull (42-channel styles); v18: the released-256 interface "
                        "(60-channel norm + stickman styles); default: what the snapshot records")
    p.add_argument("--denorm", choices=DENORM_ROUTES, default="fused",
                   help="denorm route of the patch routing: one fused composite kernel, or the "
                        "denorm_warp kernel then separate threshold / erosion / composite passes")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.synthetic <= 0 and args.dataroot is None:
        raise SystemExit("--dataroot DIR or --synthetic N is required")
    device = resolve_device(args.device)

    from ..data.dataset import (
        SyntheticUvitonDataset, UvitonDataset256Test, collate, prepare_tryon_batch, prepare_tryon_batch_v18,
    )

    os.makedirs(args.outdir, exist_ok=True)
    gen, w_avg = load_generator(args.network, device, args.generator)
    if gen.variant not in ("full", "v18"):
        raise SystemExit(f"{args.network} holds a {gen.variant!r} generator: serve it with cli.test_{gen.variant}")
    prepare = prepare_tryon_batch_v18 if gen.variant == "v18" else prepare_tryon_batch
    if args.synthetic > 0:
        ds = SyntheticUvitonDataset(num_samples=args.synthetic)
        n_pairs = len(ds)

        def pair(i):
            return ds[i], ds[(i + 1) % len(ds)], f"s{i}", f"s{(i + 1) % len(ds)}"
    else:
        test_ds = UvitonDataset256Test(args.dataroot)
        n_pairs = len(test_ds)

        def pair(i):
            r = test_ds[i]
            return r["person"], r["garment"], r["person_name"], r["garment_name"]

    written = []
    for i in range(0, n_pairs, args.batchsize):
        chunk = [pair(k) for k in range(i, min(i + args.batchsize, n_pairs))]
        batch = prepare(collate([c[0] for c in chunk]), collate([c[1] for c in chunk]), device=device,
                        denorm=args.denorm)
        out = tryon_forward(gen, w_avg, batch, args.truncation_psi).float()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the generator produced non-finite try-on images")
        out = out.cpu().numpy()
        for j, (_, _, pname, gname) in enumerate(chunk):
            name = f"{os.path.basename(pname).split('.')[0]}__{os.path.basename(gname).split('.')[0]}.png"
            path = os.path.join(args.outdir, name)
            save_image(out[j][:, 32:224, :], path)  # un-pad 256x256 -> 256x192
            written.append(path)
    print(f"wrote {len(written)} try-on images to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
