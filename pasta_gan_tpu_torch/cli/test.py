"""256x192 unpaired try-on serving CLI (counterpart of `pasta_gan_tpu/cli/test.py`).

Loads a network snapshot, pairs persons with garments, routes the garment
patches into each person's pose on the device, runs the generator's explicit
encode_style / encode_pose / map_ws / synthesize sequence, un-pads the
256x256 canvas to 256x192 and writes `person__garment.png` files.

  python -m pasta_gan_tpu_torch.cli.test --network snapshot.pt --synthetic 16 \\
      --outdir ./test_results --batchsize 16 [--generator v18] [--denorm separate]

`--generator` names the interface: `full` (GeneratorFull, 42-channel style
input, `prepare_tryon_batch`) or `v18` (the released-256 checkpoint's
GeneratorV18, 60-channel style input, `prepare_tryon_batch_v18`); by default
the one the snapshot records.  `--denorm` picks the routing's denorm route:
`fused` (one composite kernel, the default) or `separate` (the denorm_warp
kernel, then threshold, erosion and composite as separate passes).

This slice serves the synthetic fixture (`--synthetic N`); the real test
pairs (`--dataroot`), int8 serving and multi-card serving come later.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


def save_image(arr: np.ndarray, path: str) -> None:
    """Write an HxWx3 image in [-1, 1] as an 8-bit RGB PNG (zlib + struct only)."""
    img = np.clip((np.asarray(arr, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


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
    from ..models import GENERATORS

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--network", required=True, help="network snapshot file (io/checkpoints.py)")
    p.add_argument("--synthetic", type=int, default=0, help="serve N synthetic person/garment pairs")
    p.add_argument("--outdir", required=True)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--truncation_psi", type=float, default=1.0)
    p.add_argument("--generator", choices=sorted(GENERATORS), default=None,
                   help="full: GeneratorFull (42-channel styles); v18: the released-256 interface "
                        "(60-channel norm + stickman styles); default: what the snapshot records")
    p.add_argument("--denorm", choices=DENORM_ROUTES, default="fused",
                   help="denorm route of the patch routing: one fused composite kernel, or the "
                        "denorm_warp kernel then separate threshold / erosion / composite passes")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.synthetic <= 0:
        raise SystemExit("--synthetic N is required: real test pairs (--dataroot) are not served yet")
    device = resolve_device(args.device)

    from ..data.dataset import SyntheticUvitonDataset, collate, prepare_tryon_batch, prepare_tryon_batch_v18

    os.makedirs(args.outdir, exist_ok=True)
    gen, w_avg = load_generator(args.network, device, args.generator)
    prepare = prepare_tryon_batch_v18 if gen.variant == "v18" else prepare_tryon_batch
    ds = SyntheticUvitonDataset(num_samples=args.synthetic)
    pairs = [(ds[i], ds[(i + 1) % len(ds)], f"s{i}", f"s{(i + 1) % len(ds)}") for i in range(len(ds))]

    written = []
    for i in range(0, len(pairs), args.batchsize):
        chunk = pairs[i : i + args.batchsize]
        batch = prepare(collate([c[0] for c in chunk]), collate([c[1] for c in chunk]), device=device,
                        denorm=args.denorm)
        out = tryon_forward(gen, w_avg, batch, args.truncation_psi).float()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the generator produced non-finite try-on images")
        out = out.cpu().numpy()
        for j, (_, _, pname, gname) in enumerate(chunk):
            path = os.path.join(args.outdir, f"{pname}__{gname}.png")
            save_image(out[j][:, 32:224, :], path)  # un-pad 256x256 -> 256x192
            written.append(path)
    print(f"wrote {len(written)} try-on images to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
