"""256x192 unpaired try-on serving CLI (counterpart of `pasta_gan_tpu/cli/test.py`).

Loads a network snapshot, pairs persons with garments, routes the garment
patches into each person's pose on the device, runs the generator's explicit
encode_style / encode_pose / map_ws / synthesize sequence, un-pads the
256x256 canvas to 256x192 and writes `person__garment.png` files.

  python -m pasta_gan_tpu_torch.cli.test --network snapshot.pt --dataroot /path/to/UPT \\
      --outdir ./test_results --batchsize 16 [--generator v18] [--denorm separate] \
      [--quant int8|int8_static [--calib_batches 2]]

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
is required.  `--quant` serves int8 (ops/quant.py): `int8` quantizes each
activation with its own per-sample scale; `int8_static` first calibrates the
activation scales on the first `--calib_batches` batches of the pairs
(`calibrate_int8_static`), then serves with them frozen.

`--dp` serves over every visible CUDA device from one process (JAX's
`--dp` over its local devices): the generator is replicated onto each
(after any int8_static calibration on the first), each global batch of
`--batchsize` pairs is split into contiguous chunks in device order, each
chunk is routed and run through the forward on its own device, and the
outputs are gathered back in order.  `--batchsize` must divide by the
device count; a ragged last batch is padded with its last pair to a
multiple of it.  Without `--dp` the same path runs over the one device
of `--device`.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import List, Optional, Sequence

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
def calibrate_int8_static(gen, w_avg, batches, truncation_psi: float = 1.0, noise_mode: str = "none") -> None:
    """int8_static serving: run the try-on forward in the "int8_calib" mode
    over `batches`, so that every activation site folds its per-tensor amax
    into its running `act_amax` (from zero), then freeze the scales:
    `gen.quant` is "int8_static" on return.  `noise_mode` as in
    `tryon_forward` (the quality tools calibrate with "const")."""
    from ..ops.quant import reset_quant_scales

    if not batches:
        raise SystemExit(
            "--quant int8_static: no calibration batches could be built "
            "(empty pairs list — check --dataroot / --synthetic)"
        )
    reset_quant_scales(gen)
    gen.quant = "int8_calib"
    for b in batches:
        tryon_forward(gen, w_avg, b, truncation_psi, noise_mode)
    gen.quant = "int8_static"


@torch.no_grad()
def tryon_forward(gen, w_avg, batch, truncation_psi: float = 1.0, noise_mode: str = "none") -> torch.Tensor:
    """The explicit style / pose / mapping / synthesis calls; returns the
    finetune image [B, H, W, 3] (NHWC) of either interface.  Serving runs
    without noise; "const" adds the fixed noise maps."""
    from ..models.generator_full import cat_feats_dict

    stylecode, feats = gen.encode_style(batch["style_input"], batch["retain"])
    pose_feat = gen.encode_pose(batch["pose"])
    ws, _ = gen.map_ws(None, stylecode, w_avg=w_avg, truncation_psi=truncation_psi)
    return gen.synthesize(
        ws, pose_feat, cat_feats_dict(feats),
        batch["denorm_upper_img"], batch["denorm_lower_img"],
        batch["denorm_upper_mask"], batch["denorm_lower_mask"],
        noise_mode=noise_mode,
    )[1]


def replicate_generator(gen, w_avg, devices: Sequence[torch.device]):
    """[(generator, w_avg)] on each of `devices`: `gen` itself on the first, copies on the others."""
    return [(gen, w_avg)] + [(copy.deepcopy(gen).to(d), w_avg.to(d)) for d in devices[1:]]


def serving_devices(args, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices that serve: `--dp`'s (`devices`, else every visible CUDA
    device), refusing a `--batchsize` that does not divide by their count, or
    the one device of `--device` without `--dp`."""
    if not args.dp:
        return [resolve_device(args.device)]
    from ..parallel import mesh

    devices = [torch.device(d) for d in devices] if devices is not None else mesh.data_parallel_devices()
    if args.batchsize % len(devices):
        raise SystemExit(f"--dp: --batchsize {args.batchsize} must divide by the {len(devices)} local devices")
    return devices


def dp_forward(replicas, person, garment, route, truncation_psi: float) -> List:
    """One global batch over the replicas: the collated `person` / `garment`
    dicts padded with their last pair to a multiple of the replica count,
    split into contiguous chunks in device order (`mesh.shard_batch`), each
    routed by `route(person, garment, device)` -> batch and run by
    `tryon_forward` on its own device.  Returns [(chunk output, chunk batch)]
    in device order; the outputs of the padding are part of the last chunk's."""
    from ..parallel import mesh

    n = len(next(iter(person.values())))
    extra = -n % len(replicas)
    pad = lambda d: {k: np.concatenate([v, np.repeat(v[-1:], extra, axis=0)]) for k, v in d.items()}  # noqa: E731
    person, garment = pad(person), pad(garment)
    out = []
    for r, (gen, w_avg) in enumerate(replicas):
        batch = route(mesh.shard_batch(person, r, len(replicas)), mesh.shard_batch(garment, r, len(replicas)),
                      w_avg.device)
        out.append((tryon_forward(gen, w_avg, batch, truncation_psi), batch))
    return out


def add_dp_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", action="store_true",
                   help="data-parallel serving over every visible CUDA device (the global --batchsize, which must "
                        "divide by the device count, is split across them)")


def add_quant_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--quant", choices=["int8", "int8_static"], default=None,
                   help="int8 serving (ops/quant.py): 'int8' = per-sample activation scales; 'int8_static' = "
                        "activation scales calibrated on the first --calib_batches batches, then frozen")
    p.add_argument("--calib_batches", type=int, default=2, help="batches that calibrate the int8_static scales")


def set_quant(gen, w_avg, args, n_pairs: int, batch_at) -> None:
    """Put `gen` in the serving mode of `--quant`; for int8_static, calibrate
    first on the batches that start at 0, B, ... below --calib_batches * B
    pairs (`batch_at(i)` routes the batch that starts at pair i)."""
    if args.quant == "int8_static":
        B = args.batchsize
        batches = [batch_at(i) for i in range(0, min(n_pairs, args.calib_batches * B), B)]
        calibrate_int8_static(gen, w_avg, batches, args.truncation_psi)
        print(f"calibrated int8 activation scales on {len(batches)} batches")
    else:
        gen.quant = args.quant


def main(argv=None, devices: Optional[Sequence] = None):
    """The CLI; `devices` replaces `--dp`'s default device list (tests pass CPU devices)."""
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
    add_quant_args(p)
    add_dp_arg(p)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'; --dp serves on its own devices")
    args = p.parse_args(argv)
    if args.synthetic <= 0 and args.dataroot is None:
        raise SystemExit("--dataroot DIR or --synthetic N is required")
    devices = serving_devices(args, devices)

    from ..data.dataset import (
        SyntheticUvitonDataset, UvitonDataset256Test, collate, prepare_tryon_batch, prepare_tryon_batch_v18,
    )

    os.makedirs(args.outdir, exist_ok=True)
    gen, w_avg = load_generator(args.network, devices[0], args.generator)
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

    def route(person, garment, dev):
        return prepare(person, garment, device=dev, denorm=args.denorm)

    def make_batch(i):
        chunk = [pair(k) for k in range(i, min(i + args.batchsize, n_pairs))]
        return chunk, collate([c[0] for c in chunk]), collate([c[1] for c in chunk])

    set_quant(gen, w_avg, args, n_pairs, lambda i: route(*make_batch(i)[1:], devices[0]))
    replicas = replicate_generator(gen, w_avg, devices)
    written = []
    for i in range(0, n_pairs, args.batchsize):
        chunk, person, garment = make_batch(i)
        out = torch.cat([o.float().cpu() for o, _ in dp_forward(replicas, person, garment, route, args.truncation_psi)])
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the generator produced non-finite try-on images")
        out = out.numpy()
        for j, (_, _, pname, gname) in enumerate(chunk):
            name = f"{os.path.basename(pname).split('.')[0]}__{os.path.basename(gname).split('.')[0]}.png"
            path = os.path.join(args.outdir, name)
            save_image(out[j][:, 32:224, :], path)  # un-pad 256x256 -> 256x192
            written.append(path)
    print(f"wrote {len(written)} try-on images to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
