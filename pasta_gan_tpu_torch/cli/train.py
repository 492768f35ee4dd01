"""Training CLI (counterpart of `pasta_gan_tpu/cli/train.py`).

Trains the 256px GeneratorFull against the resnet Discriminator on one card,
with ADA augmentation in front of D by default (`--aug ada`: the `bgc` pipe,
the two-pass affine warp, stacked D calls, p adjusted towards `--target`),
bf16 compute over fp32 master weights by default, and the losses of record
(L1 40, VGG 40, mask 20, R1 gamma from the preset, R1 every 16 steps);
`--pl_weight` adds path-length regularization every 4 steps and
`--contextual_weight` the contextual loss on the finetune image:

  python -m pasta_gan_tpu_torch.cli.train --outdir ./runs --data /path/to/UPT \\
      --cfg fashion --batch 32 --kimg 100 --workers 3 --snap 50 --aug ada

`--data DIR` reads the UPT 256x192 training layout (`UvitonDatasetFull`:
{Zalando,Zalora,Deepfashion,MPV}_256_192 with their train_pairs_front_list_0508.txt
and train_random_mask_acgpn/), decoded on the host by `--workers` threads
ahead of the card; `--synthetic N` trains on N synthetic samples instead.
One of the two is required.

`--aug fixed` starts at `--p` and, as in the JAX package, runs the same
controller (ROADMAP notes the difference from the reference, which keeps p
fixed); `--aug noaug` runs no pipe.  `--ada_exact_geom` swaps the two-pass
warp for the exact bilinear one and, unless `--ada_stack_calls` is given,
runs the D calls one by one.

`--kimg` and `--kimg_per_tick` may be fractional (0.128 kimg at batch 32 is
4 steps).  The run directory gets training_options.json, stats.jsonl (one
line a tick), and every `--snap` ticks and at the end a network snapshot of
G_ema (network-snapshot-<kimg>.pt, servable by `pasta_gan_tpu_torch.cli.test
--network`) and train-state-latest.pt (for `--resume`); the image grids
(reals.png and init_*.png once, fakes<kimg>.png, parsing<kimg>.png and
tryon_grid<kimg>.png every `--img_snap` ticks from tick 0 and at the end;
`--img_snap 0` writes none).  Without
`--vgg_ckpt` (a torchvision vgg19 state_dict already on disk) the perceptual
loss uses a He-initialized VGG19; nothing is downloaded.  The contextual
loss runs only with that VGG loaded, as in the JAX package: with
`--vgg_weight 0` it is off.  `-n/--dry-run` prints the resolved config and
exits.

Several cards: one process per card under torchrun, each rank on
cuda:LOCAL_RANK with 1/world of the global `--batch`, gradients and stats
averaged over the ranks at every step (`parallel/mesh.py`), NCCL by
default on CUDA and gloo on the CPU (`--dist_backend`):

  torchrun --standalone --nproc_per_node 4 -m pasta_gan_tpu_torch.cli.train --outdir ./runs \
      --data /path/to/UPT --batch 32 --kimg 100

`--device cuda:N` puts every rank on device N, which only gloo allows
(NCCL needs a device per rank): two ranks can share one card that way.
`--dist_init` is the rendezvous (default `env://`, torchrun's; a
`file://` path on a shared file system works as the reference's did).
`--accum` must divide the per-rank batch.  Only rank 0 writes the run
directory; G and D are checked bitwise equal on every rank before each
snapshot.

`--resume` takes this package's train state (train-state-*.pt: the whole
state is restored), a network pickle for transfer learning (a legacy
TensorFlow StyleGAN2 export or a reference snapshot: the tensors whose
names and shapes agree are copied into the fresh G, G_ema and D,
`io/transfer.py`), one of the reference's presets (`RESUME_SPECS`: ffhq256,
ffhq512, ffhq1024, celebahq256, lsundog256) or `noresume`.  A preset is read
from the `open_url` cache, `~/.cache/pasta_gan_tpu/<md5(url)>_<file name>`;
nothing is downloaded.  Any resume from a file sets the ADA horizon
`ada.kimg` to 100, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import re
import zipfile

import torch

from .. import resolve_device
from ..parallel import mesh


# the reference's transfer-learning presets (train_wo_flow_fullbody.py:319-325)
_NETS = "https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/"
RESUME_SPECS = {
    "ffhq256": _NETS + "ffhq-res256-mirror-paper256-noaug.pkl",
    "ffhq512": _NETS + "ffhq-res512-mirror-stylegan2-noaug.pkl",
    "ffhq1024": _NETS + "ffhq-res1024-mirror-stylegan2-noaug.pkl",
    "celebahq256": _NETS + "celebahq-res256-mirror-paper256-kimg100000-ada-target0.5.pkl",
    "lsundog256": _NETS + "lsundog-res256-paper256-kimg100000-noaug.pkl",
}


def _no_download(url: str):
    raise IOError(f"{url} is not in the cache, and nothing is downloaded")


def resolve_resume(resume):
    """`--resume`'s value -> (file or None, the run-dir desc suffix the JAX
    CLI appends): a preset resolves through the `open_url` cache alone."""
    if resume is None:
        return None, ""
    if resume == "noresume":
        return None, "-noresume"
    if resume in RESUME_SPECS:
        from ..utils import open_url

        url = RESUME_SPECS[resume]
        try:
            path = open_url(url, return_filename=True, num_attempts=1, _fetch=_no_download)
        except IOError as e:
            raise SystemExit(
                f"--resume {resume}: the preset pickle is not in the open_url cache ({e}); download {url} "
                "elsewhere and place it in ~/.cache/pasta_gan_tpu as <md5(url)>_<file name> (WEIGHTS.md), "
                "or pass a local .pkl path")
        return path, f"-resume{resume}"
    if not os.path.isfile(resume):
        raise SystemExit(f"--resume {resume}: no such file, and not a preset ({', '.join(RESUME_SPECS)})")
    # this package's train state is a torch.save zip; anything else is a network pickle
    return resume, "" if zipfile.is_zipfile(resume) else "-resumecustom"


def make_run_dir(outdir: str, desc: str) -> str:
    """NNNNN-desc run-dir numbering (reference train_wo_flow_fullbody.py:525-532)."""
    os.makedirs(outdir, exist_ok=True)
    prev = [int(m.group(1)) for d in os.listdir(outdir) if (m := re.match(r"^(\d+)-", d))]
    run_dir = os.path.join(outdir, f"{max(prev, default=-1) + 1:05d}-{desc}")
    os.makedirs(run_dir)
    return run_dir


def _kimg(value: str):
    """`--kimg`: an integer as the JAX CLI parses it, or a fraction of one."""
    try:
        return int(value)
    except ValueError:
        return float(value)


def rank_device(device: str, backend: str, world: int, local_rank: int) -> torch.device:
    """The device of this rank: `device` on one process; with several ranks,
    cuda:LOCAL_RANK for "cuda", device N for all of them for "cuda:N" (gloo
    only), or the CPU (gloo only).  Every refusal is a SystemExit."""
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise SystemExit(f"--dist_backend nccl runs on CUDA devices, not {device}; the CPU takes gloo")
    if world <= 1 or dev.type != "cuda":
        return resolve_device(dev)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.index is None:
        if local_rank >= n:
            raise SystemExit(f"LOCAL_RANK {local_rank} runs on cuda:{local_rank}, and {n} CUDA devices are visible; "
                             "--device cuda:N puts every rank on device N (with --dist_backend gloo)")
        dev = torch.device("cuda", local_rank)
    else:
        if backend == "nccl":
            raise SystemExit(f"--device {device} puts all {world} ranks on one device, and NCCL needs a device of "
                             "its own for each rank; --dist_backend gloo shares one")
        if dev.index >= n:
            raise SystemExit(f"--device {device}: {n} CUDA devices are visible")
    torch.cuda.set_device(dev)
    return dev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", required=True)
    p.add_argument("--data", default=None, help="root of the UPT 256x192 training layout")
    p.add_argument("--synthetic", type=int, default=0, help="train on N synthetic samples instead of --data")
    p.add_argument("--cfg", default="fashion", help="config preset (runtime/config.py:CFG_SPECS)")
    p.add_argument("--batch", type=int, default=None, help="global batch (default: the preset's)")
    p.add_argument("--kimg", type=_kimg, default=None, help="thousands of images to train on (may be fractional)")
    p.add_argument("--fmaps", type=float, default=None, help="channel_base multiplier override (x 32768)")
    p.add_argument("--accum", type=int, default=None,
                   help="gradient-accumulation microbatches per phase; must divide the batch")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="compute dtype (fp32 master weights either way)")
    p.add_argument("--aug", default="ada", choices=["ada", "noaug", "fixed"])
    p.add_argument("--p", type=float, default=0.0, help="initial augment probability")
    p.add_argument("--target", type=float, default=0.6, help="ADA target for the mean sign of D(real)")
    p.add_argument("--augpipe", default="bgc", help="ADA pipe preset (train/augment.py:AUGPIPE_SPECS)")
    p.add_argument("--ada_fast_geom", action="store_true",
                   help="(default) the two-pass affine ADA warp; kept for the JAX CLI's invocations")
    p.add_argument("--ada_exact_geom", action="store_true",
                   help="the exact bilinear ADA warp; also runs the D calls one by one unless --ada_stack_calls")
    p.add_argument("--ada_stack_calls", action="store_true",
                   help="one stacked ADA+D call per loss (default with the two-pass warp)")
    p.add_argument("--l1_weight", type=float, default=40.0)
    p.add_argument("--vgg_weight", type=float, default=40.0)
    p.add_argument("--mask_weight", type=float, default=20.0)
    p.add_argument("--gamma", type=float, default=None, help="R1 weight (default: the preset's)")
    p.add_argument("--pl_weight", type=float, default=0.0,
                   help="path-length regularization weight (Greg every g_reg_interval steps)")
    p.add_argument("--contextual_weight", type=float, default=0.0,
                   help="contextual loss weight (needs the VGG, i.e. --vgg_weight > 0)")
    p.add_argument("--vgg_ckpt", default=None, help="torchvision vgg19 state_dict file on disk")
    p.add_argument("--resume", default=None,
                   help="this package's train state (train-state-*.pt, full resume), a network .pkl for transfer "
                        "learning (a legacy TF StyleGAN2 export or a reference snapshot: name and shape matches "
                        "copy in), a preset (ffhq256, ffhq512, ffhq1024, celebahq256, lsundog256; read from the "
                        "open_url cache) or noresume")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snap", type=int, default=50, help="network snapshot interval in ticks")
    p.add_argument("--img_snap", type=int, default=None,
                   help="image grid interval in ticks (default: the config's 50; 0 writes no grids)")
    p.add_argument("--kimg_per_tick", type=float, default=None, help="thousands of images a tick (default: the preset's)")
    p.add_argument("--workers", type=int, default=None, help="host decode threads (default: the preset's)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: cuda:LOCAL_RANK under torchrun), 'cuda:N' (every rank on device N) or 'cpu'")
    p.add_argument("--dist_backend", choices=mesh.BACKENDS, default=None,
                   help="collectives of a run of several ranks (default: nccl on CUDA, gloo on the CPU)")
    p.add_argument("--dist_init", default="env://",
                   help="the ranks' rendezvous: env:// (torchrun's) or file:///shared/path")
    p.add_argument("-n", "--dry-run", action="store_true",
                   help="print the resolved config and exit before any data, device or VGG is touched")
    args = p.parse_args(argv)

    from ..runtime.config import from_preset, replace_nested, to_json
    from ..train.augment import AUGPIPE_SPECS

    config = from_preset(args.cfg, batch=args.batch)
    overrides = {
        "loss.l1_weight": args.l1_weight, "loss.vgg_weight": args.vgg_weight,
        "loss.mask_weight": args.mask_weight, "loss.pl_weight": args.pl_weight,
        "loss.contextual_weight": args.contextual_weight,
        "ada.enabled": args.aug != "noaug", "ada.target": args.target, "ada.pipe": args.augpipe,
        "ada.initial_p": args.p, "ada.fast_geom": not args.ada_exact_geom,
        "ada.stack_calls": args.ada_stack_calls or not args.ada_exact_geom,
        "random_seed": args.seed, "compute_dtype": args.dtype, "network_snapshot_ticks": args.snap,
    }
    if args.gamma is not None:
        overrides["loss.r1_gamma"] = args.gamma
    if args.kimg is not None:
        overrides["total_kimg"] = args.kimg
    if args.kimg_per_tick is not None:
        overrides["kimg_per_tick"] = args.kimg_per_tick
    if args.workers is not None:
        overrides["data_workers"] = args.workers
    if args.img_snap is not None:
        overrides["image_snapshot_ticks"] = args.img_snap
    if args.augpipe not in AUGPIPE_SPECS:
        raise SystemExit(f"--augpipe {args.augpipe}: not an ADA pipe preset ({', '.join(AUGPIPE_SPECS)})")
    resume, resume_desc = resolve_resume(args.resume)
    if resume is not None:
        # the JAX CLI's rule: ADA reacts faster when resuming from a file
        overrides["ada.kimg"] = 100
    if args.fmaps is not None:
        overrides["model.channel_base"] = int(args.fmaps * 32768)
    _, world, local_rank = mesh.env_rank_world()
    if config.batch_size % world:
        raise SystemExit(f"--batch {config.batch_size} must divide over the {world} ranks")
    if args.accum is not None:
        per_rank = config.batch_size // world
        if per_rank % args.accum:
            where = (f"--batch {per_rank}" if world == 1 else
                     f"the per-rank batch {per_rank} (--batch {config.batch_size} over {world} ranks)")
            raise SystemExit(f"--accum {args.accum} must divide {where}")
        overrides["accum_steps"] = args.accum
    config = replace_nested(config, **overrides)
    if args.dry_run:
        print("Resolved training config:")
        print(to_json(config))
        print("\nDry run: exiting (reference --dry-run semantics).")
        return None
    if args.synthetic <= 0 and args.data is None:
        raise SystemExit("--data DIR or --synthetic N is required")
    backend = args.dist_backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    device = rank_device(args.device, backend, world, local_rank)
    group = mesh.initialize_distributed(backend, init_method=args.dist_init)
    try:
        return _train(args, config, resume, resume_desc, device, group)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def _train(args, config, resume, resume_desc, device, group):
    main_rank = mesh.rank(group) == 0

    from ..data.dataset import SyntheticUvitonDataset, UvitonDatasetFull
    from ..train.loop import training_loop
    from ..train.vgg import init_vgg19, load_torch_vgg19

    vgg = None
    if config.loss.vgg_weight > 0:
        if args.vgg_ckpt:
            if not os.path.exists(args.vgg_ckpt):
                raise SystemExit(f"--vgg_ckpt {args.vgg_ckpt}: no such file (nothing is downloaded)")
            vgg = load_torch_vgg19(args.vgg_ckpt, device)
            if main_rank:
                print(f"loaded VGG19 weights from {args.vgg_ckpt}")
        else:
            if main_rank:
                print("WARNING: no --vgg_ckpt; the perceptual loss uses a randomly initialized VGG19")
            vgg = init_vgg19(torch.Generator().manual_seed(0), device)

    if args.synthetic > 0:
        dataset, desc = SyntheticUvitonDataset(num_samples=args.synthetic, seed=args.seed), "-synthetic"
    else:
        dataset, desc = UvitonDatasetFull(args.data, random_seed=args.seed), ""
    run_dir = None
    if main_rank:
        run_dir = make_run_dir(args.outdir, f"{args.cfg}-batch{config.batch_size}{desc}{resume_desc}")
        ranks = f"; {mesh.world(group)} ranks over {torch.distributed.get_backend(group)}" if group is not None else ""
        print(f"run dir: {run_dir}; device: {device}; {len(dataset)} training samples{ranks}")
    trainer, state, records = training_loop(run_dir, dataset, config, device=device, vgg=vgg, resume=resume,
                                            group=group)
    return {"run_dir": run_dir, "trainer": trainer, "state": state, "records": records,
            "rank": mesh.rank(group), "world": mesh.world(group)}


if __name__ == "__main__":
    main()
