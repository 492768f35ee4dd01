"""`cli.train --img_snap 1` of the port on the CPU: one thin step writes every
grid file at its shape (tests/test_torch_train_loop.py runs `--img_snap 0`,
which writes none; the grids' contents against JAX:
tests/test_torch_grids_snapshot.py).
"""

import os

import numpy as np

from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.data import image_io

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

THIN = ["--device", "cpu", "--synthetic", "2", "--batch", "2", "--fmaps", str(256 / 32768), "--vgg_weight", "0",
        "--aug", "noaug", "--workers", "1"]


def test_cli_train_writes_every_grid(tmp_path):
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.002", "--img_snap", "1", "--snap", "0", *THIN])
    run_dir = out["run_dir"]
    assert out["state"].step == 1
    # grid_n = min(16, batch 2, 2 samples): 2 images side by side; a 2 x 2 try-on grid (gnum = min(6, 2))
    want = {name: (256, 512, 3) for name in ("reals.png", "init_denorm_upper.png", "init_denorm_lower.png",
                                              "init_retain.png", "fakes000000.png", "parsing000000.png")}
    want["tryon_grid000000.png"] = (512, 512, 3)
    pngs = sorted(f for f in os.listdir(run_dir) if f.endswith(".png"))
    assert pngs == sorted(want)
    for name, shape in want.items():
        img = image_io.read_image(os.path.join(run_dir, name))
        assert img.shape == shape and img.dtype == np.uint8, name
        assert img.any(), name
    reals = image_io.read_image(os.path.join(run_dir, "reals.png"))
    ds = tds.SyntheticUvitonDataset(num_samples=2, seed=0)
    expect = np.concatenate([ds[0]["image"], ds[1]["image"]], axis=1).astype(np.int32)
    assert int(np.abs(reals.astype(np.int32) - expect).max()) <= 1  # real_img in [-1, 1], back to 8 bits
