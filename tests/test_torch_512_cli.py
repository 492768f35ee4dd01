"""`cli.test_512` of the port on the CPU: at a thin width on the fixture,
triptych shapes, finite values, the result panel equal to a direct forward,
and the `--quant` / `--dp` refusals (tests/test_torch_dp_cli.py serves
`--dp`); its nearest resize equals `jax.image.resize`.
"""

import os

import numpy as np
import pytest
import torch

import jax

from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.cli import test_512 as cli512
from pasta_gan_tpu_torch.data import dataset as tds
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.models import Generator512, GeneratorFull

from _torch_native import jax_native_oracle  # noqa: F401  (autouse fixture)
from test_torch_512 import FIXTURE, _pair
from test_torch_512_model import THIN
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_tryon import _read_png


def _snapshot(tmp_path, **cfg):
    gen = Generator512(**cfg).reset_parameters(torch.Generator().manual_seed(0))
    snap = str(tmp_path / "snap512.pt")
    save_snapshot(snap, gen.state_dict(), 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1)),
                  {"model": gen.config, "generator": gen.variant})
    return snap


def test_cli_test_512_serves_the_fixture_on_cpu(tmp_path):
    snap = _snapshot(tmp_path, img_resolution=512, channel_base=1024, channel_max=16)
    # the fixture's 512 records with a pair list of its own (the encoders' 64 channels at 512x512 are slow here)
    root, ds = tmp_path / "upt", "UPT_subset1_512_320"
    os.makedirs(root / ds)
    for sub in ("image", "keypoints", "parsing"):
        os.symlink(os.path.join(FIXTURE, ds, sub), root / ds / sub)
    (root / ds / "test_pairs_front_list_shuffle_0508.txt").write_text(
        "upt512_0003.jpg upt512_0002.jpg\nupt512_0001.jpg upt512_0003.jpg\n")
    written = cli512.main(["--network", snap, "--dataroot", str(root), "--change_region", "upperbody",
                           "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["upt512_0003__upt512_0002.png", "upt512_0001__upt512_0003.png"]
    pngs = [_read_png(p) for p in written]
    assert all(p.shape == (512, 3 * 320, 3) for p in pngs)

    gen, w_avg = cli.load_generator(snap, "cpu")
    assert type(gen) is Generator512
    r = tds.UvitonDataset512Test(str(root), "upperbody")[1]
    batch = tds.prepare_tryon_batch_512(tds.collate([r["person"]]), tds.collate([r["garment"]]),
                                        change_region="upperbody", device="cpu")
    out = cli.tryon_forward(gen, w_avg, batch)
    assert bool(torch.isfinite(out).all())
    expect = np.clip((out[0, :, 96:416].numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    assert int(np.abs(pngs[1][:, 640:].astype(np.int32) - expect).max()) <= 1  # batch 2 vs batch 1 rounding
    assert int(np.abs(pngs[1][:, :320].astype(np.int32) - r["garment"]["image"][:, 96:416]).max()) <= 1
    person_panel = np.clip((batch["person_img"][0, :, 96:416].numpy() + 1.0) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(pngs[1][:, 320:640], person_panel)

    with pytest.raises(SystemExit, match="cli.test_512"):  # the 256 CLI refuses a 512 snapshot
        cli.main(["--network", snap, "--synthetic", "1", "--outdir", str(tmp_path), "--device", "cpu"])


def test_cli_test_512_refusals_and_resize(tmp_path, monkeypatch, capsys):
    snap = _snapshot(tmp_path, **THIN)
    base = ["--network", snap, "--synthetic", "2", "--outdir", str(tmp_path / "out"), "--device", "cpu"]
    # int8 serving: calibrated on the one batch of a synthetic pair, then served
    written = cli512.main(["--network", snap, "--synthetic", "1", "--outdir", str(tmp_path / "int8"),
                           "--device", "cpu", "--quant", "int8_static"])
    assert len(written) == 1 and _read_png(written[0]).shape == (256, 3 * 160, 3)
    assert "calibrated int8 activation scales on 1 batches" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--batchsize 3 must divide by the 2 local devices"):
        cli512.main(base + ["--dp", "--batchsize", "3"], devices=["cpu", "cpu"])
    full = GeneratorFull(img_resolution=256, channel_base=512, channel_max=32)
    save_snapshot(str(tmp_path / "full.pt"), full.state_dict(), torch.zeros(512), {"model": full.config})
    with pytest.raises(ValueError, match="512"):
        cli512.main(["--network", str(tmp_path / "full.pt")] + base[2:])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the entry points default to the card
    person, garment = _pair(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_batch_512(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        tds.prepare_tryon_grid_batch(person, garment)
    with pytest.raises(RuntimeError, match="cuda"):
        cli512.main(base[:-2])
    with pytest.raises(RuntimeError, match="CUDA devices"):  # --dp's default devices
        cli512.main(base + ["--dp"])
    monkeypatch.undo()
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
    for size in ((16, 16), (4, 4), (10, 7)):
        np.testing.assert_array_equal(cli512.resize_nearest(torch.from_numpy(x), size).numpy(),
                                      np.asarray(jax.image.resize(x, (2, *size, 3), "nearest")))
