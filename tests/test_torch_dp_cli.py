"""The port's several-card CLIs on the CPU.

* `cli.test --dp` and `cli.test_512 --dp` over `devices=[cpu, cpu]` (each
  device routes and runs its contiguous half of every global batch; the
  ragged last batch padded with its last pair) write the images of the same
  call without `--dp`, within the JAX package's limit for its `--dp`
  (tests/test_loop_cli.py:148: mean |difference| < 1.5 on uint8); a
  `--batchsize` that does not divide by the devices is refused in JAX's
  words.
* `cli.train` as two gloo ranks (tests/_torch_dist.py:cli_train_rank, a
  `file://` rendezvous) for two steps at global batch 4: both ranks end
  with bitwise equal G, D, G_ema and w_avg; only rank 0 wrote, and its
  training_options.json records `--kimg`; NCCL on a shared device or on
  the CPU, and an `--accum` that does not divide the per-rank batch, are
  refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.cli import test_512 as cli512
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.models import GeneratorFull
from pasta_gan_tpu_torch.models.generator_512 import Generator512

import _torch_dist
from test_torch_tryon import THIN, _read_png
from test_torch_train_loop import THIN as THIN_TRAIN
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

CPUS = ["cpu", "cpu"]
MEAN_DIFF = 1.5  # tests/test_loop_cli.py:148


def _snapshot(path, gen):
    gen = gen.reset_parameters(torch.Generator().manual_seed(0))
    save_snapshot(path, gen.state_dict(), 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(1)),
                  {"model": gen.config, "generator": gen.variant})
    return path


def _same_images(a, b):
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for x, y in zip(a, b):
        x, y = _read_png(x).astype(np.float64), _read_png(y).astype(np.float64)
        assert x.shape == y.shape and float(np.abs(x - y).mean()) < MEAN_DIFF, (x.shape, float(np.abs(x - y).mean()))


@pytest.mark.parametrize("which", ["test", "test_512"])
def test_dp_serving_equals_the_single_device_run(tmp_path, which):
    if which == "test":
        main, snap = cli.main, _snapshot(str(tmp_path / "full.pt"), GeneratorFull(**THIN))
    else:
        main = cli512.main
        snap = _snapshot(str(tmp_path / "512.pt"), Generator512(img_resolution=256, channel_base=1024, channel_max=16))
    base = ["--network", snap, "--synthetic", "3", "--batchsize", "2", "--device", "cpu"]
    one = main(base + ["--outdir", str(tmp_path / "one")])
    dp = main(base + ["--outdir", str(tmp_path / "dp"), "--dp"], devices=CPUS)
    assert len(dp) == 3  # the second batch is one pair, padded to two
    _same_images(dp, one)
    with pytest.raises(SystemExit, match="--dp: --batchsize 3 must divide by the 2 local devices"):
        main(base[:4] + ["--batchsize", "3", "--outdir", str(tmp_path / "x"), "--dp"], devices=CPUS)


def test_two_gloo_ranks_train_in_step_and_only_rank_0_writes(tmp_path):
    out = tmp_path / "runs"
    argv = ["--outdir", str(out), *THIN_TRAIN, "--synthetic", "4", "--batch", "4", "--kimg", "0.008", "--workers", "1"]
    ctx = _torch_dist.spawn_ranks(_torch_dist.cli_train_rank, str(tmp_path / "rdzv"), argv, str(tmp_path))
    _torch_dist.join(ctx)
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert (a["rank"], b["rank"], a["world"], b["world"]) == (0, 1, 2, 2)
    assert a["step"] == b["step"] == 2
    for name in ("G", "D", "G_ema"):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)
    assert torch.equal(a["w_avg"], b["w_avg"])
    assert b["run_dir"] is None and os.listdir(out) == [os.path.basename(a["run_dir"])]
    assert sorted(os.listdir(a["run_dir"])) == ["network-snapshot-000000.pt", "stats.jsonl", "train-state-latest.pt",
                                                "training_options.json"]
    with open(os.path.join(a["run_dir"], "training_options.json")) as f:
        assert json.load(f)["total_kimg"] == 0.008


def test_cli_train_refuses_what_the_ranks_cannot_run(tmp_path, monkeypatch):
    argv = ["--outdir", str(tmp_path), "--synthetic", "2", "--batch", "4"]
    with pytest.raises(SystemExit, match="nccl runs on CUDA devices"):
        cli_train.main(argv + ["--device", "cpu", "--dist_backend", "nccl"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(SystemExit, match="per-rank batch 2"):
        cli_train.main(argv + ["--device", "cpu", "--accum", "4", "--dry-run"])
    with pytest.raises(SystemExit, match="must divide over the 2 ranks"):
        cli_train.main(argv[:-1] + ["3", "--device", "cpu", "--dry-run"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="NCCL needs a device of its own for each rank"):
        cli_train.main(argv + ["--device", "cuda:0", "--dist_backend", "nccl"])
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(SystemExit, match="LOCAL_RANK 1 runs on cuda:1, and 1 CUDA devices are visible"):
        cli_train.main(argv)
    assert not os.listdir(tmp_path)
