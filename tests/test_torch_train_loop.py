"""The port's training loop, checkpoints and CLI on the CPU (no JAX here).

* A train-state checkpoint restores every tensor and both Adam states bit
  for bit, and a step taken after the restore equals the step taken without
  it (tiny config, noise off).
* `cli.train.main` takes two steps at a thin width (channel_base 256) on the
  CPU, runs R1 on the first, writes a servable network snapshot and a
  train-state checkpoint, and `--resume` continues from it
  (tests/test_torch_train_ada_cli.py does the same with `--aug ada`).
* An unknown ADA pipe, or neither --data nor --synthetic, is refused; the
  trainer refuses only freeze_layers and Greg with z_dim > 0, which the JAX
  package does not run either.
"""

import dataclasses
import json
import os

import pytest
import torch

from pasta_gan_tpu_torch.cli import test as cli_test
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io.checkpoints import restore_train_state, save_train_state
from pasta_gan_tpu_torch.runtime import config as tconfig
from pasta_gan_tpu_torch.train.step import GANTrainer

RES, N = 16, 4
THIN = ["--device", "cpu", "--synthetic", "2", "--batch", "2", "--fmaps", str(256 / 32768), "--vgg_weight", "0",
        "--img_snap", "0", "--aug", "noaug"]  # grids: tests/test_torch_grids.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while this module runs: the test workers
    share the machine's cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(**kw):
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(img_resolution=RES, channel_base=256, channel_max=32, mbstd_group_size=2,
                                  use_noise=False),
        loss=tconfig.LossConfig(vgg_weight=0.0),
        ada=tconfig.AdaConfig(enabled=False), batch_size=N, **kw)


def tiny_batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn((N,) + s, generator=g)  # noqa: E731
    return {"real_img": r(RES, RES, 3).clamp(-1, 1), "style_input": r(RES, RES, 42), "retain": r(RES, RES, 3),
            "pose": r(RES, RES, 6), "denorm_upper_img": r(RES, RES, 3), "denorm_lower_img": r(RES, RES, 3),
            "denorm_upper_mask": (r(RES, RES, 1) > 0).float(), "denorm_lower_mask": (r(RES, RES, 1) > 0).float(),
            "gt_parsing": torch.randint(0, 6, (N, RES, RES), generator=g)}


def _equal_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for name in ("G", "D", "G_ema"):
        for k in sa[name]:
            torch.testing.assert_close(sa[name][k], sb[name][k], rtol=0, atol=0, msg=f"{name}.{k}")
    for name in ("g_opt", "d_opt"):
        for i, st in sa[name]["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(v, sb[name]["state"][i][k], rtol=0, atol=0)
    for k in ("w_avg", "pl_mean", "ada_p", "ada_signs_sum", "ada_signs_count"):
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)


def test_train_state_round_trip(tmp_path):
    cfg = tiny_config()
    trainer = GANTrainer(cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = tiny_batch()
    state, _ = trainer.train_step(state, batch)
    state, _ = trainer.d_r1_step(state, batch)
    path = str(tmp_path / "train-state.pt")
    save_train_state(path, state, dataclasses.asdict(cfg))

    other = trainer.init_state(torch.Generator().manual_seed(1))
    assert tconfig.from_dict(restore_train_state(path, other)) == cfg
    _equal_state(state, other)
    nxt = tiny_batch(1)
    a, stats_a = trainer.train_step(state, nxt)
    b, stats_b = trainer.train_step(other, nxt)
    _equal_state(a, b)
    assert {k: float(v) for k, v in stats_a.items()} == {k: float(v) for k, v in stats_b.items()}


def test_cli_train_two_steps_on_cpu_then_resume(tmp_path):
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.004", *THIN])
    run_dir, records = out["run_dir"], out["records"]
    assert out["state"].step == 2 and len(records) == 2
    assert "Loss/r1_penalty" in records[0] and "Loss/r1_penalty" not in records[1]  # R1 on step 0 of 16
    for r in records:
        for k, v in r.items():
            assert v == v and abs(v) != float("inf"), (k, v)
    files = sorted(os.listdir(run_dir))
    assert "network-snapshot-000000.pt" in files and "train-state-latest.pt" in files
    assert not [f for f in files if f.endswith(".png")]  # --img_snap 0 writes no grid
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert ticks[-1]["Progress/step"] == 2
    gen, w_avg = cli_test.load_generator(os.path.join(run_dir, "network-snapshot-000000.pt"), "cpu")
    torch.testing.assert_close(w_avg, out["state"].w_avg, rtol=0, atol=0)
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(v, out["state"].G_ema.state_dict()[k], rtol=0, atol=0)

    again = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.006", "--resume",
                            os.path.join(run_dir, "train-state-latest.pt"), *THIN])
    assert again["state"].step == 3 and len(again["records"]) == 1


@pytest.mark.parametrize("flags,slice_name", [
    (["--aug", "ada", "--augpipe", "bgcx"], "ADA"), (["--aug", "fixed", "--augpipe", "none"], "ADA"),
    ([], "--synthetic"),
])
def test_cli_train_refuses_later_slices(tmp_path, flags, slice_name):
    argv = ["--outdir", str(tmp_path), "--device", "cpu"] + (flags or []) + (["--synthetic", "2"] if flags else [])
    with pytest.raises(SystemExit, match=slice_name):
        cli_train.main(argv)


def test_trainer_refuses_unsupported_configs():
    """Only what the JAX package does not run either: freeze_layers (recorded,
    never applied) and Greg with z_dim > 0 (its mapping asserts a z)."""
    cfg = tiny_config()
    for kw, why in (({"model": dataclasses.replace(cfg.model, freeze_layers=2)}, "discriminator.py:39-49"),
                    ({"model": dataclasses.replace(cfg.model, z_dim=8), "loss": tconfig.LossConfig(pl_weight=1.0)},
                     "mapping.py:53-54")):
        with pytest.raises(ValueError, match=why):
            GANTrainer(dataclasses.replace(cfg, **kw), device="cpu")
    for kw in ({"loss": tconfig.LossConfig(contextual_weight=1.0, pl_weight=1.0)},
               {"model": dataclasses.replace(cfg.model, z_dim=8)}):
        GANTrainer(dataclasses.replace(cfg, **kw), device="cpu")
