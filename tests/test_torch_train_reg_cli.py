"""Greg and the contextual loss through the port's training CLI, on the CPU
(no JAX here; tests/test_torch_train_reg.py holds the steps to JAX's).

`cli.train --pl_weight 2 --contextual_weight 1` takes two steps at a thin
width (channel_base 256) on 2 synthetic samples with the He-initialized
VGG19: Greg runs on the first step (g_reg_interval 4), before R1, and its
stats, `Timing/Greg` and the contextual loss reach `stats.jsonl`; the
train-state checkpoint holds pl_mean, and `--resume` restores it: the
resumed run's first Greg starts from it (its penalty and new pl_mean fit
only that start).  The contextual loss runs on relu4_2 and relu5_2 alone
here (CONTEXTUAL_TAPS patched): at 256x256 its relu1_2 term is a
65536 x 65536 affinity matrix a sample, minutes on one CPU thread.
"""

import json
import os

import torch

from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.io.checkpoints import restore_train_state
from pasta_gan_tpu_torch.train import vgg as tvgg

from test_torch_train_loop import THIN, one_torch_thread  # noqa: F401  (autouse fixture)

i = THIN.index("--vgg_weight")
REG = THIN[:i] + THIN[i + 2:] + ["--pl_weight", "2", "--contextual_weight", "1"]  # the VGG on


def test_cli_train_greg_and_contextual_then_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(tvgg, "CONTEXTUAL_TAPS", (9, 13))
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.004", *REG])
    run_dir, records, state = out["run_dir"], out["records"], out["state"]
    cfg = out["trainer"].config
    assert cfg.loss.pl_weight == 2 and cfg.loss.contextual_weight == 1 and cfg.loss.vgg_weight == 40
    assert state.step == 2 and len(records) == 2
    assert {"Timing/Greg", "Loss/pl_penalty", "Loss/G/reg", "Timing/Dreg"} <= set(records[0])
    assert "Timing/Greg" not in records[1] and "Loss/pl_penalty" not in records[1]
    for r in records:
        assert r["Loss/G/contextual"] > 0
        for k, v in r.items():
            assert v == v and abs(v) != float("inf"), (k, v)
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert {"Timing/Greg", "Loss/pl_penalty", "Loss/G/contextual"} <= set(ticks[0])
    assert "Loss/G/contextual" in ticks[1]
    pl_mean = float(state.pl_mean)
    assert pl_mean > 0

    ckpt = os.path.join(run_dir, "train-state-latest.pt")
    fresh = out["trainer"].init_state(torch.Generator().manual_seed(1))
    restore_train_state(ckpt, fresh)
    assert float(fresh.pl_mean) == pl_mean

    again = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.006", "--resume", ckpt, *REG])
    assert again["state"].step == 3 and len(again["records"]) == 1
    # one sample in the shrunk batch: new = m0 + decay (L - m0) and penalty = (L - new)^2
    rec, new, decay = again["records"][0], float(again["state"].pl_mean), cfg.loss.pl_decay
    length = pl_mean + (new - pl_mean) / decay
    assert abs(rec["Loss/pl_penalty"] - (length - new) ** 2) <= 1e-3 * rec["Loss/pl_penalty"]
