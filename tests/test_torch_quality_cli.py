"""The port's quality CLIs on the CPU at a thin width (no JAX here: the JAX
package's scripts are read, not run).

* `cli.quality_regression --device cpu`, two steps: the JSON line's keys are
  the JAX script's (`scripts/quality_regression.py`, read from its source)
  and `device`, every value is finite (`--quant int8_static`:
  tests/test_torch_quality_int8.py);
* `cli.eval_run_snapshots` over a `cli.train --device cpu` run that holds
  two network snapshots: two lines, oldest first, each the metrics of its
  snapshot's G_ema.
"""

import ast
import json
import math
import os

import torch

from pasta_gan_tpu_torch.cli import eval_run_snapshots
from pasta_gan_tpu_torch.cli import quality_regression
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, prepare_train_batch
from pasta_gan_tpu_torch.metrics import extractors, quality
from pasta_gan_tpu_torch.train import loop

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the smallest run: one batch of 2 at channel_base 512, channel_max 16 (the encoders stay 64 wide)
QR_THIN = ["--device", "cpu", "--steps", "2", "--samples", "2", "--batch", "2", "--channel_base", "512",
           "--channel_max", "16"]
TRAIN_THIN = ["--device", "cpu", "--synthetic", "2", "--batch", "2", "--fmaps", str(256 / 32768), "--vgg_weight", "0",
              "--img_snap", "0", "--aug", "noaug"]


def jax_script_keys(quant: bool):
    """The keys `scripts/quality_regression.py` prints: its `out = {...}`
    literal, and with `--quant` the `out[...] =` assignments."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "quality_regression.py")).read())
    keys, extra = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "out":
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name) and node.targets[0].value.id == "out"):
            extra.add(node.targets[0].slice.value)
    assert len(keys) == 11 and extra == {"fid_proxy_quant", "quant_pixel_l1", "quant_mode"}
    return keys | extra if quant else keys


def check_line(capsys, argv, quant):
    res = quality_regression.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res["result"]
    assert set(line) == jax_script_keys(quant) | {"device"}
    assert line["device"] == "cpu" and line["steps"] == 2 and line["samples"] == 2 and res["state"].step == 2
    for k, v in line.items():
        if isinstance(v, float):
            assert math.isfinite(v), (k, v)
    return line


def test_quality_regression_keys(capsys):
    line = check_line(capsys, QR_THIN, quant=False)
    assert (line["metric"], line["ada"], line["dtype"], line["seed_offset"]) == ("fid_proxy", "off", "float32", 0)


def test_eval_run_snapshots_over_a_training_run(tmp_path, capsys):
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.002", *TRAIN_THIN])
    run_dir, trainer, state = out["run_dir"], out["trainer"], out["state"]
    first = os.path.join(run_dir, "network-snapshot-000000.pt")
    assert os.path.isfile(first)
    # a later snapshot of the same run: one more step, saved by the loop's own writer as at 1 kimg
    ds = SyntheticUvitonDataset(num_samples=2, seed=0)
    batch = prepare_train_batch(collate([ds[0], ds[1]]), torch.Generator().manual_seed(7), device="cpu")
    state, _ = trainer.train_step(state, batch)
    loop._save_snapshot(run_dir, state, trainer.config, 1000, verbose=False)
    capsys.readouterr()
    recs = eval_run_snapshots.main([run_dir, "--samples", "2", "--batch", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [r["snapshot"] for r in lines] == ["network-snapshot-000000.pt", "network-snapshot-000001.pt"]
    assert [r["snapshot"] for r in recs] == [r["snapshot"] for r in lines]
    for r in lines:
        assert set(r) == {"snapshot", "fid_proxy", "recon_l1", "psnr_db", "samples"} and r["samples"] == 2
        assert all(math.isfinite(r[k]) for k in ("fid_proxy", "recon_l1", "psnr_db"))
    # the second line scores the state after the extra step, in float32 as the snapshot loads
    batches = quality.eval_batches(2, 2, device="cpu")
    fakes = quality.generate(state.G_ema.set_dtype(torch.float32).eval(), batches)
    ref = quality.quality_metrics(fakes, quality.reals_of(batches), extractors.jax_simpleconv("cpu"))
    assert all(abs(recs[1][k] - ref[k]) <= 1e-4 * max(1.0, abs(ref[k])) for k in ref), (recs[1], ref)
    assert recs[0]["recon_l1"] != recs[1]["recon_l1"]
