"""The port's `stats.jsonl` rows (`runtime/stats.py`, `train/loop.py`) against
the JAX package's `Collector` / `JsonlLogger` (`pasta_gan_tpu/runtime/stats.py`).

* The port's Collector is a copy: fed the same values it gives the same
  moments, means, stds and rows, exactly.
* A `cli.train` run of three steps at a thin width (tick 0 holds step 1,
  tick 1 steps 2 and 3) writes one row per tick: {name: {num, mean, std}} for
  every per-step value (the step's stats and the `Timing/*` split), equal to a
  JAX Collector's row fed that tick's per-step values; `timestamp`; the JAX
  loop's five flat extras; and `Progress/step`, which the JAX loop does not
  write (a deliberate difference: the port's readers use it).
"""

import json
import os

import numpy as np
import pytest
import torch

from pasta_gan_tpu.runtime import stats as jstats
from pasta_gan_tpu_torch.cli import train as cli_train
from pasta_gan_tpu_torch.runtime import stats as tstats

JAX_EXTRAS = {"Progress/tick", "Progress/kimg", "Timing/sec_per_tick", "Timing/sec_per_kimg", "Timing/total_sec"}


def _row(logger_cls, collector, path, extra):
    log = logger_cls(path)
    log.write(collector, **extra)
    log.close()
    with open(path) as f:
        row = json.loads(f.read().splitlines()[-1])
    row.pop("timestamp")
    return row


def test_collector_and_logger_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    ours, theirs = tstats.Collector(regex="Loss/.*|Timing/.*"), jstats.Collector(regex="Loss/.*|Timing/.*")
    for step in range(5):
        vals = {"Loss/G/loss": rng.standard_normal(), "Loss/D/loss": rng.standard_normal(3),
                "Timing/data": abs(rng.standard_normal()), "Other/ignored": 1.0}
        if step % 2 == 0:
            vals["Loss/r1_penalty"] = rng.standard_normal()
        ours.report_dict(vals)
        theirs.report_dict(vals)
    ours.update()
    theirs.update()
    assert ours.names() == theirs.names() and "Other/ignored" not in ours.names()
    for name in ours.names():
        assert ours.mean(name) == theirs.mean(name) and ours.std(name) == theirs.std(name)
        assert ours[name] == theirs[name]
    assert np.isnan(ours.mean("Loss/absent")) and np.isnan(ours.std("Loss/absent"))
    extra = {"Progress/tick": 3, "Timing/sec_per_kimg": 1.5}
    assert _row(tstats.JsonlLogger, ours, tmp_path / "a.jsonl", extra) == \
        _row(jstats.JsonlLogger, theirs, tmp_path / "b.jsonl", extra)
    ours.update()  # nothing reported since the last update: an empty row
    assert ours.as_dict() == {}


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_train_rows_equal_a_jax_collector(tmp_path, one_torch_thread):
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.006", "--device", "cpu", "--synthetic", "2",
                          "--batch", "2", "--fmaps", str(256 / 32768), "--vgg_weight", "0", "--img_snap", "0",
                          "--aug", "noaug", "--kimg_per_tick", "1"])
    records = out["records"]
    assert len(records) == 3 and "Timing/Dreg" in records[0] and "Timing/Dreg" not in records[1]
    with open(os.path.join(out["run_dir"], "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    for tick, (row, steps) in enumerate(zip(rows, ([records[0]], records[1:]))):
        jax_collector = jstats.Collector()
        for rec in steps:
            jax_collector.report_dict(rec)
        jax_collector.update()
        want = jax_collector.as_dict()
        assert isinstance(row.pop("timestamp"), float)
        extras = {k: row.pop(k) for k in JAX_EXTRAS | {"Progress/step"}}
        assert row == want, tick
        assert {"Loss/G/loss", "Timing/data", "Timing/Gmain_Dmain"} <= set(row)
        assert row["Loss/G/loss"]["num"] == len(steps)
        assert extras["Progress/tick"] == tick and extras["Progress/step"] == (1, 3)[tick]
        assert extras["Progress/kimg"] == pytest.approx((0.002, 0.006)[tick])
        assert extras["Timing/sec_per_kimg"] == pytest.approx(extras["Timing/sec_per_tick"] / (0.002, 0.004)[tick])
