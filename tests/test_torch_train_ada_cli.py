"""`cli.train --aug ada` on the CPU (no JAX here): two steps at a thin width
(channel_base 256, batch 2) with the `bgc` pipe from `--p 0.3`, then one
more through `--resume`.  The ADA probability and the sign counters carry
across the checkpoint, the resumed run takes `ada.kimg` 100 (the JAX CLI's
rule for a resume from a file), and the stats stay finite.
"""

import json
import math
import os

import pytest

from pasta_gan_tpu_torch.cli import train as cli_train

from test_torch_train_loop import THIN
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

THIN_ADA = THIN[:-2] + ["--aug", "ada", "--p", "0.3"]


def test_cli_train_ada_two_steps_then_resume_carries_p_and_counters(tmp_path):
    out = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.004", *THIN_ADA])
    state, records = out["state"], out["records"]
    assert state.step == 2 and float(state.ada_p) == pytest.approx(0.3)
    assert "Loss/r1_penalty" in records[0]  # R1 through the pipe on the first step
    assert all(math.isfinite(v) for r in records for v in r.values())
    assert [r["Progress/augment_p"] for r in records] == [pytest.approx(0.3)] * 2
    signs = [r["Loss/signs/real"] for r in records]
    assert float(state.ada_signs_count) == 2.0
    assert float(state.ada_signs_sum) == pytest.approx(sum(signs), abs=1e-6)

    again = cli_train.main(["--outdir", str(tmp_path), "--kimg", "0.006", "--resume",
                            os.path.join(out["run_dir"], "train-state-latest.pt"), *THIN_ADA[:-2], "--p", "0"])
    with open(os.path.join(again["run_dir"], "training_options.json")) as f:
        ada = json.load(f)["ada"]
    assert ada["enabled"] and ada["kimg"] == 100 and ada["pipe"] == "bgc" and ada["fast_geom"] and ada["stack_calls"]
    s = again["state"]
    assert s.step == 3 and len(again["records"]) == 1
    # p comes from the checkpoint, not from --p; the counters go on from 2
    assert float(s.ada_p) == pytest.approx(0.3) and again["records"][0]["Progress/augment_p"] == pytest.approx(0.3)
    assert float(s.ada_signs_count) == 3.0
    assert float(s.ada_signs_sum) == pytest.approx(sum(signs) + again["records"][0]["Loss/signs/real"], abs=1e-6)
