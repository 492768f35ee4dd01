"""The port's training-quality yardstick (`metrics/quality.py`,
`metrics/extractors.py:jax_simpleconv`, `cli/eval_run_snapshots.py`)
against the JAX package's tools, on the CPU.

* the committed `simpleconv_jax_seed0.npz` holds the JAX
  `SimpleConvFeatures(seed=0)` kernels and projection bit for bit, and the
  port's extractor on it gives JAX's features on the seed-123 reals;
* `quality_metrics` on one pair of arrays against the arithmetic of
  `scripts/quality_regression.py` (recon L1 and PSNR: the same numpy;
  fid_proxy: features from two frameworks);
* `cli.eval_run_snapshots` on a thin GeneratorFull carried from JAX
  params and saved as a port snapshot against the JAX generator's
  `gen.apply` forward (noise const, the finetune output) on the same
  evaluation batches, scored by the JAX script's arithmetic.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.metrics.extractors import SimpleConvFeatures as JaxSimpleConv
from pasta_gan_tpu.metrics.formulas import fid_from_stats as jax_fid_from_stats
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu_torch.cli import eval_run_snapshots
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.io.from_jax import state_dict_from_jax
from pasta_gan_tpu_torch.metrics import extractors, quality
from pasta_gan_tpu_torch.models import GeneratorFull

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_generator import _jax_variables  # noqa: E402
from test_torch_train_loop import one_torch_thread  # noqa: E402,F401  (autouse fixture)
from test_torch_tryon import THIN, _gen_shapes  # noqa: E402

EVAL_SAMPLES, EVAL_BATCH = 16, 8  # a CPU forward of the thin generator at 256px takes ~2 s a sample
FEAT_REL = 1e-5  # the extractor's fp32 convs in two frameworks, relative L2
PIX_REL = 1e-6  # recon L1 and PSNR from the same numpy on the same arrays
FID_REL = 1e-4  # fid_proxy from the features of two frameworks, >= 300 samples (full-rank covariances)
METRIC_TOL = 1e-4  # recon L1 (relative) and PSNR (dB) of the port's forward against JAX's
# fid_proxy of the port's forward against JAX's.  The two forwards differ by at most 2.6e-5 a pixel,
# which flips ~1e-4 of the truncated uint8 levels; over 256 features from 16 or 64 samples (rank-
# deficient covariances) sqrtm then moves the value: N(0, 3e-5) pixel noise on JAX's own fakes moved
# fid_proxy (~5.6) by up to 1.3e-4 at 16 samples and 9.8e-5 at 64 (measured on a CPU, three draws
# each), and N(0, 1e-6) already by up to 2.5e-5.  The port read 3.8e-5 from JAX at 16 samples.
FID_ATOL = 5e-4


def to_u8(x):
    """The JAX scripts' conversion, written out."""
    return np.clip((x + 1) * 127.5, 0, 255).astype(np.uint8)


def jax_script_metrics(fakes, reals, extractor):
    """`scripts/quality_regression.py:137-147`, verbatim but for the names."""
    l1 = float(np.mean(np.abs(fakes - reals)))
    mse = float(np.mean((fakes - reals) ** 2))
    psnr = float(10.0 * np.log10(4.0 / max(mse, 1e-12)))
    f_real = extractor(to_u8(reals))
    f_fake = extractor(to_u8(fakes))
    mu_r, cov_r = f_real.mean(0), np.cov(f_real, rowvar=False)
    mu_f, cov_f = f_fake.mean(0), np.cov(f_fake, rowvar=False)
    return {"fid_proxy": float(jax_fid_from_stats(mu_r, cov_r, mu_f, cov_f)), "recon_l1": l1, "psnr_db": psnr}


@pytest.fixture(scope="module")
def jax_extractor():
    return JaxSimpleConv(seed=0)


@pytest.fixture(scope="module")
def eval_set():
    return quality.eval_batches(EVAL_SAMPLES, EVAL_BATCH, seed=123, device="cpu")


def test_committed_weights_are_the_jax_extractor(jax_extractor):
    with np.load(extractors.JAX_SIMPLECONV_SEED0) as f:
        assert sorted(f.files) == ["kernel0", "kernel1", "kernel2", "kernel3", "proj"]
        for i, k in enumerate(jax_extractor.kernels):
            assert f[f"kernel{i}"].dtype == np.float32
            np.testing.assert_array_equal(f[f"kernel{i}"], np.asarray(k))
        np.testing.assert_array_equal(f["proj"], np.asarray(jax_extractor.proj))


def test_jax_simpleconv_features_match_jax(jax_extractor, eval_set):
    ext = extractors.jax_simpleconv("cpu")
    assert ext.tag == "simpleconv-jax-seed0" and ext.tag != extractors.SimpleConvFeatures.tag
    u8 = to_u8(quality.reals_of(eval_set))
    ours, ref = ext(u8).numpy(), jax_extractor(u8)
    assert ours.shape == ref.shape == (EVAL_SAMPLES, 256)
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < FEAT_REL


def test_quality_metrics_match_the_jax_arithmetic(jax_extractor):
    rng = np.random.default_rng(0)
    reals = rng.uniform(-1, 1, (320, 32, 32, 3)).astype(np.float32)
    fakes = np.clip(reals + 0.3 * rng.standard_normal(reals.shape), -1.2, 1.2).astype(np.float32)
    ours = quality.quality_metrics(fakes, reals, extractors.jax_simpleconv("cpu"))
    ref = jax_script_metrics(fakes, reals, jax_extractor)
    assert set(ours) == {"fid_proxy", "recon_l1", "psnr_db"}
    for k in ("recon_l1", "psnr_db"):
        assert abs(ours[k] - ref[k]) <= PIX_REL * abs(ref[k]), (k, ours[k], ref[k])
    assert abs(ours["fid_proxy"] - ref["fid_proxy"]) <= FID_REL * abs(ref["fid_proxy"]), ours
    # the truncating uint8 conversion: 0.999 maps to 254, not 255
    np.testing.assert_array_equal(quality.to_u8(np.array([-1.5, -1.0, 0.999, 1.0, 2.0], np.float32)),
                                  [0, 0, 254, 255, 255])


def test_eval_run_snapshots_matches_the_jax_forward(tmp_path, monkeypatch, eval_set, jax_extractor):
    jgen = JaxGeneratorFull(**THIN)
    variables = _jax_variables(jgen, _gen_shapes(), seed=5)
    port = GeneratorFull(**THIN)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()), strict=True)
    save_snapshot(str(tmp_path / "network-snapshot-000004.pt"), port.state_dict(), torch.zeros(512),
                  {"model": port.config, "generator": port.variant})
    monkeypatch.setattr(quality, "eval_batches", lambda *a, **k: eval_set)  # the batches built once
    (rec,) = eval_run_snapshots.main([str(tmp_path), "--samples", str(EVAL_SAMPLES), "--batch", str(EVAL_BATCH),
                                      "--device", "cpu"])
    assert rec["snapshot"] == "network-snapshot-000004.pt" and rec["samples"] == EVAL_SAMPLES

    fwd = jax.jit(lambda v, b: jgen.apply(
        v, None, b["style_input"], b["retain"], b["pose"], b["denorm_upper_img"], b["denorm_lower_img"],
        b["denorm_upper_mask"], b["denorm_lower_mask"], noise_mode="const", rngs={"noise": jax.random.PRNGKey(0)})[1])
    fakes = np.concatenate([np.asarray(fwd(variables, {k: jnp.asarray(t.numpy()) for k, t in b.items()
                                                       if k != "gt_parsing"})) for b in eval_set])
    ref = jax_script_metrics(fakes, quality.reals_of(eval_set), jax_extractor)
    assert abs(rec["recon_l1"] - ref["recon_l1"]) <= METRIC_TOL * ref["recon_l1"], (rec, ref)
    assert abs(rec["psnr_db"] - ref["psnr_db"]) <= METRIC_TOL, (rec, ref)
    assert abs(rec["fid_proxy"] - ref["fid_proxy"]) <= FID_ATOL, (rec, ref)
