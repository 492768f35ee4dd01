"""`pasta_gan_tpu_torch/cli/calc_metrics.py` against the JAX package's CLI, on the CPU.

One narrow GeneratorFull drawn by the port is carried into the JAX package by
its own `io/torch_import.py:convert_generator_full` and saved as a JAX
snapshot beside the port's.  Its width, channel_base 2048 with channel_max
512 (8 channels at 256px, 512 at 4px), is the narrowest that converter maps:
it knows no `const_encoding.proj`, which a generator has when its 4x4 width
(channel_base / 4) is below channel_max.

* `_network_source`: the port's uint8 try-on frames (whole 256x256) against
  the JAX CLI's `_network_source` on the same synthetic pairs (<= 1 uint8
  level);
* `_ppl_sampler`: the ws pairs and the synthesized images of a batch whose
  second garments wrap around the pair list, against the JAX CLI's, not the
  final PPL (its epsilon of 1e-4 divides fp32 differences by 1e-8);
* `main --network --synthetic` with an InceptionV3 detector file: FID and
  precision/recall against the JAX CLI's run (1e-3 relative; equal), the
  same JSON keys printed and appended to `metric-<name>.jsonl`, and a PPL
  run (every metric is held to JAX's in tests/test_torch_metrics.py; a CPU
  forward of the generator takes seconds, and each metric draws the source
  anew);
* `_folder_source` against the JAX CLI's (PIL LANCZOS) bit for bit, and
  `main --gen_dir --real_dir --resolution`;
* refusals: `--conditional`, a snapshot that holds another generator, an
  unknown metric, PPL without `--network`.
"""

import glob
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import jax

from pasta_gan_tpu.cli import calc_metrics as jcli
from pasta_gan_tpu.io.checkpoints import save_snapshot as jax_save_snapshot
from pasta_gan_tpu.io.torch_import import convert_generator_full
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu_torch.cli import calc_metrics as cli
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.models import GeneratorFull, GeneratorV18

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_generator import _jax_variables  # noqa: E402
from test_torch_metrics import _randomized_inception_state_dict  # noqa: E402
from test_torch_train_loop import one_torch_thread  # noqa: E402,F401  (autouse fixture)
from test_torch_tryon import _gen_shapes  # noqa: E402
from test_torch_tryon import THIN  # noqa: E402

NET = dict(img_resolution=256, channel_base=2048, channel_max=512)

N_PAIRS, BATCH = 4, 2
METRIC_RTOL = 1e-3
# the style encoder's and mapping's fp32 reductions in two frameworks: ws of
# magnitude up to ~3 differ by up to 4.7e-6 (measured on a CPU)
WS_RTOL, WS_ATOL = 1e-5, 2e-5
IMG_ATOL = 1e-2  # tests/test_torch_generator.py's finetune-image tolerance, [-1, 1] units


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """(port snapshot, JAX snapshot directory) of the same narrow GeneratorFull."""
    d = tmp_path_factory.mktemp("snapshots")
    gen = GeneratorFull(**NET).reset_parameters(torch.Generator().manual_seed(0))
    port = str(d / "snap.pt")
    save_snapshot(port, gen.state_dict(), torch.zeros(512), {"model": gen.config, "generator": gen.variant})
    template = _jax_variables(JaxGeneratorFull(**NET), _gen_shapes())
    variables = convert_generator_full({k: v.numpy() for k, v in gen.state_dict().items()}, template)
    jsnap = str(d / "jax_snap")
    jax_save_snapshot(jsnap, variables, np.zeros(512, np.float32), json.dumps({"model": gen.config}))
    return port, jsnap


@pytest.fixture(scope="module")
def inception_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("detector") / "inception.pt")
    torch.save(_randomized_inception_state_dict(seed=2, he=True), path)
    return path


def test_network_source_matches_jax(snapshots):
    port, jsnap = snapshots
    got = [b for b in cli._network_source(port, None, N_PAIRS, BATCH, device="cpu")()]
    ref = list(jcli._network_source(jsnap, None, N_PAIRS, BATCH)())
    assert [b.dtype for b in got] == [torch.uint8] * 2
    got, ref = torch.cat(got).numpy(), np.concatenate(ref)
    assert got.shape == ref.shape == (N_PAIRS, 256, 256, 3)  # the whole frame, not cli.test's 256x192
    assert int(np.abs(got.astype(np.int32) - ref).max()) <= 1
    assert got.std() > 1.0  # a real picture, not a constant


def test_ppl_sampler_matches_jax(snapshots):
    port, jsnap = snapshots
    # 2 pairs in a batch of 2: the second garments wrap around the pair list (1, 0)
    synth_t, pairs_t = cli._ppl_sampler(port, None, 2, BATCH, device="cpu")("w")
    synth_j, pairs_j = jcli._ppl_sampler(jsnap, None, 2, BATCH)("w")
    ws0, ws1, aux = next(pairs_t)
    jws0, jws1, jaux = next(pairs_j)
    np.testing.assert_allclose(ws0.numpy(), np.asarray(jws0), rtol=WS_RTOL, atol=WS_ATOL)
    np.testing.assert_allclose(ws1.numpy(), np.asarray(jws1), rtol=WS_RTOL, atol=WS_ATOL)
    assert float((ws1 - ws0).abs().max()) > 0  # another garment, another code
    mid = ws0 + (ws1 - ws0) * 0.5
    img = synth_t(mid, aux).numpy()
    ref = np.asarray(synth_j(jax.numpy.asarray(mid.numpy()), jaux))
    assert img.shape == ref.shape == (BATCH, 256, 256, 3)
    np.testing.assert_allclose(img, ref, atol=IMG_ATOL)
    with pytest.raises(SystemExit, match="z_dim=0"):
        cli._ppl_sampler(port, None, 3, BATCH, device="cpu")("z")


def _rows(run_dir):
    rows = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "metric-*.jsonl"))):
        with open(path) as f:
            row = json.loads(f.read().splitlines()[-1])
        rows[row["metric"]] = row
    return rows


def test_cli_network_matches_jax(snapshots, inception_file, tmp_path):
    port, jsnap = snapshots
    metrics = "fid50k_full,pr50k3_full"  # every metric against JAX's: test_torch_metrics.py
    argv = ["--synthetic", str(N_PAIRS), "--batch", str(N_PAIRS), "--metrics", metrics, "--detector", inception_file]
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    cli.main(argv + ["--network", port, "--device", "cpu", "--run_dir", str(tmp_path / "port")])
    jcli.main(argv + ["--network", jsnap, "--run_dir", str(tmp_path / "jax")])
    got, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert sorted(got) == sorted(ref) == sorted(metrics.split(","))
    for name, r in ref.items():
        g = got[name]
        assert sorted(g) == sorted(r), name  # the same JSON keys
        assert g["extractor"] == "inception-torch-v1" and g["snapshot_pkl"] == port
        for k, v in r["results"].items():
            assert np.isfinite(g["results"][k]), k
            if name.startswith("pr"):
                assert g["results"][k] == v, k
            else:
                assert abs(g["results"][k] - v) <= METRIC_RTOL * abs(v), (k, g["results"][k], v)

    ppl = cli.main(["--network", port, "--synthetic", "2", "--batch", str(BATCH), "--metrics", "ppl2_wend",
                    "--ppl_samples", str(BATCH), "--device", "cpu"])
    assert [r["metric"] for r in ppl] == ["ppl2_wend"]
    assert all(np.isfinite(v) and v > 0 for r in ppl for v in r["results"].values())


def _write_folder(root, seed, sizes):
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        ext = ".png" if i % 2 else ".jpg"
        PIL.Image.fromarray(img).save(os.path.join(root, f"{i:03d}{ext}"), quality=95)
    return str(root)


def test_folder_source_matches_jax_and_cli_runs(tmp_path):
    gen_dir = _write_folder(tmp_path / "gen", 0, [(40, 30), (33, 47), (64, 64), (20, 25), (50, 41)])
    real_dir = _write_folder(tmp_path / "real", 1, [(48, 36), (30, 30), (61, 17), (44, 52), (36, 36), (29, 40)])
    got = list(cli._folder_source(gen_dir, batch=2, resolution=32)())
    ref = list(jcli._folder_source(gen_dir, batch=2, resolution=32)())
    assert [b.shape for b in got] == [b.shape for b in ref] == [(2, 32, 32, 3)] * 2 + [(1, 32, 32, 3)]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "runs").mkdir()
    results = cli.main(["--gen_dir", gen_dir, "--real_dir", real_dir, "--resolution", "32", "--batch", "2",
                        "--metrics", "fid50k_full,kid50k_full", "--device", "cpu", "--run_dir", str(tmp_path / "runs")])
    assert [r["extractor"] for r in results] == ["simpleconv-torch-v1"] * 2
    assert all(np.isfinite(v) for r in results for v in r["results"].values())
    assert sorted(_rows(tmp_path / "runs")) == ["fid50k_full", "kid50k_full"]
    with pytest.raises(SystemExit, match="no images"):
        cli._folder_source(str(tmp_path / "runs"))


def test_cli_refusals(snapshots, tmp_path):
    port, _ = snapshots
    with pytest.raises(SystemExit, match="§A 10"):
        cli.main(["--gen_dir", str(tmp_path), "--real_dir", str(tmp_path), "--conditional", "--device", "cpu"])
    v18 = GeneratorV18(**THIN)
    snap = str(tmp_path / "v18.pt")
    save_snapshot(snap, v18.state_dict(), torch.zeros(512), {"model": v18.config, "generator": v18.variant})
    with pytest.raises(ValueError, match="'v18'"):
        cli.main(["--network", snap, "--synthetic", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown metric"):
        cli.main(["--network", port, "--synthetic", "2", "--metrics", "fid1k", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--network"):
        cli.main(["--gen_dir", str(tmp_path), "--metrics", "ppl2_wend", "--device", "cpu"])
