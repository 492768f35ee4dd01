"""The port's metrics (`pasta_gan_tpu_torch/metrics/`) against the JAX package's, on the CPU.

* formulas and FeatureStats: the same floats as the JAX modules (exact);
* InceptionV3 features on one randomized torchvision state_dict, at 299x299
  and resized from 256x192 (max abs / max |ref| <= 2e-4, the JAX package's
  oracle limit);
* VGG16 PR features (3e-4) and the LPIPS distance (rtol 1e-4), with and
  without the LPIPS heads;
* SimpleConvFeatures with the JAX weights carried across
  (`io/from_jax.py:simpleconv_state_dict_from_jax`) on even and odd sizes,
  which exercise the two "SAME" paddings (<= 1e-5 relative);
* `calc_metric` for every registered metric on the same uint8 sources, the
  same extractor weights and the same rng_seed (FID, KID and IS within 1e-3
  relative, precision and recall equal; the PPL variants on a toy
  synthesizer with a numpy distance, exact);
* `vgg_feature_distance` over the VGG19 taps with JAX's weights carried across;
* the detector lookup and every file format (state_dict `.pt`, TorchScript
  made with `torch.jit.trace`, `.npz`), as tests/test_detector_landing.py
  does for the JAX package.

Each JAX detector is built once per module (a jitted JAX InceptionV3 takes
seconds to compile on the CPU); batches hold 2-4 images.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import metrics as jm
from pasta_gan_tpu.metrics import extractors as jext
from pasta_gan_tpu.metrics import inception as jinc
from pasta_gan_tpu.metrics import ppl as jppl
from pasta_gan_tpu.metrics import vgg16 as jvgg
from pasta_gan_tpu_torch import metrics as tm
from pasta_gan_tpu_torch.io.from_jax import simpleconv_state_dict_from_jax, vgg19_state_dict_from_jax
from pasta_gan_tpu_torch.metrics import extractors as text
from pasta_gan_tpu_torch.metrics import inception as tinc
from pasta_gan_tpu_torch.metrics import ppl as tppl
from pasta_gan_tpu_torch.metrics import vgg16 as tvgg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_loop import one_torch_thread  # noqa: E402,F401  (autouse fixture)

INCEPTION_REL = 2e-4
VGG_REL = 3e-4
LPIPS_RTOL = 1e-4
SIMPLECONV_REL = 1e-5
METRIC_RTOL = 1e-3


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))) / (np.abs(np.asarray(ref)).max() + 1e-12))


def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# ------------------------------------------------------------------ formulas and FeatureStats


def test_formulas_match_jax():
    rng = np.random.default_rng(0)
    real = rng.standard_normal((40, 8)).astype(np.float32)
    gen = (rng.standard_normal((30, 8)) * 1.2 + 0.3).astype(np.float32)
    mu_r, mu_g = real.mean(0).astype(np.float64), gen.mean(0).astype(np.float64)
    s_r, s_g = np.cov(real, rowvar=False), np.cov(gen, rowvar=False)
    assert tm.fid_from_stats(mu_r, s_r, mu_g, s_g) == jm.fid_from_stats(mu_r, s_r, mu_g, s_g)
    kid = [f(real, gen, num_subsets=7, max_subset_size=20, rng=np.random.default_rng(3))
           for f in (tm.kid_from_features, jm.kid_from_features)]
    assert kid[0] == kid[1]
    probs = rng.dirichlet(np.ones(6), 25)
    assert tm.inception_score_from_probs(probs, 5) == jm.inception_score_from_probs(probs, 5)
    from pasta_gan_tpu.metrics.formulas import _pairwise_sq_dist as jpd
    from pasta_gan_tpu_torch.metrics.formulas import _pairwise_sq_dist as tpd

    np.testing.assert_array_equal(tpd(real, gen, col_batch=7), jpd(real, gen, col_batch=7))
    pr = [f(real, gen, nhood_size=3, row_batch_size=16, col_batch_size=9)
          for f in (tm.precision_recall_from_features, jm.precision_recall_from_features)]
    assert pr[0] == pr[1]
    dist = rng.exponential(size=300)
    assert tm.ppl_from_distances(dist) == jm.ppl_from_distances(dist)
    a, b, t = rng.standard_normal((5, 4)), rng.standard_normal((5, 4)), rng.uniform(size=(5, 1))
    np.testing.assert_array_equal(tm.slerp(a, b, t), jm.slerp(a, b, t))


def test_feature_stats_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((n, 5)).astype(np.float32) for n in (4, 3, 6)]
    stats = []
    for mod in (tm, jm):
        s = mod.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=10)
        for b in batches:
            s.append(b)
        stats.append(s)
    t, j = stats
    assert t.num_items == j.num_items == 10 and t.is_full()
    np.testing.assert_array_equal(t.get_all(), j.get_all())
    for a, b in zip(t.get_mean_cov(), j.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    t.save(str(tmp_path / "t.pkl"))
    back = tm.FeatureStats.load(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(back.get_all(), j.get_all())
    kw = dict(dataset_tag="upt", extractor_tag="x", max_items=10)
    assert tm.stats_cache_path(str(tmp_path), **kw) == jm.stats_cache_path(str(tmp_path), **kw)
    # the detectors' tags differ, so the two packages never share cached stats
    assert tinc.InceptionV3Features.tag != jinc.InceptionV3Features.tag
    assert text.SimpleConvFeatures.tag != jext.SimpleConvFeatures.tag


# ------------------------------------------------------------------ InceptionV3


def _randomized_inception_state_dict(seed=0, he=False):
    """tests/test_inception.py's oracle with randomized BN statistics; with
    `he`, its conv weights redrawn He-normal, so that the 2048-d features vary
    between images (under torch's default init their spread across images
    is ~1e-8 of their size, and an FID of them is rounding noise)."""
    from _inception_oracle import FidInceptionOracle

    torch.manual_seed(seed)
    model = FidInceptionOracle().eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            if he and isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / m.weight[0].numel()) ** 0.5)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def inception_pair():
    sd = _randomized_inception_state_dict()
    return sd, jinc.InceptionV3Features.from_state_dict(sd), tinc.InceptionV3Features.from_state_dict(sd, device="cpu")


@pytest.mark.parametrize("hw", [(299, 299), (256, 192)])
def test_inception_matches_jax(inception_pair, hw):
    _, jx, port = inception_pair
    imgs = _images(sum(hw), (2, *hw, 3))
    ref = jx(imgs)
    got = port(imgs)
    assert tuple(got.shape) == (2, 2048) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= INCEPTION_REL
    # a tensor batch gives what the numpy batch gives
    torch.testing.assert_close(port(torch.from_numpy(imgs)), got, rtol=0, atol=0)


# ------------------------------------------------------------------ VGG16 and LPIPS


def _vgg16_state_dict(seed=0, heads=True, classifier=True):
    """torchvision vgg16 names, He-scaled random weights, optional classifier
    and LPIPS heads."""
    g = torch.Generator().manual_seed(seed)
    sd, c_in = {}, 3
    for i, c in zip(tvgg._CONV_IDX, [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]):
        sd[f"features.{i}.weight"] = torch.randn((c, c_in, 3, 3), generator=g) * (2.0 / (9 * c_in)) ** 0.5
        sd[f"features.{i}.bias"] = torch.randn(c, generator=g) * 0.01
        c_in = c
    for j, (n_out, n_in) in ((0, (4096, 512 * 49)), (3, (4096, 4096))) if classifier else ():
        sd[f"classifier.{j}.weight"] = torch.randn((n_out, n_in), generator=g) * (2.0 / n_in) ** 0.5
        sd[f"classifier.{j}.bias"] = torch.randn(n_out, generator=g) * 0.01
    if heads:
        for k, c in enumerate((64, 128, 256, 512, 512)):
            sd[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=g) - 0.1  # a few negative: clamped
    return sd


@pytest.fixture(scope="module")
def vgg16_sd():
    return _vgg16_state_dict()


@pytest.fixture(scope="module")
def vgg16_pair(vgg16_sd):
    return jvgg.VGG16Features.from_state_dict(vgg16_sd), tvgg.VGG16Features.from_state_dict(vgg16_sd, device="cpu")


@pytest.mark.parametrize("hw", [(224, 224), (256, 192)])
def test_vgg16_pr_features_match_jax(vgg16_pair, hw):
    jx, port = vgg16_pair
    imgs = _images(7 + hw[1], (2, *hw, 3))
    got = port(imgs)
    assert tuple(got.shape) == (2, 4096)
    assert _rel(got.numpy(), jx(imgs)) <= VGG_REL


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "unit"])
def test_lpips_distance_matches_jax(vgg16_sd, heads):
    sd = vgg16_sd if heads else {k: v for k, v in vgg16_sd.items() if not k.startswith("lin")}
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 255, (4, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    ref = np.asarray(jppl.lpips_distance(sd)(jnp.asarray(a), jnp.asarray(b)))
    got = tppl.lpips_distance(sd, device="cpu")(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (4,) and np.all(got > 0)
    np.testing.assert_allclose(got, ref, rtol=LPIPS_RTOL)


def test_vgg16_from_state_dict_refuses_other_graphs(vgg16_sd):
    with pytest.raises(ValueError, match="vgg16"):
        tvgg.VGG16Features.from_state_dict({"conv.weight": torch.zeros(1)}, device="cpu")
    no_head = {k: v for k, v in vgg16_sd.items() if not k.startswith(("classifier", "lin"))}
    with pytest.raises(KeyError, match="classifier"):
        tvgg.VGG16Features.from_state_dict(no_head, device="cpu")
    tvgg.LPIPSFeatures.from_state_dict(no_head, device="cpu")  # LPIPS needs no classifier


# ------------------------------------------------------------------ SimpleConvFeatures


@pytest.fixture(scope="module")
def simpleconv_pair():
    jx = jext.SimpleConvFeatures()
    port = text.SimpleConvFeatures(device="cpu")
    port.load_state_dict(simpleconv_state_dict_from_jax(jx.kernels, jx.proj, port.state_dict()), strict=True)
    return jx, port


@pytest.mark.parametrize("hw", [(64, 48), (37, 29), (20, 33)], ids=["even", "odd", "mixed"])
def test_simpleconv_matches_jax(simpleconv_pair, hw):
    jx, port = simpleconv_pair
    imgs = _images(hw[0], (3, *hw, 3))
    got, ref = port(imgs).numpy(), jx(imgs)
    assert got.shape == (3, 256)
    assert _rel(got, ref) <= SIMPLECONV_REL
    # the float path PPL's default distance takes (no uint8 rounding)
    f = imgs.astype(np.float32) + 0.25
    assert _rel(port(torch.from_numpy(f)).numpy(), np.asarray(jx._fn(jnp.asarray(f)))) <= SIMPLECONV_REL


def test_same_pads_follow_xla():
    for n in range(1, 20):
        for k, s in ((3, 2), (3, 1), (4, 2), (1, 2)):
            assert text.same_pads(n, k, s) == jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]


def test_simpleconv_carrier_refuses_mismatches():
    jx = jext.SimpleConvFeatures(dim=8)
    expected = text.SimpleConvFeatures(device="cpu").state_dict()
    with pytest.raises(ValueError, match="proj"):
        simpleconv_state_dict_from_jax(jx.kernels, jx.proj, expected)
    with pytest.raises(KeyError):
        simpleconv_state_dict_from_jax(jx.kernels[:3], jext.SimpleConvFeatures().proj, expected)
    with pytest.raises(ValueError, match="HWIO"):
        simpleconv_state_dict_from_jax([np.zeros((3, 3))] * 4, jx.proj)


# ------------------------------------------------------------------ calc_metric, every registered metric


def _uint8_source(seed, n, batch=4, hw=(40, 32), shift=0):
    imgs = np.clip(_images(seed, (n, *hw, 3)).astype(np.int32) + shift, 0, 255).astype(np.uint8)
    return lambda: (imgs[i : i + batch] for i in range(0, n, batch))


class _ToyPPL:
    """A toy synthesizer (images that are affine in w, float32 ops only) and
    a numpy distance: both frameworks compute the same floats."""

    def __init__(self, xp):
        self.xp = xp

    def sampler(self, space):
        rng = np.random.default_rng(11)

        def pairs():
            while True:
                ws0 = rng.standard_normal((3, 2, 16)).astype(np.float32)
                ws1 = ws0 + rng.standard_normal((3, 2, 16)).astype(np.float32) * 0.1
                aux = rng.uniform(-0.5, 0.5, (3, 16, 16, 3)).astype(np.float32)
                yield self.xp(ws0), self.xp(ws1), self.xp(aux)

        def synth(ws, aux):
            return aux + ws[:, 0, :, None, None] * 0.01 - ws[:, 1, None, :, None] * 0.02

        return synth, pairs()

    @staticmethod
    def distance(a, b):
        d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
        return np.sum(d.astype(np.float64) ** 2, axis=(1, 2, 3)).astype(np.float32)


@pytest.mark.parametrize("metric", jm.list_valid_metrics())
def test_calc_metric_matches_jax(simpleconv_pair, metric):
    assert tm.list_valid_metrics() == jm.list_valid_metrics()
    jx, port = simpleconv_pair
    kw = dict(real_source=_uint8_source(0, 14), gen_source=_uint8_source(1, 20, shift=30), rng_seed=5)
    ppl_kw = lambda xp: dict(ppl_sampler=_ToyPPL(xp).sampler, ppl_distance=_ToyPPL.distance,  # noqa: E731
                             ppl_num_samples=7)
    ref = jm.calc_metric(metric, extractor=jx, **kw, **ppl_kw(jnp.asarray))
    got = tm.calc_metric(metric, extractor=port, device="cpu", **kw, **ppl_kw(torch.from_numpy))
    assert sorted(got) == sorted(ref) and got["metric"] == metric
    assert got["extractor"] == port.tag
    assert sorted(got["results"]) == sorted(ref["results"])
    for k, v in ref["results"].items():
        if metric.startswith("ppl"):
            assert got["results"][k] == v, k
        elif metric.startswith("pr"):
            assert got["results"][k] == v, k
        else:
            assert abs(got["results"][k] - v) <= METRIC_RTOL * abs(v), (k, got["results"][k], v)


@pytest.mark.parametrize("sampling,crop", [("end", False), ("full", True)])
def test_compute_ppl_toy_exact(sampling, crop):
    res = []
    for mod, xp in ((tppl, torch.from_numpy), (jppl, jnp.asarray)):
        synth, pairs = _ToyPPL(xp).sampler("w")
        res.append(mod.compute_ppl(synth, pairs, _ToyPPL.distance, num_samples=8, sampling=sampling, crop=crop,
                                   rng=np.random.default_rng(2)))
    assert res[0] == res[1] and np.isfinite(res[0])


def test_vgg_feature_distance_matches_jax():
    from pasta_gan_tpu.train.vgg import init_vgg19
    from pasta_gan_tpu_torch.train.vgg import VGG19Features

    variables = init_vgg19(jax.random.PRNGKey(0), image_size=32)
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict_from_jax(variables, vgg.state_dict()), strict=True)
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.float32)
    ref = np.asarray(jppl.vgg_feature_distance(variables)(jnp.asarray(a), jnp.asarray(b)))
    got = tppl.vgg_feature_distance(vgg.eval())(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_default_ppl_distance_is_the_float_path():
    from pasta_gan_tpu_torch.metrics.metric_main import _default_ppl_distance

    a = torch.full((1, 16, 16, 3), 100.0)
    d = _default_ppl_distance("cpu")(a, a + 1e-3)  # an epsilon step that uint8 rounding would erase
    assert float(d[0]) > 0


# ------------------------------------------------------------------ detector lookup and file formats


class _Holder(torch.nn.Module):
    """Registers every state_dict entry under its dotted name; forward is the
    identity, so torch.jit.trace records a real TorchScript archive."""

    def forward(self, x):
        return x


def _holder(sd):
    root = _Holder()
    for key, val in sd.items():
        *mods, leaf = key.split(".")
        mod = root
        for m in mods:
            if not hasattr(mod, m):
                setattr(mod, m, _Holder())
            mod = getattr(mod, m)
        if "running_" in leaf or leaf == "num_batches_tracked":
            mod.register_buffer(leaf, val.detach().clone())
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(val.detach().clone(), requires_grad=False))
    return root


def _save_all_formats(sd, tmp_path, names):
    """(format -> (directory, path)) for a TorchScript archive with the
    NVIDIA-style `layers.` wrapper, a state_dict checkpoint and an .npz."""
    files = {}
    for fmt, name in zip(("ts", "pth", "npz"), names):
        d = tmp_path / fmt
        d.mkdir(parents=True)
        path = str(d / name)
        if fmt == "ts":
            traced = torch.jit.trace(_holder({f"layers.{k}": v for k, v in sd.items()}), torch.zeros(1))
            torch.jit.save(traced, path)
        elif fmt == "pth":
            torch.save(sd, path)
        else:
            np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        files[fmt] = (str(d), path)
    return files


def test_detector_lookup_and_every_format(tmp_path, monkeypatch, inception_pair):
    sd, jx, _ = inception_pair
    imgs = _images(9, (2, 96, 80, 3))
    ref = jx(imgs)
    feats = {}
    for fmt, (d, path) in _save_all_formats(sd, tmp_path / "inception", tm.DETECTORS["inception"]["filenames"]).items():
        monkeypatch.setenv("PASTA_GAN_DETECTORS", d)
        found = tm.find_detector("inception")
        assert found == path and found == jm.find_detector("inception"), (fmt, found)
        assert tm.verify_detector("inception", found) == jm.verify_detector("inception", found)
        ext = tm.default_extractor(found, device="cpu")
        assert isinstance(ext, tinc.InceptionV3Features), fmt
        feats[fmt] = ext(imgs).numpy()
        assert _rel(feats[fmt], ref) <= INCEPTION_REL, fmt
    np.testing.assert_array_equal(feats["ts"], feats["pth"])
    np.testing.assert_array_equal(feats["npz"], feats["pth"])

    vsd = _vgg16_state_dict(seed=1, classifier=False)  # LPIPS's part
    a = np.random.default_rng(5).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    dists = {}
    for fmt, (d, path) in _save_all_formats(vsd, tmp_path / "vgg16", tm.DETECTORS["vgg16"]["filenames"]).items():
        monkeypatch.setenv("PASTA_GAN_DETECTORS", d)
        found = tm.find_detector("vgg16")
        assert found == path, (fmt, found)
        loaded = tvgg.load_state_dict_file(found)
        assert sorted(loaded) == sorted(vsd)
        dists[fmt] = tppl.lpips_distance(loaded, device="cpu")(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()))
        assert sorted(jvgg.load_state_dict_file(found)) == sorted(vsd)
    torch.testing.assert_close(dists["ts"], dists["pth"], rtol=0, atol=0)
    torch.testing.assert_close(dists["npz"], dists["pth"], rtol=0, atol=0)

    monkeypatch.setenv("PASTA_GAN_DETECTORS", str(tmp_path / "nowhere"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if tm.find_detector("inception") is None:
        assert isinstance(tm.default_extractor(None, device="cpu"), text.SimpleConvFeatures)


class _ScriptedDetector(torch.nn.Module):
    """The reference detectors' call: NCHW uint8 in, features with return_features."""

    def forward(self, x, return_features: bool = False):
        f = x.float().mean(dim=(2, 3))
        return f if return_features else -f


def test_torchscript_detector_runs_a_file_that_holds_no_inception(tmp_path):
    path = str(tmp_path / "detector.pt")
    torch.jit.save(torch.jit.script(_ScriptedDetector()), path)
    ext = tm.default_extractor(path, device="cpu")
    assert isinstance(ext, text.TorchScriptDetector) and ext.tag == "torchscript-torch-detector.pt"
    imgs = _images(3, (2, 8, 6, 3))
    np.testing.assert_allclose(ext(imgs).numpy(), imgs.reshape(2, -1, 3).mean(1), rtol=1e-6)


def test_detectors_refuse_a_missing_card(monkeypatch, inception_pair, vgg16_sd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = inception_pair[0]
    for build in (lambda: tinc.InceptionV3Features.from_state_dict(sd),
                  lambda: tvgg.VGG16Features.from_state_dict(vgg16_sd),
                  lambda: tvgg.LPIPSFeatures.from_state_dict(vgg16_sd),
                  lambda: text.SimpleConvFeatures(),
                  lambda: tm.MetricOptions()):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
