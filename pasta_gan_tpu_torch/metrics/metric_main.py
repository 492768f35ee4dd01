"""Metric registry and `calc_metric` (counterpart of
`pasta_gan_tpu/metrics/metric_main.py`; reference `metrics/metric_main.py`).

The same twelve metric names as the JAX package (`metric_main.py:82-150` of
the reference): fid50k_full, fid50k, kid50k_full, kid50k, is50k,
pr50k3_full, pr50k3, ppl2_wend, ppl_zfull, ppl_wfull, ppl_zend, ppl_wend.
Sources are callables returning an iterable of uint8 NHWC batches (numpy
arrays or tensors on the extractor's device), so datasets, generators and
folders share one path; the features go to the host for the formulas.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from . import formulas
from .extractors import FeatureExtractor, default_extractor
from .feature_stats import FeatureStats

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn):
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(name) -> bool:
    return name in _metric_dict


def list_valid_metrics():
    return list(_metric_dict)


def _host(features) -> np.ndarray:
    if torch.is_tensor(features):
        return features.float().cpu().numpy()
    return np.asarray(features, np.float32)


def _accumulate(source: Iterable, extractor, max_items, capture_all, capture_mean_cov):
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov, max_items=max_items)
    for batch in source:
        if stats.is_full():
            break
        stats.append(_host(extractor(batch)))
    return stats


class MetricOptions:
    """What calc_metric needs: batched uint8 image sources, an extractor and
    the device the default extractors are built on."""

    def __init__(
        self,
        real_source: Optional[Callable[[], Iterable]] = None,
        gen_source: Optional[Callable[[], Iterable]] = None,
        extractor: Optional[FeatureExtractor] = None,
        cache_dir: Optional[str] = None,
        rng_seed: int = 0,
        ppl_sampler: Optional[Callable] = None,
        ppl_distance: Optional[Callable] = None,
        ppl_num_samples: Optional[int] = None,
        device="cuda",
    ):
        self.real_source = real_source
        self.gen_source = gen_source
        self.device = device
        self.extractor = extractor or default_extractor(device=device)
        self.cache_dir = cache_dir
        self.rng = np.random.default_rng(rng_seed)
        # PPL: `ppl_sampler(space)` -> (synthesize_from_ws, iterable of (ws0,
        # ws1[, aux...])); `ppl_distance(img0, img1)` -> per-sample squared
        # perceptual distance of [0, 255] float images (default: the float
        # path of SimpleConvFeatures; metrics.ppl.lpips_distance gives the
        # reference's); `ppl_num_samples` overrides the 50k protocol.
        self.ppl_sampler = ppl_sampler
        self.ppl_distance = ppl_distance
        self.ppl_num_samples = ppl_num_samples


@register_metric
def fid50k_full(opts: MetricOptions, max_real=None, num_gen=50000):
    real = _accumulate(opts.real_source(), opts.extractor, max_real, False, True)
    gen = _accumulate(opts.gen_source(), opts.extractor, num_gen, False, True)
    mu_r, sig_r = real.get_mean_cov()
    mu_g, sig_g = gen.get_mean_cov()
    return dict(fid50k_full=formulas.fid_from_stats(mu_r, sig_r, mu_g, sig_g))


@register_metric
def fid50k(opts: MetricOptions, max_real=50000, num_gen=50000):
    r = fid50k_full(opts, max_real=max_real, num_gen=num_gen)
    return dict(fid50k=r["fid50k_full"])


@register_metric
def kid50k_full(opts: MetricOptions, max_real=1000000, num_gen=50000):
    real = _accumulate(opts.real_source(), opts.extractor, max_real, True, False)
    gen = _accumulate(opts.gen_source(), opts.extractor, num_gen, True, False)
    kid = formulas.kid_from_features(
        real.get_all(), gen.get_all(), num_subsets=100, max_subset_size=1000, rng=opts.rng
    )
    return dict(kid50k_full=kid)


@register_metric
def kid50k(opts: MetricOptions, max_real=50000, num_gen=50000):
    r = kid50k_full(opts, max_real=max_real, num_gen=num_gen)
    return dict(kid50k=r["kid50k_full"])


@register_metric
def is50k(opts: MetricOptions, num_gen=50000):
    gen = _accumulate(opts.gen_source(), opts.extractor, num_gen, True, False)
    probs = gen.get_all()
    # IS needs probabilities: softmax what the extractor gives when it is not one
    if probs.min() < 0 or probs.max() > 1:
        e = np.exp(probs - probs.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
    num_splits = min(10, len(probs))
    mean, std = formulas.inception_score_from_probs(probs, num_splits=num_splits)
    return dict(is50k_mean=mean, is50k_std=std)


@register_metric
def pr50k3_full(opts: MetricOptions, max_real=200000, num_gen=50000):
    real = _accumulate(opts.real_source(), opts.extractor, max_real, True, False)
    gen = _accumulate(opts.gen_source(), opts.extractor, num_gen, True, False)
    precision, recall = formulas.precision_recall_from_features(real.get_all(), gen.get_all(), nhood_size=3)
    return dict(pr50k3_full_precision=precision, pr50k3_full_recall=recall)


@register_metric
def pr50k3(opts: MetricOptions, max_real=50000, num_gen=50000):
    r = pr50k3_full(opts, max_real=max_real, num_gen=num_gen)
    return dict(pr50k3_precision=r["pr50k3_full_precision"], pr50k3_recall=r["pr50k3_full_recall"])


def _default_ppl_distance(device):
    """SimpleConvFeatures on float32 input with no uint8 rounding (the
    epsilon-sized step PPL divides by would round away under the FID
    extractors' uint8 contract).  Deterministic and offline; NOT
    LPIPS-calibrated: pass `ppl_distance=metrics.ppl.lpips_distance(vgg16
    state_dict)` for the reference's number."""
    from .extractors import SimpleConvFeatures

    feat = SimpleConvFeatures(device=device)

    def dist(a, b):
        return (feat(a) - feat(b)).square().sum(dim=-1)

    return dist


def _ppl(opts: MetricOptions, space, sampling, crop, num_samples=50000, epsilon=1e-4):
    """compute_ppl with the variant's space, sampling and crop (reference
    `metric_main.py:101-103,133-150`)."""
    from .ppl import compute_ppl

    if opts.ppl_sampler is None:
        raise ValueError(
            "PPL metrics need MetricOptions.ppl_sampler, a factory `sampler(space) -> (synthesize_from_ws, "
            "ws_pair_iterable)`; cli.calc_metrics builds one from --network"
        )
    synthesize_from_ws, pair_source = opts.ppl_sampler(space)
    distance = opts.ppl_distance or _default_ppl_distance(opts.device)
    return compute_ppl(
        synthesize_from_ws, pair_source, distance,
        num_samples=opts.ppl_num_samples or num_samples,
        epsilon=epsilon, sampling=sampling, crop=crop, rng=opts.rng,
    )


@register_metric
def ppl2_wend(opts: MetricOptions):
    """The reference's PPL of record (`metric_main.py:101-103`): w-space, end
    sampling, no crop, 50k samples, epsilon 1e-4."""
    return dict(ppl2_wend=_ppl(opts, "w", "end", crop=False))


@register_metric
def ppl_zfull(opts: MetricOptions):
    return dict(ppl_zfull=_ppl(opts, "z", "full", crop=True))


@register_metric
def ppl_wfull(opts: MetricOptions):
    return dict(ppl_wfull=_ppl(opts, "w", "full", crop=True))


@register_metric
def ppl_zend(opts: MetricOptions):
    return dict(ppl_zend=_ppl(opts, "z", "end", crop=True))


@register_metric
def ppl_wend(opts: MetricOptions):
    return dict(ppl_wend=_ppl(opts, "w", "end", crop=True))


_OPTIONS = ("real_source", "gen_source", "extractor", "cache_dir", "rng_seed", "ppl_sampler", "ppl_distance",
            "ppl_num_samples", "device")


def calc_metric(metric: str, **kwargs) -> dict:
    """reference metric_main.calc_metric (`metric_main.py:39-64`)."""
    assert is_valid_metric(metric), f"unknown metric {metric}; valid: {list_valid_metrics()}"
    opts = MetricOptions(**{k: v for k, v in kwargs.items() if k in _OPTIONS})
    start = time.time()
    results = _metric_dict[metric](opts)
    return dict(
        results=results,
        metric=metric,
        total_time=time.time() - start,
        extractor=getattr(opts.extractor, "tag", "unknown"),
    )


def report_metric(result_dict: dict, run_dir: Optional[str] = None, snapshot: Optional[str] = None):
    """Print the result as one JSON line and append it to
    `<run_dir>/metric-<name>.jsonl` (`metric_main.py:67-77`)."""
    metric = result_dict["metric"]
    row = dict(result_dict, snapshot_pkl=snapshot, timestamp=time.time())
    print(json.dumps(row))
    if run_dir is not None:
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "at") as f:
            f.write(json.dumps(row) + "\n")
