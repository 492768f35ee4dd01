"""Evaluation metrics (counterpart of `pasta_gan_tpu/metrics`): FID/KID/IS/PR/PPL
with pluggable extractors; InceptionV3 and VGG16/LPIPS as `nn.Module`s on the card."""

from .detectors_manifest import DETECTORS, find_detector, verify_detector
from .extractors import SimpleConvFeatures, TorchScriptDetector, default_extractor, jax_simpleconv
from .feature_stats import FeatureStats, stats_cache_path
from .formulas import (
    fid_from_stats,
    inception_score_from_probs,
    kid_from_features,
    ppl_from_distances,
    precision_recall_from_features,
    slerp,
)
from .quality import eval_batches, quality_metrics
from .ppl import center_crop_for_ppl, compute_ppl, lpips_distance, vgg_feature_distance
from .metric_main import (
    MetricOptions,
    calc_metric,
    is_valid_metric,
    list_valid_metrics,
    register_metric,
    report_metric,
)
