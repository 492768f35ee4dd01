"""Perceptual Path Length (counterpart of `pasta_gan_tpu/metrics/ppl.py`;
reference `metrics/perceptual_path_length.py`).

The generators are conditioned on style codes (z_dim 0 in the config of
record), so PPL runs in w-space between the mapped codes of two data samples
(`sampling="end"`: t = 0; `"full"`: t ~ U(0, 1), drawn from the caller's
numpy generator, so one seed gives both packages the same path points).
Distances:

* `lpips_distance(state_dict)`: the reference's distance (LPIPS-VGG16)
  through `metrics/vgg16.py:LPIPSFeatures`;
* `vgg_feature_distance(vgg)`: the offline fallback over the VGG19 taps of
  `train/vgg.py:VGG19Features` (comparable orderings, another scale).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .formulas import ppl_from_distances


def center_crop_for_ppl(img: torch.Tensor) -> torch.Tensor:
    """The reference's face-region crop (ppl.py:141-144): rows 3/8..7/8,
    cols 2/8..6/8 of a square NHWC image."""
    c = img.shape[1] // 8
    return img[:, c * 3 : c * 7, c * 2 : c * 6, :]


def vgg_feature_distance(vgg):
    """Squared feature distance per sample over the perceptual taps of a
    `train/vgg.py:VGG19Features` module, on its inputs as given (as the JAX
    package applies its VGG19 to the [0, 255] images compute_ppl passes)."""
    @torch.no_grad()
    def dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for x, y in zip(vgg(a), vgg(b)):
            total = total + (x - y).square().mean(dim=(1, 2, 3))
        return total

    return dist


def lpips_distance(state_dict, device="cuda"):
    """LPIPS-VGG16 squared distance per sample (the reference PPL metric's
    distance, `perceptual_path_length.py:86-95`).  `state_dict`: torchvision
    vgg16 weights (+ optional lin0..lin4 heads).  Images in [0, 255] are
    mapped to [-1, 1] for the embedding."""
    from .vgg16 import LPIPSFeatures

    model = LPIPSFeatures.from_state_dict(state_dict, device=device)

    @torch.no_grad()
    def dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = model(a / 127.5 - 1.0)
        fb = model(b / 127.5 - 1.0)
        return (fa - fb).square().sum(dim=-1)

    return dist


@torch.no_grad()
def compute_ppl(
    synthesize_from_ws: Callable[..., torch.Tensor],  # ws[, *aux] -> [-1, 1] NHWC images
    ws_pair_source: Iterable,  # yields (ws0, ws1[, *aux]), ws [B, num_ws, w_dim]
    distance_fn: Callable,
    num_samples: int = 2000,
    epsilon: float = 1e-4,
    sampling: str = "end",
    crop: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """A source yielding (ws0, ws1, aux...) has the aux forwarded to
    `synthesize_from_ws(ws, aux...)` unchanged while w interpolates: the
    try-on generators condition the synthesis on pose/retain/denorm inputs
    that stay fixed along the w path (the reference holds c fixed,
    `perceptual_path_length.py:36-63`)."""
    assert sampling in ("full", "end")
    rng = rng or np.random.default_rng(0)
    dists = []
    n = 0
    for item in ws_pair_source:
        ws0, ws1, *aux = item
        B = ws0.shape[0]
        t = rng.uniform(size=(B, 1, 1)) if sampling == "full" else np.zeros((B, 1, 1))
        t = torch.as_tensor(t, dtype=ws0.dtype, device=ws0.device)
        wt0 = ws0 + (ws1 - ws0) * t
        wt1 = ws0 + (ws1 - ws0) * (t + epsilon)
        img0 = synthesize_from_ws(wt0, *aux)
        img1 = synthesize_from_ws(wt1, *aux)
        if crop:
            img0, img1 = center_crop_for_ppl(img0), center_crop_for_ppl(img1)
        # the reference's [0, 255] convention before the distance network
        d = distance_fn((img0 + 1) * 127.5, (img1 + 1) * 127.5) / (epsilon**2)
        dists.append(np.asarray(torch.as_tensor(d).float().cpu()))
        n += B
        if n >= num_samples:
            break
    return ppl_from_distances(np.concatenate(dists)[:num_samples])
