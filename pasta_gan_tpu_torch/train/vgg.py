"""VGG19 features for the perceptual loss (counterpart of `pasta_gan_tpu/train/vgg.py`).

Features are tapped after relu1_1 / relu2_1 / relu3_1 / relu4_1 / relu5_1 and
compared with L1 at weights [1/32, 1/16, 1/8, 1/4, 1]; images go in as
[-1, 1] without ImageNet normalization, as in the reference.  The network
holds the convs through conv5_2 (the contextual loss's deepest tap), as the
JAX package's `init_vgg19` does, under torchvision's names
(`features.{layer}.weight`), and runs in float32.

Weights: `load_torch_vgg19` reads a torchvision `vgg19` state_dict that is
already on disk; nothing is downloaded.  Without one, `init_vgg19` draws a
He-initialized network from a seeded generator: a structurally valid
perceptual metric for smoke training, not the reference's.

The contextual loss (`contextual_vgg_loss`) taps relu1_2 / relu2_2 /
relu3_2 / relu4_2 / relu5_2 of the same network on caffe-style inputs (BGR,
x 255, mean subtracted) and sums `losses.contextual_loss` over the taps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .losses import contextual_loss

_VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
NUM_CONVS = 14  # conv1_1 .. conv5_2
# conv indices (0-based) after whose relu the perceptual loss taps features
PERCEPTUAL_TAPS = (0, 2, 4, 8, 12)
VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
# relu1_2, relu2_2, relu3_2, relu4_2, relu5_2: the contextual loss's taps
CONTEXTUAL_TAPS = (1, 3, 5, 9, 13)
_CAFFE_BGR_MEAN = (0.40760392, 0.45795686, 0.48501961)


def _plan_layers(n_convs: int):
    layers, conv_layers, c_in = [], [], 3
    for item in _VGG19_PLAN:
        if len(conv_layers) == n_convs:
            break
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        conv_layers.append(len(layers))
        layers += [nn.Conv2d(c_in, item, 3, padding=1), nn.ReLU()]
        c_in = item
    return layers, tuple(conv_layers)


# torchvision `features` index of each conv
VGG19_CONV_LAYERS = _plan_layers(NUM_CONVS)[1]


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers, self.conv_layers = _plan_layers(NUM_CONVS)
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, taps: Sequence[int] = PERCEPTUAL_TAPS):
        """x [N, H, W, 3] NHWC in [-1, 1] -> the tapped NCHW feature maps, float32."""
        x = x.float().permute(0, 3, 1, 2)
        want = {self.conv_layers[i] + 1 for i in taps}  # the relu after each tapped conv
        out = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in want:
                out.append(x)
                if len(out) == len(want):
                    break
        return out


def init_vgg19(generator: Optional[torch.Generator] = None, device="cpu") -> VGG19Features:
    """He-initialized VGG19 features (normal, std sqrt(2 / fan_in); zero biases)."""
    vgg = VGG19Features()
    with torch.no_grad():
        for m in vgg.features:
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * 9
                m.weight.normal_(0.0, 1.0, generator=generator).mul_(math.sqrt(2.0 / fan_in))
                m.bias.zero_()
    return vgg.to(device).requires_grad_(False).eval()


def load_torch_vgg19(path: str, device="cpu") -> VGG19Features:
    """VGG19Features from a torchvision `vgg19` state_dict file on disk."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    vgg = VGG19Features()
    wanted = vgg.state_dict()
    missing = sorted(set(wanted) - set(state))
    if missing:
        raise KeyError(f"{path} is not a torchvision vgg19 state_dict: missing {missing[:4]}")
    vgg.load_state_dict({k: state[k] for k in wanted}, strict=True)
    return vgg.to(device).requires_grad_(False).eval()


def vgg_perceptual_loss(vgg: VGG19Features, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                        y_feats=None) -> torch.Tensor:
    """Weighted multi-scale L1 between VGG features of x and of the constant
    target y (NHWC); `y_feats` passes y's features when they are at hand."""
    fx = vgg(x)
    if y_feats is None:
        with torch.no_grad():
            y_feats = vgg(y)
    loss = 0.0
    for w, a, b in zip(VGG_SLICE_WEIGHTS, fx, y_feats):
        loss = loss + w * (a - b).abs().mean()
    return loss


def vgg_preprocess_bgr_caffe(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NHWC -> caffe-style BGR x 255 with the mean subtracted, in
    x's dtype (the contextual loss's VGG input)."""
    x = (x + 1.0) / 2.0
    mean = torch.tensor(_CAFFE_BGR_MEAN, dtype=x.dtype, device=x.device)
    return (x.flip(-1) - mean) * 255.0


def contextual_vgg_loss(vgg: VGG19Features, x: torch.Tensor, y: torch.Tensor, h: float = 0.1) -> torch.Tensor:
    """The CX loss of image x against the constant target y (NHWC), summed
    over the CONTEXTUAL_TAPS feature maps."""
    fx = vgg(vgg_preprocess_bgr_caffe(x), taps=CONTEXTUAL_TAPS)
    with torch.no_grad():
        fy = vgg(vgg_preprocess_bgr_caffe(y), taps=CONTEXTUAL_TAPS)
    total = 0.0
    for a, b in zip(fx, fy):
        total = total + contextual_loss(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1), h=h)
    return total
