"""VGG16 feature extractors: the PR-metric features and the LPIPS embedding
(counterpart of `pasta_gan_tpu/metrics/vgg16.py`).

The reference's `vgg16.pt` TorchScript detector (`metrics/metric_utils.py:40-51`)
gives 4096-d fc7 features to `precision_recall.py` and, with
`return_lpips=True`, unit-normalized LPIPS features whose squared L2
distance is the LPIPS-VGG distance (`perceptual_path_length.py:86-95`).  The
modules here hold torchvision's `vgg16` graph under torchvision's names
(`features.N.weight`, `classifier.N.weight` as `fc6` / `fc7`) plus the
optional LPIPS linear heads (`lin0..lin4`, pytorch-LPIPS naming
`lins.N.model.1.weight`), run NCHW on cuDNN, in float32 (the caller pins
TF32 off, as `cli/calc_metrics.py` does).

Graph (configuration D):
  conv 3x3 x2 (64) - pool - x2 (128) - pool - x3 (256) - pool - x3 (512)
  - pool - x3 (512) - pool - adaptive-avg 7x7 - fc6(4096) - fc7(4096)

* `VGG16Features`: uint8 NHWC -> bilinear resize to 224 (no antialias) ->
  minus `VGG_MEAN` -> the graph -> relu(fc7); the 7x7 map is flattened
  channel-major (NCHW), as torch flattens it.
* `LPIPSFeatures`: float NHWC in [-1, 1] -> (x - LPIPS_SHIFT) / LPIPS_SCALE ->
  taps at relu1_2 / 2_2 / 3_3 / 4_3 / 5_3, each unit-normalized over its
  channels as `x * rsqrt(sum(x^2) + 1e-10)` (the JAX package's form), scaled
  by sqrt(max(lin_k, 0)) when the heads are present and by 1/sqrt(H*W),
  flattened in NHWC order and concatenated.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# conv layer indices in torchvision vgg16.features
_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# conv indices after whose relu LPIPS taps activations
_LPIPS_TAPS = (2, 7, 14, 21, 28)

VGG_MEAN = np.asarray([123.68, 116.779, 103.939], np.float32)
# LPIPS input normalization (pytorch-LPIPS ScalingLayer constants)
LPIPS_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Flat CPU state_dict from any accepted weight-file format
    (detectors_manifest.py): `.npz`, a plain torch state_dict checkpoint, or a
    TorchScript archive (the reference's `vgg16.pt` and
    `inception-2015-12-05.pt`), whose `layers.`-wrapped names are stripped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # not a plain checkpoint: a TorchScript archive
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k.split("layers.", 1)[-1]: torch.as_tensor(v).detach() for k, v in obj.items()}


def params_from_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state_dict (tensors or numpy arrays; + optional
    LPIPS heads) -> this module's state_dict: `features.N.*` as given,
    `classifier.0/3` as `fc6/fc7`, each head as `lin{k}` [C_k]."""
    def t(v):
        return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float32))

    if "features.0.weight" not in sd:
        raise ValueError(f"state_dict does not look like a torchvision vgg16 (keys: {sorted(sd)[:5]}...)")
    out = {}
    for i in _CONV_IDX:
        out[f"features.{i}.weight"] = t(sd[f"features.{i}.weight"])
        out[f"features.{i}.bias"] = t(sd[f"features.{i}.bias"])
    for j, name in ((0, "fc6"), (3, "fc7")):
        if f"classifier.{j}.weight" in sd:
            out[f"{name}.weight"] = t(sd[f"classifier.{j}.weight"])
            out[f"{name}.bias"] = t(sd[f"classifier.{j}.bias"])
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in sd:
                out[f"lin{k}"] = t(sd[key]).reshape(-1)
                break
    return out


def _features() -> nn.Sequential:
    layers, c_in = [], 3
    for item in _PLAN:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, item, 3, padding=1), nn.ReLU()]
            c_in = item
    return nn.Sequential(*layers)


def resize_square(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW float -> size x size, bilinear with half-pixel centres and no
    antialias: the JAX package's `jax.image.resize(..., "bilinear",
    antialias=False)`, up or down.  The detectors' resize."""
    if x.shape[2] == size and x.shape[3] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=False)


class _VGG16(nn.Module):
    def __init__(self, params: Mapping[str, torch.Tensor], device, head: bool):
        super().__init__()
        self.features = _features()
        if head:
            self.fc6, self.fc7 = nn.Linear(512 * 49, 4096), nn.Linear(4096, 4096)
            missing = [k for k in ("fc6.weight", "fc7.weight") if k not in params]
            if missing:
                raise KeyError(f"the PR features need vgg16's classifier: missing {missing}")
        for k in range(5):
            if f"lin{k}" in params:
                self.register_buffer(f"lin{k}", torch.empty_like(params[f"lin{k}"]))
        self.load_state_dict({k: params[k] for k in self.state_dict()}, strict=True)
        self.requires_grad_(False).eval().to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.features[0].weight.device

    @classmethod
    def from_state_dict(cls, sd, device="cuda"):
        return cls(params_from_state_dict(sd), device)

    @classmethod
    def from_file(cls, path: str, device="cuda"):
        return cls.from_state_dict(load_state_dict_file(path), device)


class VGG16Features(_VGG16):
    """PR-metric extractor: uint8 NHWC RGB (numpy or tensor) -> [N, 4096]
    relu(fc7) features on the module's device."""

    tag = "vgg16-torch-v1"

    def __init__(self, params, device="cuda"):
        super().__init__(params, device, head=True)

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        x = resize_square(torch.as_tensor(images, device=self.device).permute(0, 3, 1, 2).float(), 224)
        x = x - torch.as_tensor(VGG_MEAN, device=x.device)[:, None, None]
        x = F.adaptive_avg_pool2d(self.features(x), 7).flatten(1)  # channel-major, as torch flattens NCHW
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class LPIPSFeatures(_VGG16):
    """LPIPS-VGG16 embedding: float NHWC in [-1, 1] -> [N, D] with
    ||f(a) - f(b)||^2 == LPIPS(a, b) (spatial mean, head-weighted).  Without
    the heads every channel weighs 1: relative comparisons hold, the absolute
    scale is not the published calibration's."""

    tag = "lpips-vgg16-torch-v1"

    def __init__(self, params, device="cuda"):
        super().__init__(params, device, head=False)

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, device=self.device).float()
        x = ((x - torch.as_tensor(LPIPS_SHIFT, device=x.device)) / torch.as_tensor(LPIPS_SCALE, device=x.device))
        x = x.permute(0, 3, 1, 2)
        outs, last = [], max(_LPIPS_TAPS) + 1  # the relu after the deepest tapped conv
        for idx, layer in enumerate(self.features[: last + 1]):
            x = layer(x)
            if idx - 1 in _LPIPS_TAPS:
                lin = getattr(self, f"lin{len(outs)}", None)
                n = x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
                if lin is not None:
                    n = n * torch.sqrt(lin.clamp(min=0.0))[:, None, None]
                N, _, H, W = n.shape
                outs.append((n / math.sqrt(H * W)).permute(0, 2, 3, 1).reshape(N, -1))
        return torch.cat(outs, dim=-1)
