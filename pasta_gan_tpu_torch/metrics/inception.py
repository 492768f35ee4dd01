"""InceptionV3 FID feature extractor (counterpart of `pasta_gan_tpu/metrics/inception.py`).

The FID variant of InceptionV3 (TF inception / pytorch-fid), as an
`nn.Module` that runs NCHW on cuDNN:

* BasicConv2d = conv without bias, then BN (eps 1e-3) folded into a
  per-channel scale and shift at load time, then relu;
* mixes A-E; every 3x3 average pool has `count_include_pad=False`, and
  Mixed_7c's pool branch is a max pool (FIDInceptionE_2);
* features are the 2048-d global mean ("pool3").

Input: uint8 RGB [N, H, W, 3] (numpy or tensor), resized to 299x299 by
bilinear interpolation with half-pixel centres and no antialias
(`F.interpolate(align_corners=False)`, the JAX package's
`jax.image.resize(..., antialias=False)`), then mapped to [-1, 1].  It runs
in float32; the caller pins TF32 off (`cli/calc_metrics.py` does).

Weights: `from_state_dict` takes torchvision / pytorch-fid names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`, ...);
`from_file` takes a `.pt`/`.pth` state_dict, the reference's TorchScript
detector (its `layers.` prefix stripped) or an `.npz` export.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .vgg16 import load_state_dict_file, resize_square

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) + folded BN + relu; `weight` OIHW, `scale` and `shift` [O]."""

    def __init__(self, c_in, c_out, kernel, stride=1, padding=0):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding = stride, padding
        self.register_buffer("weight", torch.zeros(c_out, c_in, kh, kw))
        self.register_buffer("scale", torch.ones(c_out))
        self.register_buffer("shift", torch.zeros(c_out))

    def forward(self, x):
        x = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        return F.relu(x * self.scale[:, None, None] + self.shift[:, None, None])


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, c_in, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        # Mixed_7c (FIDInceptionE_2) pools by max, Mixed_7b by average
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avgpool3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


def fold_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A torchvision-style inception_v3 state_dict (tensors or numpy arrays)
    -> this module's state_dict, BN folded for inference as the JAX package
    folds it: scale = gamma / sqrt(var + eps), shift = beta - mean * scale
    (float32)."""
    def t(name):
        v = sd[name]
        return torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v).float()

    prefixes = sorted({k.rsplit(".conv.weight", 1)[0] for k in sd if k.endswith(".conv.weight")})
    if "Conv2d_1a_3x3" not in prefixes:
        raise ValueError(f"state_dict does not look like a torchvision inception_v3 (found prefixes: {prefixes[:5]}...)")
    out = {}
    for name in prefixes:
        scale = t(f"{name}.bn.weight") / torch.sqrt(t(f"{name}.bn.running_var") + BN_EPS)
        out[f"{name}.weight"] = t(f"{name}.conv.weight")
        out[f"{name}.scale"] = scale
        out[f"{name}.shift"] = t(f"{name}.bn.bias") - t(f"{name}.bn.running_mean") * scale
    return out


class InceptionV3Features(nn.Module):
    """uint8 NHWC RGB -> [N, 2048] float32 pool3 features on the module's
    device.  `tag` keys the FeatureStats cache (metrics/feature_stats.py);
    it is not the JAX package's, so neither package reads the other's
    cached statistics."""

    tag = "inception-torch-v1"

    def __init__(self, params: Optional[Mapping[str, torch.Tensor]] = None, device="cuda"):
        """`params`: this module's folded state_dict (`fold_state_dict`); None
        leaves the zero weights of the bare graph (for its structure)."""
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg")
        self.Mixed_7c = InceptionE(2048, pool="max")
        if params is not None:
            self.load_state_dict({k: params[k] for k in self.state_dict()}, strict=True)
        self.eval().to(resolve_device(device))

    @classmethod
    def from_state_dict(cls, sd, device="cuda") -> "InceptionV3Features":
        return cls(fold_state_dict(sd), device)

    @classmethod
    def from_file(cls, path: str, device="cuda") -> "InceptionV3Features":
        """A .pt/.pth state_dict, a TorchScript detector or an .npz."""
        return cls.from_state_dict(load_state_dict_file(path), device)

    @property
    def device(self) -> torch.device:
        return self.Conv2d_1a_3x3.weight.device

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        x = resize_square(torch.as_tensor(images, device=self.device).permute(0, 3, 1, 2).float(), 299)
        x = x / 127.5 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for mix in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                    self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = mix(x)
        return x.mean(dim=(2, 3))
