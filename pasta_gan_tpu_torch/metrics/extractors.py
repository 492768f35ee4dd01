"""Feature extractors for the metrics suite (counterpart of `pasta_gan_tpu/metrics/extractors.py`).

An extractor is a callable: uint8 RGB images [N, H, W, 3] (a numpy array or
a tensor) -> features [N, D] (a tensor on its device, or a numpy array);
`metric_main._accumulate` brings the features to the host.

* `SimpleConvFeatures`: a fixed-seed random conv net (4 stride-2 3x3 convs
  with "SAME" padding and leaky relu 0.2, global mean and max pooling, a
  256 -> dim projection).  NOT an InceptionV3 substitute for publishable
  FID numbers, but a deterministic stand-in that runs the whole pipeline
  offline.  Its weights come from `torch.Generator(seed)`, so the same seed
  draws other weights than the JAX package's `jax.random` keys; its tag is
  its own.  `io/from_jax.py:simpleconv_state_dict_from_jax` carries the JAX
  weights across.
* `jax_simpleconv`: SimpleConvFeatures with the JAX `SimpleConvFeatures(seed=0)`'s
  weights, read from `simpleconv_jax_seed0.npz` beside this file (written by
  `scripts/export_simpleconv_jax.py`): the extractor of the JAX records'
  fid_proxy, and of `metrics/quality.py`.
* `TorchScriptDetector`: the reference's TorchScript detector file, run on
  the given device.
* `default_extractor`: InceptionV3 from a detector file, or
  `SimpleConvFeatures` without one.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

FeatureExtractor = Callable[[np.ndarray], object]

_CHANS = (3, 32, 64, 128, 128)


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of XLA's "SAME" (`lax.padtype_to_pads`): the
    output has ceil(size / stride) samples, the odd pixel of padding goes
    after.  For a 3x3 stride-2 conv that is (0, 1) on even sizes, (1, 1) on
    odd ones."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SimpleConvFeatures(nn.Module):
    """Deterministic random conv features: uint8 (or float in [0, 255]) NHWC
    -> [N, dim].  `kernel{i}` are OIHW, `proj` is [256, dim]."""

    tag = "simpleconv-torch-v1"

    def __init__(self, dim: int = 256, seed: int = 0, device="cuda"):
        super().__init__()
        self.dim = dim
        g = torch.Generator().manual_seed(seed)
        for i in range(4):
            c_in, c_out = _CHANS[i], _CHANS[i + 1]
            self.register_buffer(f"kernel{i}", torch.randn((c_out, c_in, 3, 3), generator=g) / math.sqrt(9 * c_in))
        self.register_buffer("proj", torch.randn((256, dim), generator=g) / 16.0)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, device=self.proj.device).float() / 127.5 - 1.0
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
            x = F.conv2d(F.pad(x, (*pw, *ph)), getattr(self, f"kernel{i}"), stride=2)
            x = F.leaky_relu(x, 0.2)
        feat = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)
        return feat @ self.proj


JAX_SIMPLECONV_SEED0 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "simpleconv_jax_seed0.npz")


def jax_simpleconv(device="cuda") -> SimpleConvFeatures:
    """SimpleConvFeatures carrying the JAX package's seed-0 weights
    (`JAX_SIMPLECONV_SEED0`: kernel0..kernel3 HWIO and proj, float32); tagged
    "simpleconv-jax-seed0"."""
    from ..io.from_jax import simpleconv_state_dict_from_jax

    ext = SimpleConvFeatures(device="cpu")
    with np.load(JAX_SIMPLECONV_SEED0) as f:
        sd = simpleconv_state_dict_from_jax([f[f"kernel{i}"] for i in range(4)], f["proj"], ext.state_dict())
    ext.load_state_dict(sd, strict=True)
    ext.tag = "simpleconv-jax-seed0"
    return ext.to(resolve_device(device))


class TorchScriptDetector:
    """The reference's TorchScript detectors (inception-2015-12-05.pt,
    vgg16.pt) on `device`: uint8 NHWC in, the detector's output out."""

    def __init__(self, path: str, return_features: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.model = torch.jit.load(path, map_location=self.device).eval()
        self.kwargs = {"return_features": True} if return_features else {}
        self.tag = f"torchscript-torch-{os.path.basename(path)}"

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        return self.model(torch.as_tensor(images, device=self.device).permute(0, 3, 1, 2).contiguous(), **self.kwargs)


def default_extractor(detector_path: Optional[str] = None, device="cuda") -> FeatureExtractor:
    """With a detector file: `InceptionV3Features` with the file's weights
    (state_dict, TorchScript or .npz; metrics/inception.py), or, for a file
    that holds no inception graph, the TorchScript file itself.  Without a
    file: the SimpleConvFeatures stand-in (NOT FID-comparable)."""
    if detector_path:
        from .inception import InceptionV3Features

        try:
            return InceptionV3Features.from_file(detector_path, device=device)
        except (KeyError, ValueError) as e:  # not an inception graph (e.g. vgg16.pt)
            logging.getLogger(__name__).warning(
                "%s is not an InceptionV3 state_dict (%s); running it as a TorchScript detector", detector_path, e)
            return TorchScriptDetector(detector_path, device=device)
    return SimpleConvFeatures(device=device)
