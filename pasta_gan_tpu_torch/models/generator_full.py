"""GeneratorFull (counterpart of `pasta_gan_tpu/models/generator_full.py`).

const_encoding (pose + retain, 6ch -> 4x4 feature map), style_encoding
(42-channel patch stack + retain -> 512-d style code + retain features),
mapping (style code -> ws), SynthesisNetworkFull.

Public tensors are NHWC like the JAX package's: `forward` takes the try-on
batch's NHWC tensors and returns (img, finetune_img, pred_parsing) in NHWC.
The sub-callables `encode_style`, `encode_pose`, `map_ws` and `synthesize`
take the same NHWC inputs; the features they hand to `synthesize` (pose
feature, retain features) are internal NCHW tensors.

`quant` is the int8 serving mode (None, "int8", "int8_calib" or
"int8_static"; ops/quant.py), settable after construction so that one model
can be calibrated and then served; the mapping and the ToRGB layers stay
float.  The activation sites' scales are non-persistent buffers, so the
state_dict is the same under every mode; `quant_scales()` /
`load_quant_scales()` read and set them by the JAX package's site names.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..nn.encoders import ConstEncoderNetwork, StyleEncoderNetworkV16
from ..nn.layers import Layer
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SynthesisNetworkFull
from ..ops import quant as q


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def cat_feats_dict(feats) -> Dict[str, torch.Tensor]:
    """Index the multi-resolution retain features by spatial size."""
    return {str(f.shape[2]): f for f in feats}


class GeneratorFull(nn.Module):
    variant = "full"  # a snapshot records it (cli/test.py:load_generator, models.GENERATORS)
    synthesis_variant = "full"  # the last style block's head (nn/synthesis.py:SynthesisNetworkFull.VARIANTS)
    start_res, merge_min_res, style_extra_convs = 4, 16, 3  # pyramid start, retain merge, style encoder depth

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3,
                 mapping_layers=1, channel_base=16384, channel_max=512, conv_clamp=256.0,
                 use_noise=True, style_input_nc=42, dtype=torch.float32, quant=None):
        super().__init__()
        self.config = dict(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, mapping_layers=mapping_layers, channel_base=channel_base,
            channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise,
            style_input_nc=style_input_nc,
        )
        self.synthesis = SynthesisNetworkFull(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            channel_base=channel_base, channel_max=channel_max, conv_clamp=conv_clamp,
            use_noise=use_noise, variant=self.synthesis_variant, start_res=self.start_res,
            merge_min_res=self.merge_min_res,
        )
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, self.num_ws, num_layers=mapping_layers)
        # the pose image down to the pyramid's first resolution, at most 6 times
        n_down = int(math.log2(img_resolution)) - int(math.log2(self.start_res))
        self.const_encoding = ConstEncoderNetwork(
            6, output_nc=self.synthesis.channels(self.start_res), ngf=64, n_downsampling=min(n_down, 6))
        self.style_encoding = StyleEncoderNetworkV16(style_input_nc, output_nc=512, ngf=64,
                                                     extra_convs=self.style_extra_convs)
        self.set_dtype(dtype)
        self.quant = quant

    @property
    def quant(self):
        return self._quant

    @quant.setter
    def quant(self, mode) -> None:
        """Set the int8 serving mode of every module that follows it."""
        if mode is not None and not q.is_int8(mode):
            raise ValueError(f"quant must be None or one of {q.INT8_MODES}, got {mode!r}")
        self._quant = mode
        for m in self.modules():
            if isinstance(m, q.QuantMode):
                m.quant = mode

    def quant_scales(self) -> Dict[str, torch.Tensor]:
        return q.quant_scales(self)

    def load_quant_scales(self, scales: Dict[str, torch.Tensor]) -> "GeneratorFull":
        q.load_quant_scales(self, scales)
        return self

    def set_dtype(self, dtype: torch.dtype) -> "GeneratorFull":
        """Compute dtype of every layer (parameters stay float32)."""
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, Layer):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "GeneratorFull":
        """Redraw every parameter from `generator`, in module order."""
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)
        return self

    # -- sub-network entry points (the reference's G.style_encoding / G.const_encoding /
    #    G.mapping / G.synthesis split that the test CLI calls explicitly)

    def encode_pose(self, pose: torch.Tensor) -> torch.Tensor:
        return self.const_encoding(nchw(pose))

    def encode_style(self, style_input: torch.Tensor, retain: torch.Tensor):
        return self.style_encoding(nchw(style_input), nchw(retain))

    def map_ws(self, z, c, w_avg=None, truncation_psi=1.0, truncation_cutoff=None):
        return self.mapping(z, c, w_avg=w_avg, truncation_psi=truncation_psi,
                            truncation_cutoff=truncation_cutoff)

    def synthesize(self, ws, pose_feat, cat_feats, denorm_upper_input, denorm_lower_input,
                   denorm_upper_mask, denorm_lower_mask, noise_mode="random", generator=None):
        img, finetune_img, parsing = self.synthesis(
            ws, pose_feat, cat_feats, nchw(denorm_upper_input), nchw(denorm_lower_input),
            nchw(denorm_upper_mask), nchw(denorm_lower_mask), noise_mode=noise_mode,
            generator=generator,
        )
        return nhwc(img), nhwc(finetune_img), nhwc(parsing)

    def forward(self, z, c, retain, pose, denorm_upper_input, denorm_lower_input,
                denorm_upper_mask, denorm_lower_mask, truncation_psi=1.0, truncation_cutoff=None,
                w_avg=None, noise_mode="random", generator=None):
        pose_feat = self.encode_pose(pose)
        stylecode, feats = self.encode_style(c, retain)
        ws, _ = self.map_ws(z, stylecode, w_avg=w_avg, truncation_psi=truncation_psi,
                            truncation_cutoff=truncation_cutoff)
        return self.synthesize(
            ws, pose_feat, cat_feats_dict(feats), denorm_upper_input, denorm_lower_input,
            denorm_upper_mask, denorm_lower_mask, noise_mode=noise_mode, generator=generator,
        )
