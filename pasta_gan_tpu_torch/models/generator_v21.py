"""The single-branch clusters GeneratorV16, GeneratorV20 and GeneratorV21
(counterpart of `pasta_gan_tpu/models/generator_v21.py`): the pose encoder,
StyleEncoderNetworkV16 over the 48-channel style stack, the mapping and
`nn/synthesis.py:SynthesisNetworkSingle`.

* GeneratorV16: forward(z, c, retain, pose, denorm_clothes, denorm_mask) ->
  (img, finetune_img, mask);
* GeneratorV20: module for module V16 (the reference's V20 fork differs only
  in its training script), a class of its own for configs and checkpoints;
* GeneratorV21: the hand-mask head and the face-average fill;
  forward(..., face_mask) -> (img, finetune_img, mask, h_mask).

NHWC in and out.  The JAX classes' `pack_tail` (W-packing) has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.encoders import StyleEncoderNetworkV16
from ..nn.synthesis import SynthesisNetworkSingle
from .generator_full import cat_feats_dict, nchw, nhwc
from .generator_v10 import NGF, ZooGenerator


class GeneratorV16(ZooGenerator):
    variant = "v16"  # SynthesisNetworkSingle's

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        self.synthesis = SynthesisNetworkSingle(w_dim, img_resolution, img_channels, channel_base=channel_base,
                                                channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise,
                                                variant=self.variant)
        self._pose_and_mapping(self.synthesis.num_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = StyleEncoderNetworkV16(style_input_nc, output_nc=512, ngf=NGF, extra_convs=3)
        self.set_dtype(dtype)

    def forward(self, z, c, retain, pose, denorm_clothes, denorm_mask, face_mask=None, truncation_psi=1.0,
                truncation_cutoff=None, w_avg=None, noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats = self.style_encoding(nchw(c), nchw(retain))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        out = self.synthesis(ws, pose_feat, cat_feats_dict(feats), nchw(denorm_clothes), nchw(denorm_mask),
                             face_mask=nchw(face_mask) if self.variant == "v21" else None, noise_mode=noise_mode,
                             generator=generator)
        return tuple(nhwc(t) for t in out)


class GeneratorV20(GeneratorV16):
    """Module for module GeneratorV16."""


class GeneratorV21(GeneratorV16):
    """The hand-mask head and the face-average fill of the SPADE features."""

    variant = "v21"
