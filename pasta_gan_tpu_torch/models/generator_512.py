"""The 512x320 generators (counterpart of `pasta_gan_tpu/models/generator_512.py`).

`Generator512`, the released 512 checkpoint's interface: the Full wiring at
512.  The synthesis pyramid starts at 8 (`start_res=8`, so the const encoder
downsamples min(6, log2(res) - 3) times, 512 -> 8x8), merges the retain
features above 32 (`merge_min_res=32`) and keeps the Full variant's parsing
head, SPADE refinement and texture finetune block; the style encoder takes
the 45-channel stack of `prepare_tryon_batch_512` (the 10 upper parts and
the 5 lower parts {0, 6..9}, 3 channels each) and has no extra
convolutions.  The sub-callables and `forward` are GeneratorFull's, NHWC,
returning (img, finetune_img, pred_parsing).

`Generator512Plain`, the reference's literal `Generator_512` (48-channel
style input) and `Generator_512_v2` (60 channels): the same encoders and
mapping, and a plain skip pyramid 8 -> img_resolution of `SynthesisBlockFull`
blocks without a head (`is_style=False`), merging the retain features above
32, with no SPADE branch and no finetune block.  `forward(z, c, retain,
pose, ...)` returns the image alone, NHWC.  It is not on a serving path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.encoders import ConstEncoderNetwork, StyleEncoderNetworkV16
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SynthesisBlockFull
from .generator_full import GeneratorBase, GeneratorFull, cat_feats_dict, nchw, nhwc


class Generator512(GeneratorFull):
    variant = "512"  # what a snapshot records; the synthesis is the Full variant
    start_res, merge_min_res, style_extra_convs = 8, 32, 0

    def __init__(self, img_resolution: int = 512, channel_base: int = 32768, style_input_nc: int = 45, **kwargs):
        super().__init__(img_resolution=img_resolution, channel_base=channel_base, style_input_nc=style_input_nc,
                         **kwargs)


class _Synthesis512Plain(nn.Module):
    """SynthesisNetwork_512 (reference `networks.py:3679-3728`): skip pyramid
    8 -> img_resolution, retain merge above 32, plain ToRGB, no refinement."""

    start_res = 8

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512, conv_clamp=None,
                 use_noise=True):
        super().__init__()
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(3, int(math.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockFull(
                self.channels(res // 2) if res > self.start_res else 0, self.channels(res), w_dim, resolution=res,
                img_channels=img_channels, is_last=res == img_resolution, is_style=False, merge_min_res=32,
                conv_clamp=conv_clamp, use_noise=use_noise))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return sum(1 if r == self.start_res else 2 for r in self.block_resolutions) + 1

    def forward(self, ws, pose_feat, cat_feat, noise_mode="random", generator=None):
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} entries, expected {self.num_ws}")
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img, _ = block(x, img, ws[:, w_idx : w_idx + block.num_conv + block.num_torgb], pose_feat, cat_feat,
                              noise_mode, generator)
            w_idx += block.num_conv
        return img


class Generator512Plain(GeneratorBase):
    """The reference's `Generator_512` (`networks.py:3781-3816`); pass
    `style_input_nc=60` for `Generator_512_v2`."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=512, img_channels=3, mapping_layers=1,
                 channel_base=32768, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__()
        self.synthesis = _Synthesis512Plain(w_dim, img_resolution, img_channels, channel_base=channel_base,
                                            channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, self.num_ws, num_layers=mapping_layers)
        n_down = min(6, int(math.log2(img_resolution)) - 3)  # 512 -> 8x8
        self.const_encoding = ConstEncoderNetwork(6, output_nc=self.synthesis.channels(8), ngf=64,
                                                  n_downsampling=n_down)
        self.style_encoding = StyleEncoderNetworkV16(style_input_nc, output_nc=512, ngf=64, extra_convs=0)
        self.set_dtype(dtype)

    def forward(self, z, c, retain, pose, truncation_psi=1.0, truncation_cutoff=None, w_avg=None,
                noise_mode="random", generator=None):
        """c [N, H, W, style_input_nc], retain [N, H, W, 3], pose [N, H, W, 6]
        (NHWC) -> img [N, H, W, 3] float32."""
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats = self.style_encoding(nchw(c), nchw(retain))
        ws, _ = self.mapping(z, stylecode, w_avg=w_avg, truncation_psi=truncation_psi,
                             truncation_cutoff=truncation_cutoff)
        return nhwc(self.synthesis(ws, pose_feat, cat_feats_dict(feats), noise_mode=noise_mode, generator=generator))
