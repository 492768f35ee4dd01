"""GeneratorV11 / GeneratorV12, the predicted-blending-mask clusters
(counterpart of `pasta_gan_tpu/models/generator_v11.py`).

Every ToRGB of the pyramid also predicts a sigmoid blending mask (a second
demodulation-free modulated conv, `m_weight`), and a spade-modulated copy of
the last block runs again as a finetune branch, its spatial styles gated by
the thresholded, detached mask:

* V11: the spade block runs from the second-to-last block's output (conv0
  up=2, the image upsampled) on the last block's ws; its spade features are
  the style encoder's denorm features at the last resolution (NGF channels)
  and at half of it (2 NGF).
* V12: the spade block takes the last block's output (conv0 at up=1, the
  image not upsampled) and has ws slots of its own (num_ws grows by 3; the
  first aliases the last ToRGB's, as in the reference).

Both return (img, finetune_img, mask), NHWC.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.encoders import StyleEncoderNetworkV16
from ..nn.layers import Conv2dLayer, FullyConnectedLayer, Layer, SelfAttention, _filter_buffer, _normal_
from ..ops.bias_act import bias_act
from ..ops.modulated_conv2d import modulated_conv2d
from ..ops.upfirdn2d import upsample2d
from .generator_full import cat_feats_dict, nchw, nhwc
from .generator_v10 import NGF, SynthesisLayerSpade, ZooGenerator, spade_feat_channels, spade_pyramid, tapped


class ToRGBLayerV11(Layer):
    """The plain blocks' ToRGB predicts (img, sigmoid mask) from two
    demodulation-free modulated convs (`weight`, `m_weight`); the spade
    block's ToRGB has no mask head and applies the masked spatial styles
    (`spade_affine.0/1`) to its image conv."""

    def __init__(self, in_channels, out_channels, w_dim, spade_feat_channels=None, conv_clamp=None):
        super().__init__()
        self.in_channels, self.conv_clamp = in_channels, conv_clamp
        self.is_spade_block = spade_feat_channels is not None
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if self.is_spade_block:
            self.spade_affine = nn.Sequential(Conv2dLayer(spade_feat_channels, in_channels, 1),
                                              Conv2dLayer(in_channels, in_channels, 1))
        else:
            self.m_weight = nn.Parameter(torch.empty(1, in_channels, 1, 1))
            self.m_bias = nn.Parameter(torch.zeros(1))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for name in ("weight", "bias") if self.is_spade_block else ("weight", "bias", "m_weight", "m_bias"):
            if name.endswith("bias"):
                with torch.no_grad():
                    getattr(self, name).zero_()
            else:
                _normal_(getattr(self, name), generator)

    def forward(self, x, w, denorm_feat=None, denorm_feat_mask=None):
        dt = self.compute_dtype
        styles = self.affine(w) * (1.0 / math.sqrt(self.in_channels))
        x = x.to(dt)
        if self.is_spade_block:
            spade_styles = self.spade_affine(denorm_feat) * denorm_feat_mask
            y = modulated_conv2d(x, self.weight.to(dt), styles, spade_styles=spade_styles, demodulate=False)
            return bias_act(y, self.bias, clamp=self.conv_clamp), None
        mask = modulated_conv2d(x, self.m_weight.to(dt), styles, demodulate=False)
        mask = bias_act(mask, self.m_bias, act="sigmoid", clamp=self.conv_clamp)
        y = modulated_conv2d(x, self.weight.to(dt), styles, demodulate=False)
        return bias_act(y, self.bias, clamp=self.conv_clamp), mask


def _gate(mask, dtype):
    """The spatial gate: the mask thresholded at 0.9, detached."""
    return (mask > 0.9).to(dtype).detach()


class SynthesisBlockV11(Layer):
    """A V11-cluster skip block.  A plain block predicts the mask with its
    ToRGB.  A spade block (`is_spade_block`) modulates conv0 by the spade
    features at the input's resolution (V11: half the block's, V12: the
    block's own), conv1 and the ToRGB by those at the block's resolution,
    each gated by the mask at its resolution; with `use_atten` (V13/V14) a
    self-attention follows conv1."""

    num_torgb = 1

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, img_resolution,
                 is_spade_block=False, v12=False, use_atten=False, conv_clamp=None, use_noise=True):
        super().__init__()
        self.in_channels, self.resolution = in_channels, resolution
        self.is_spade_block, self.v12, self.use_atten = is_spade_block, v12, use_atten
        common = dict(w_dim=w_dim, resolution=resolution, conv_clamp=conv_clamp, use_noise=use_noise)
        spade_ch = (lambda res: spade_feat_channels(img_resolution, res)) if is_spade_block else (lambda res: None)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
        else:
            self.res0 = resolution if v12 else resolution // 2  # the resolution conv0 reads
            self.conv0 = SynthesisLayerSpade(in_channels, out_channels, up=1 if (is_spade_block and v12) else 2,
                                             spade_feat_channels=spade_ch(self.res0), **common)
        self.conv1 = SynthesisLayerSpade(out_channels, out_channels,
                                         spade_feat_channels=spade_ch(resolution) if in_channels else None, **common)
        if in_channels != 0 and use_atten:
            self.atten = SelfAttention(out_channels)
        if in_channels != 0 and resolution > 16:
            self.merge_conv = Conv2dLayer(out_channels + NGF, out_channels, 1)
        self.torgb = ToRGBLayerV11(out_channels, img_channels, w_dim, spade_feat_channels=spade_ch(resolution),
                                   conv_clamp=conv_clamp)
        _filter_buffer(self, (1, 3, 3, 1))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.in_channels == 0:
            _normal_(self.const, generator)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def forward(self, x, img, ws, pose_feature, cat_feat, spade_feats=None, spade_mask=None, noise_mode="random",
                generator=None):
        dt = self.conv1.compute_dtype
        spade = self.is_spade_block
        if self.in_channels == 0:
            x = self.conv1(pose_feature.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            w_idx = 1
        elif spade:
            m0 = spade_mask if self.v12 else spade_mask[:, :, ::2, ::2]
            x = self.conv0(x.to(dt), ws[:, 0], spade_feats[str(self.res0)], spade_mask=_gate(m0, dt),
                           noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], spade_feats[str(self.resolution)], spade_mask=_gate(spade_mask, dt),
                           noise_mode=noise_mode, generator=generator)
            w_idx = 2
            if self.use_atten:
                x = self.atten(x)
        else:
            x = self.conv0(x.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, generator=generator)
            w_idx = 2
        if self.in_channels != 0 and self.resolution > 16:
            x = self.merge_conv(torch.cat([x, cat_feat[str(self.resolution)].to(dt)], dim=1))
        if img is not None and not (spade and self.v12):
            img = upsample2d(img, self.resample_filter)
        if spade:
            y, mask = self.torgb(x, ws[:, w_idx], spade_feats[str(self.resolution)], _gate(spade_mask, dt))
        else:
            y, mask = self.torgb(x, ws[:, w_idx])
        y = y.float()
        return x, img + y if img is not None else y, mask


class StyleEncoderNetworkV11(StyleEncoderNetworkV16):
    """StyleEncoderNetworkV16's style and retain branches plus a denorm
    encoder tapped after its two ResBlocks: NGF channels at /1 and 2 NGF at
    /2.  Returns (style, retain features, denorm features)."""

    STAGES = ((1, 1, 1), (1, 2, 2))  # (in, out, down) of each ResBlock, in multiples of NGF
    TAPS = (1, 2)

    def __init__(self, input_nc, output_nc=512):
        super().__init__(input_nc, output_nc=output_nc, ngf=NGF, extra_convs=3)
        self.spade_encoder = spade_pyramid(self.STAGES)

    def forward(self, x, const_input, denorm_input):
        style, feats = super().forward(x, const_input)
        return style, feats, tapped(self.spade_encoder, denorm_input, self.TAPS)


class _GeneratorV11Base(ZooGenerator):
    """The V11 pyramid (`synthesis.b{res}`), the pose encoder, the mapping and
    the style encoder; the spade blocks (`_spade_blocks`) and the style
    encoder (`_style_encoder`) are the subclass's."""

    extra_ws = 0  # ws slots beyond the pyramid's

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        common = dict(w_dim=w_dim, img_channels=img_channels, img_resolution=img_resolution, conv_clamp=conv_clamp,
                      use_noise=use_noise)
        blocks = {f"b{res}": SynthesisBlockV11(self.channels(res // 2) if res > 4 else 0, self.channels(res),
                                               resolution=res, **common)
                  for res in self.block_resolutions}
        blocks.update(self._spade_blocks(common))
        self.synthesis = nn.ModuleDict(blocks)
        self._pose_and_mapping(self.pyramid_num_ws + self.extra_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = self._style_encoder(style_input_nc)
        self.set_dtype(dtype)

    def _spade_blocks(self, common):
        raise NotImplementedError

    def _style_encoder(self, style_input_nc):
        return StyleEncoderNetworkV11(style_input_nc, output_nc=512)

    def _encode(self, z, c, retain, pose, denorm_input, w_avg, truncation_psi, truncation_cutoff):
        """-> (pose feature, retain features, spade features, ws), NCHW."""
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats, denorm_feats = self.style_encoding(nchw(c), nchw(retain), nchw(denorm_input))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        return pose_feat, cat_feats_dict(feats), cat_feats_dict(denorm_feats), ws


class GeneratorV11(_GeneratorV11Base):
    """forward(z, c, retain, pose, denorm_input) -> (img, finetune_img, mask), NHWC."""

    v12 = False

    @property
    def extra_ws(self):
        return 3 if self.v12 else 0

    def _spade_blocks(self, common):
        res = self.img_resolution
        return {"spade_b256": SynthesisBlockV11(self.channels(res if self.v12 else res // 2), self.channels(res),
                                                resolution=res, is_spade_block=True, v12=self.v12, **common)}

    def forward(self, z, c, retain, pose, denorm_input, truncation_psi=1.0, truncation_cutoff=None, w_avg=None,
                noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat, cat_feats, spade_feats, ws = self._encode(z, c, retain, pose, denorm_input, w_avg,
                                                             truncation_psi, truncation_cutoff)
        block_ws, w_idx = self.split_ws(self.pyramid, ws)
        x = img = mask = x_128 = img_128 = None
        for block, cur_ws in zip(self.pyramid, block_ws):
            x, img, mask = block(x, img, cur_ws, pose_feat, cat_feats, noise_mode=noise_mode, generator=generator)
            if block.resolution == self.img_resolution // 2:
                x_128, img_128 = x, img
        if self.v12:
            # the spade block's first w aliases the last ToRGB's (the reference narrows
            # ws at the conv count)
            src, spade_ws = (x, img), ws[:, w_idx : w_idx + 3]
        else:
            src, spade_ws = (x_128, img_128), block_ws[-1]
        _, finetune_img, _ = self.synthesis["spade_b256"](*src, spade_ws, pose_feat, cat_feats, spade_feats,
                                                          spade_mask=mask, noise_mode=noise_mode, generator=generator)
        return nhwc(img), nhwc(finetune_img), nhwc(mask)


class GeneratorV12(GeneratorV11):
    """The V12 cluster: the spade block on the last block's output, with ws
    slots of its own (`networks.py:3102-3148` in the reference)."""

    v12 = True
