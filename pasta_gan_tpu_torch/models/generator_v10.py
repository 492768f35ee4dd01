"""GeneratorV10, the spade-modulated-conv cluster (counterpart of
`pasta_gan_tpu/models/generator_v10.py`).

Its synthesis layers average the per-sample channel style with a SPATIAL
style predicted from the denormalized garment's features
(`SynthesisLayerSpade`, `ops/modulated_conv2d.py`'s `spade_styles`).  Only the
64x64 block's two convs are spade-modulated; the style encoder has three
branches (the style stack, the retain features and a denorm pyramid with a
tap after every stage), and the output is the coarse image alone.

`ZooGenerator` holds what the V10-V21 clusters and the ablations share: the
config, the channel schedule, the pose encoder and the mapping, and the ws
split of a skip pyramid.  Like GeneratorFull, their forwards take the NHWC
tensors of the JAX package and return NHWC tensors; they keep the JAX
package's module names, so `io/from_jax.py:state_dict_from_jax` carries a
JAX tree into a strict `load_state_dict`.  The port does not W-pack
(`pack_tail`), and the zoo has no int8 serving mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.encoders import ConstEncoderNetwork, StyleEncoderNetworkV16
from ..nn.layers import Conv2dLayer, Layer, ResBlock, _filter_buffer, _normal_
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SynthesisLayer, ToRGBLayer
from ..ops.upfirdn2d import upsample2d
from .generator_full import GeneratorBase, cat_feats_dict, nchw, nhwc

NGF = 64  # the encoders' base width


def spade_feat_channels(img_resolution: int, res: int, ngf: int = NGF) -> int:
    """Channels of the denorm features at `res`: the spade encoders double
    their width at every halving, so at img_resolution 256 this is the JAX
    package's table `_SPADE_FEAT_CH` {32: 512, 64: 256, 128: 128, 256: 64}
    (and V11's `_SPADE_CH`)."""
    return ngf * img_resolution // res


class ZooGenerator(GeneratorBase):
    """Config, channel schedule, pose encoder and mapping of the zoo."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48):
        super().__init__()
        self.config = dict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
                           img_channels=img_channels, mapping_layers=mapping_layers, channel_base=channel_base,
                           channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise,
                           style_input_nc=style_input_nc)
        self.w_dim, self.img_resolution, self.img_channels = w_dim, img_resolution, img_channels
        self.channel_base, self.channel_max = channel_base, channel_max
        self.conv_clamp, self.use_noise = conv_clamp, use_noise
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def pyramid(self):
        """The skip blocks `synthesis.b{res}` (a ModuleDict's), in resolution order."""
        return [self.synthesis[f"b{res}"] for res in self.block_resolutions]

    @property
    def pyramid_num_ws(self) -> int:
        return sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1

    def _pose_and_mapping(self, num_ws: int, z_dim: int, c_dim: int, mapping_layers: int) -> None:
        self.num_ws = num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, self.w_dim, num_ws, num_layers=mapping_layers)
        n_down = min(6, int(math.log2(self.img_resolution)) - 2)
        self.const_encoding = ConstEncoderNetwork(6, output_nc=self.channels(4), ngf=NGF, n_downsampling=n_down)

    def _ws(self, z, stylecode, w_avg, truncation_psi, truncation_cutoff):
        ws, _ = self.mapping(z, stylecode, w_avg=w_avg, truncation_psi=truncation_psi,
                             truncation_cutoff=truncation_cutoff)
        return ws

    @staticmethod
    def split_ws(blocks, ws):
        """Each skip block reads num_conv + 1 ws; the index advances by num_conv."""
        out, w_idx = [], 0
        for block in blocks:
            out.append(ws[:, w_idx : w_idx + block.num_conv + 1])
            w_idx += block.num_conv
        return out, w_idx


class SynthesisLayerSpade(SynthesisLayer):
    """A synthesis layer whose style is averaged with a spatial style from the
    denorm features (`spade_affine.0` then `spade_affine.1`, 1x1 convs) when
    it has `spade_feat_channels` and is given features; the V11 clusters gate
    that style with a mask (`spade_mask`)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, spade_feat_channels=None, up=1,
                 use_noise=True, conv_clamp=None):
        super().__init__(in_channels, out_channels, w_dim, resolution, up=up, use_noise=use_noise,
                         conv_clamp=conv_clamp)
        if spade_feat_channels is not None:
            self.spade_affine = nn.Sequential(Conv2dLayer(spade_feat_channels, in_channels, 1),
                                              Conv2dLayer(in_channels, in_channels, 1))

    def forward(self, x, w, denorm_feat=None, noise_mode="random", gain=1.0, spade_mask=None, generator=None):
        spade_styles = None
        if hasattr(self, "spade_affine") and denorm_feat is not None:
            spade_styles = self.spade_affine(denorm_feat)
            if spade_mask is not None:
                spade_styles = spade_styles * spade_mask
        return super().forward(x, w, noise_mode=noise_mode, gain=gain, generator=generator,
                               spade_styles=spade_styles)


class SynthesisBlockV10(Layer):
    """The V10 skip block: the pose feature replaces the const at 4x4, the
    retain features merge above 16, and at 64x64 both convs are
    spade-modulated (conv0 by the features at 32, conv1 by those at 64)."""

    num_torgb = 1

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, img_resolution,
                 conv_clamp=None, use_noise=True):
        super().__init__()
        self.in_channels, self.resolution = in_channels, resolution
        common = dict(w_dim=w_dim, resolution=resolution, conv_clamp=conv_clamp, use_noise=use_noise)
        self.spade_here = resolution == 64 and in_channels != 0

        def feat_ch(res):
            return spade_feat_channels(img_resolution, res) if self.spade_here else None

        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
        else:
            self.conv0 = SynthesisLayerSpade(in_channels, out_channels, up=2,
                                             spade_feat_channels=feat_ch(resolution // 2), **common)
        self.conv1 = SynthesisLayerSpade(out_channels, out_channels, spade_feat_channels=feat_ch(resolution), **common)
        if in_channels != 0 and resolution > 16:
            self.merge_conv = Conv2dLayer(out_channels + NGF, out_channels, 1)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp)
        _filter_buffer(self, (1, 3, 3, 1))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.in_channels == 0:
            _normal_(self.const, generator)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def forward(self, x, img, ws, pose_feature, cat_feat, spade_feats, noise_mode="random", generator=None):
        dt = self.conv1.compute_dtype
        if self.in_channels == 0:
            x = self.conv1(pose_feature.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            w_idx = 1
        else:
            f0 = spade_feats[str(self.resolution // 2)] if self.spade_here else None
            f1 = spade_feats[str(self.resolution)] if self.spade_here else None
            x = self.conv0(x.to(dt), ws[:, 0], f0, noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], f1, noise_mode=noise_mode, generator=generator)
            w_idx = 2
            if self.resolution > 16:
                x = self.merge_conv(torch.cat([x, cat_feat[str(self.resolution)].to(dt)], dim=1))
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, ws[:, w_idx]).float()
        return x, img + y if img is not None else y


def spade_pyramid(stages):
    """The denorm encoders' stack `spade_encoder.N`: a 7x7 relu conv, then a
    relu ResBlock for each (in, out, down) multiple of NGF in `stages` (3x3
    convs: the reference's kernel_size 4 is ignored, as in the JAX package)."""
    return nn.Sequential(Conv2dLayer(3, NGF, 7, activation="relu"),
                         *[ResBlock(NGF * i, NGF * o, activation="relu", down=d) for i, o, d in stages])


def tapped(stack, x, taps):
    """Run an nn.Sequential and return the outputs of the stages in `taps`."""
    out = []
    for i, layer in enumerate(stack):
        x = layer(x)
        if i in taps:
            out.append(x)
    return out


class StyleEncoderNetworkV10(StyleEncoderNetworkV16):
    """StyleEncoderNetworkV16's style and retain branches (`model.N`,
    `feat_enc.N`, `fc`) plus the denorm pyramid `spade_encoder.N`, tapped
    after each of its four stages (64, 128, 256, 512 channels at /1 ... /8).
    Returns (style, retain features, denorm features)."""

    STAGES = ((1, 2, 2), (2, 4, 2), (4, 8, 2))  # (in, out, down) of each ResBlock, in multiples of NGF
    TAPS = (0, 1, 2, 3)

    def __init__(self, input_nc, output_nc=512):
        super().__init__(input_nc, output_nc=output_nc, ngf=NGF, extra_convs=3)
        self.spade_encoder = spade_pyramid(self.STAGES)

    def forward(self, x, const_input, denorm_input):
        style, feats = super().forward(x, const_input)
        return style, feats, tapped(self.spade_encoder, denorm_input, self.TAPS)


class GeneratorV10(ZooGenerator):
    """forward(z, c, retain, pose, denorm_input) -> the coarse image, NHWC."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        self.synthesis = nn.ModuleDict({
            f"b{res}": SynthesisBlockV10(self.channels(res // 2) if res > 4 else 0, self.channels(res), w_dim,
                                         res, img_channels, img_resolution, conv_clamp=conv_clamp,
                                         use_noise=use_noise)
            for res in self.block_resolutions})
        self._pose_and_mapping(self.pyramid_num_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = StyleEncoderNetworkV10(style_input_nc, output_nc=512)
        self.set_dtype(dtype)

    def forward(self, z, c, retain, pose, denorm_input, truncation_psi=1.0, truncation_cutoff=None, w_avg=None,
                noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats, denorm_feats = self.style_encoding(nchw(c), nchw(retain), nchw(denorm_input))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        cat_feats, spade_feats = cat_feats_dict(feats), cat_feats_dict(denorm_feats)
        block_ws, _ = self.split_ws(self.pyramid, ws)
        x = img = None
        for block, cur_ws in zip(self.pyramid, block_ws):
            x, img = block(x, img, cur_ws, pose_feat, cat_feats, spade_feats, noise_mode, generator)
        return nhwc(img)
