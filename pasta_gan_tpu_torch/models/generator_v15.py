"""GeneratorV15 / GeneratorV15_2 / GeneratorV17, the SPADE-placement
clusters (counterpart of `pasta_gan_tpu/models/generator_v15.py`).

All three share a skip pyramid whose every ToRGB carries a sigmoid clothes
mask (`SynthesisBlockFull` with head "mask1" on every block) and a texture
finetune branch from the second-to-last block's output; they differ in where
the SPADE conditioning sits:

* V15: the spade features come from the style encoder's denorm branch
  (StyleEncoderNetworkV11); one SpadeResBlock at the second-to-last
  resolution (`spade_b128`) before `texture_b256`.
* V15_2: the same with three chained SpadeResBlocks (`spade_b128_{1,2,3}`).
* V17: the denorm encoder sits in the synthesis network
  (`synthesis.spade_encoder.N`, over the mask-gated garment), and the SPADE
  blocks sit inside the texture block (`TextureBlockV17`): at half the
  resolution before conv0 and at the full one before conv1.

Each returns (img, finetune_img, mask), NHWC, with the valid-region average
fill of the spade features (`_masked_avg_fill`).

`_GeneratorV15Base` also carries the ablation clusters
(models/generator_ablations.py): `head="masks2"` gives them the V18 pyramid,
upper and lower mask heads on the last block only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.encoders import StyleEncoderNetworkV16
from ..nn.layers import Conv2dLayer, _filter_buffer
from ..nn.spade import SpadeResBlock
from ..nn.synthesis import SynthesisBlockFull, SynthesisLayer, ToRGBLayerFull
from ..ops.upfirdn2d import upsample2d
from .generator_full import cat_feats_dict, nchw, nhwc
from .generator_v10 import NGF, ZooGenerator, spade_pyramid, tapped
from .generator_v11 import StyleEncoderNetworkV11


def _thresh(m, dtype):
    """The mask thresholded at 0.9, detached."""
    return (m > 0.9).to(dtype).detach()


def _masked_avg_fill(denorm_feat, mask, denorm_mask, hw: int, pre_mask: bool):
    """Person-visible but garment-missing pixels (mask and not denorm_mask)
    take the spatial average of the valid features (both masks), per sample;
    with 10 valid pixels or fewer the sum is divided by hw * hw instead.  V15
    multiplies the features by the mask first (`pre_mask`), V17 does not."""
    dtype = denorm_feat.dtype
    valid = ((mask + denorm_mask) == 2.0).to(dtype)
    res_mask = (mask - valid).detach()
    valid_feat_sum = (denorm_feat * valid).sum(dim=(2, 3), keepdim=True)
    valid_sum = valid.sum(dim=(2, 3), keepdim=True)
    idx = (valid_sum > 10).to(dtype)
    valid_sum = valid_sum * idx + float(hw * hw) * (1.0 - idx)
    avg = valid_feat_sum / valid_sum
    base = denorm_feat * mask if pre_mask else denorm_feat
    return base * (1.0 - res_mask) + avg * res_mask


class _SpadeEncoder(nn.Sequential):
    """The synthesis network's denorm encoder (`spade_encoder.N`): a 7x7 relu
    conv and two relu ResBlocks (NGF, then 2 NGF at half the resolution),
    tapped after each ResBlock; returns {"256": full, "128": half} (the
    reference's keys, whatever the resolution)."""

    def __init__(self):
        super().__init__(*spade_pyramid(((1, 1, 1), (1, 2, 2))))

    def forward(self, x):
        f256, f128 = tapped(self, x, (1, 2))
        return {"256": f256, "128": f128}


class TextureBlockV17(nn.Module):
    """V17's texture block: a last synthesis block whose convs follow SPADE
    residual blocks at half resolution (`spade_b128`, before conv0) and full
    resolution (`spade_b256`, before conv1), each fed the valid-region fill of
    the denorm features at its resolution; its ToRGB carries the clothes mask
    head."""

    num_conv, num_torgb = 2, 1

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, conv_clamp=None, use_noise=True):
        super().__init__()
        self.resolution = resolution
        common = dict(w_dim=w_dim, resolution=resolution, conv_clamp=conv_clamp, use_noise=use_noise)
        h = resolution // 2
        self.spade_b128 = SpadeResBlock(in_channels, in_channels, resolution=h, feat_multiplier=1)
        self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **common)
        self.spade_b256 = SpadeResBlock(out_channels, out_channels, resolution=resolution, feat_multiplier=1)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        if resolution > 16:
            self.merge_conv = Conv2dLayer(out_channels + NGF, out_channels, 1)
        self.torgb = ToRGBLayerFull(out_channels, img_channels, w_dim, conv_clamp=conv_clamp, head="mask1")
        _filter_buffer(self, (1, 3, 3, 1))

    def forward(self, x, img, ws, cat_feat, mask_256, denorm_mask, denorm_feats, noise_mode="random",
                generator=None):
        dt = self.conv1.compute_dtype
        r, h = self.resolution, self.resolution // 2
        mask_128 = _thresh(mask_256[:, :, ::2, ::2], dt)
        denorm_mask_128 = _thresh(denorm_mask[:, :, ::2, ::2], dt)
        x = self.spade_b128(x, _masked_avg_fill(denorm_feats[str(h)], mask_128, denorm_mask_128, h, pre_mask=False))
        x = self.conv0(x.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
        x = self.spade_b256(x, _masked_avg_fill(denorm_feats[str(r)], mask_256, denorm_mask, r, pre_mask=False))
        x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, generator=generator)
        if r > 16:
            x = self.merge_conv(torch.cat([x, cat_feat[str(r)].to(dt)], dim=1))
        img = upsample2d(img, self.resample_filter)
        y, mask = self.torgb(x, ws[:, 2])
        return x, img + y.float(), mask


class _GeneratorV15Base(ZooGenerator):
    """The mask-headed pyramid (`synthesis.b{res}`), the pose encoder and the
    mapping.  `head="mask1"`: a clothes mask head on every block; "masks2":
    upper and lower mask heads on the last block only (the ablations)."""

    head = "mask1"

    def _make_blocks(self) -> None:
        """`self.synthesis`, holding the pyramid."""
        always = self.head == "mask1"
        self.synthesis = nn.ModuleDict({
            f"b{res}": SynthesisBlockFull(
                self.channels(res // 2) if res > 4 else 0, self.channels(res), self.w_dim, resolution=res,
                img_channels=self.img_channels, is_last=res == self.img_resolution,
                is_style=res == self.img_resolution and not always, conv_clamp=self.conv_clamp,
                use_noise=self.use_noise, head=self.head, head_always=always)
            for res in self.block_resolutions})

    def _texture_block(self, head="mask1", is_style=False):
        res = self.img_resolution
        return SynthesisBlockFull(self.channels(res // 2), self.channels(res), self.w_dim, resolution=res,
                                  img_channels=self.img_channels, is_last=True, is_style=is_style,
                                  conv_clamp=self.conv_clamp, use_noise=self.use_noise, head=head,
                                  head_always=head == "mask1")

    def _pyramid(self, ws, pose_feat, cat_feats, noise_mode, generator):
        """-> (img, mask, x_128, img_128, block_ws): the last block's head
        output and the second-to-last block's output."""
        block_ws, _ = self.split_ws(self.pyramid, ws)
        x = img = mask = x_128 = img_128 = None
        for block, cur_ws in zip(self.pyramid, block_ws):
            x, img, mask = block(x, img, cur_ws, pose_feat, cat_feats, noise_mode, generator)
            if block.resolution == self.img_resolution // 2:
                x_128, img_128 = x, img
        return img, mask, x_128, img_128, block_ws


class GeneratorV15(_GeneratorV15Base):
    """forward(z, c, retain, pose, denorm_input, denorm_mask) -> (img,
    finetune_img, mask), NHWC.  One SpadeResBlock (`spade_b128`)."""

    spade_count = 1

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        self._make_blocks()
        self._pose_and_mapping(self.pyramid_num_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = StyleEncoderNetworkV11(style_input_nc, output_nc=512)
        ch = self.channels(img_resolution // 2)
        names = ["spade_b128"] if self.spade_count == 1 else [f"spade_b128_{i + 1}" for i in range(self.spade_count)]
        for name in names:
            self.synthesis[name] = SpadeResBlock(ch, ch, resolution=128, feat_multiplier=1)
        self.spade_names = names
        self.synthesis["texture_b256"] = self._texture_block()
        self.set_dtype(dtype)

    def forward(self, z, c, retain, pose, denorm_input, denorm_mask, truncation_psi=1.0, truncation_cutoff=None,
                w_avg=None, noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats, denorm_feats = self.style_encoding(nchw(c), nchw(retain), nchw(denorm_input))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        cat_feats, spade_feats = cat_feats_dict(feats), cat_feats_dict(denorm_feats)
        img, mask, x_128, img_128, block_ws = self._pyramid(ws, pose_feat, cat_feats, noise_mode, generator)
        dt = self.dtype
        mask_256 = _thresh(mask, dt)
        mask_128 = _thresh(mask_256[:, :, ::2, ::2], dt)
        denorm_mask_128 = _thresh(nchw(denorm_mask)[:, :, ::2, ::2], dt)
        h = self.img_resolution // 2
        spade_feat = _masked_avg_fill(spade_feats[str(h)], mask_128, denorm_mask_128, h, pre_mask=True)
        xs = x_128
        for name in self.spade_names:
            xs = self.synthesis[name](xs, spade_feat)
        _, finetune_img, _ = self.synthesis["texture_b256"](xs, img_128, block_ws[-1], pose_feat, cat_feats,
                                                            noise_mode, generator)
        return nhwc(img), nhwc(finetune_img), nhwc(mask)


class GeneratorV15_2(GeneratorV15):
    """V15 with three chained SpadeResBlocks (`spade_b128_{1,2,3}`): the
    network the reference's GeneratorV15 builds."""

    spade_count = 3


class GeneratorV17(_GeneratorV15Base):
    """forward(z, c, retain, pose, denorm_input, denorm_mask) -> (img,
    finetune_img, mask), NHWC."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        self._make_blocks()
        self._pose_and_mapping(self.pyramid_num_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = StyleEncoderNetworkV16(style_input_nc, output_nc=512, ngf=NGF, extra_convs=3)
        self.synthesis["spade_encoder"] = _SpadeEncoder()
        res = img_resolution
        self.synthesis["texture_b256"] = TextureBlockV17(self.channels(res // 2), self.channels(res), w_dim, res,
                                                         img_channels, conv_clamp=conv_clamp, use_noise=use_noise)
        self.set_dtype(dtype)

    def forward(self, z, c, retain, pose, denorm_input, denorm_mask, truncation_psi=1.0, truncation_cutoff=None,
                w_avg=None, noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats = self.style_encoding(nchw(c), nchw(retain))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        cat_feats = cat_feats_dict(feats)
        img, mask, x_128, img_128, block_ws = self._pyramid(ws, pose_feat, cat_feats, noise_mode, generator)
        mask_256 = _thresh(mask, self.dtype)
        denorm_input = nchw(denorm_input)
        denorm_feats = self.synthesis["spade_encoder"](denorm_input * mask_256 - (1.0 - mask_256))
        # denorm_mask goes in raw: the block thresholds its half-resolution copy only
        _, finetune_img, _ = self.synthesis["texture_b256"](x_128, img_128, block_ws[-1], cat_feats, mask_256,
                                                            nchw(denorm_mask), denorm_feats, noise_mode, generator)
        return nhwc(img), nhwc(finetune_img), nhwc(mask)
