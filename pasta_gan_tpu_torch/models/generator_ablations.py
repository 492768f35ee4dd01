"""The ablation clusters of the paper (counterpart of
`pasta_gan_tpu/models/generator_ablations.py`), each stripping or replacing
a part of the full model:

* GeneratorRaw / GeneratorPatch: the clothes-mask pyramid of V15 and no
  refinement branch; (img, img, img).  Raw feeds the garment image to a
  conv-only style encoder (`StyleEncoderNetworkRaw`), Patch the routed patch
  stack to StyleEncoderNetworkV16.
* GeneratorPatchDenorm / GeneratorPatchDenormCat: the pyramid, three
  refinement blocks at the second-to-last resolution and a texture block;
  (img, finetune_img, mask).  Denorm conditions SpadeResBlocks on the spade
  encoding of the raw denorm garment; Cat replaces SPADE by concatenating
  residual blocks (`CatResBlock`) fed the mask-gated features kept where
  both masks agree.
* GeneratorRawFull / GeneratorPatchFull / GeneratorAvgPatchFull: the V18
  pyramid (upper and lower mask heads on the last block), no refinement;
  (img,) * 4.  They differ only in the style encoder (conv-only over 9
  channels, V16 over 60 or over 78).
* GeneratorNoCoarse / GeneratorNoCoarseNoMask: the V18 pyramid whose coarse
  image is dropped: three SpadeResBlocks over the upper and lower spade
  features, then a V18 texture block; (finetune_img,) * 4.  NoMask skips the
  mask gating and the valid-region fill.

NHWC in and out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.encoders import RetainFeatureEncoder, StyleEncoderNetworkV16
from ..nn.layers import Conv2dLayer, FullyConnectedLayer
from ..nn.spade import SpadeResBlock
from .generator_full import cat_feats_dict, nchw, nhwc
from .generator_v10 import NGF
from .generator_v15 import _GeneratorV15Base, _masked_avg_fill, _SpadeEncoder, _thresh


class StyleEncoderNetworkRaw(nn.Module):
    """Conv-only style encoder: a 1x1 stem and six stride-2 3x3 convs
    (`model.N`, no DenseNorm), a global average pool and `fc`, beside the
    retain branch `feat_enc`.  Returns (style, retain features)."""

    def __init__(self, input_nc, output_nc=512, ngf=NGF):
        super().__init__()
        self.feat_enc = RetainFeatureEncoder(ngf)
        mult_ins, mult_outs = [1, 2, 4, 8, 8, 8], [2, 4, 8, 8, 8, 8]
        self.model = nn.Sequential(Conv2dLayer(input_nc, ngf, 1),
                                   *[Conv2dLayer(ngf * i, ngf * o, 3, down=2) for i, o in zip(mult_ins, mult_outs)])
        self.fc = FullyConnectedLayer(output_nc, output_nc)

    def forward(self, x, const_input):
        feats = self.feat_enc(const_input)
        return self.fc(self.model(x).mean(dim=(2, 3))), feats


class CatResBlock(nn.Module):
    """A residual block conditioned by concatenation: the denorm features
    join x at the entry conv; every conv linear, the skip and conv1 at gain
    sqrt(0.5)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = Conv2dLayer(in_channels * 2, in_channels, 3)
        self.skip = Conv2dLayer(in_channels, out_channels, 1)
        self.conv0 = Conv2dLayer(in_channels, out_channels, 3)
        self.conv1 = Conv2dLayer(out_channels, out_channels, 3)

    def forward(self, x, denorm_feat):
        g = math.sqrt(0.5)
        x = self.conv(torch.cat([x, denorm_feat.to(x.dtype)], dim=1))
        y = self.skip(x, gain=g)
        return y + self.conv1(self.conv0(x), gain=g)


class _AblationBase(_GeneratorV15Base):
    """The pyramid, the pose encoder and the mapping, and the style encoder
    (`raw_encoder`: StyleEncoderNetworkRaw, else StyleEncoderNetworkV16)."""

    raw_encoder = False
    style_input_nc = 24 * 2

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=16384, channel_max=512, conv_clamp=256.0, use_noise=True, style_input_nc=None,
                 dtype=torch.float32):
        style_input_nc = self.style_input_nc if style_input_nc is None else style_input_nc
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_layers, channel_base,
                         channel_max, conv_clamp, use_noise, style_input_nc)
        self._make_blocks()
        self._pose_and_mapping(self.pyramid_num_ws, z_dim, c_dim, mapping_layers)
        self.style_encoding = (StyleEncoderNetworkRaw(style_input_nc) if self.raw_encoder else
                               StyleEncoderNetworkV16(style_input_nc, output_nc=512, ngf=NGF, extra_convs=3))
        self._refinement()
        self.set_dtype(dtype)

    def _refinement(self) -> None:
        """Add the refinement branch's modules to `self.synthesis`."""

    def _common(self, z, c, retain, pose, truncation_psi, truncation_cutoff, w_avg, noise_mode, generator):
        """-> (img, mask, x_128, img_128, block_ws, pose feature, retain features)."""
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats = self.style_encoding(nchw(c), nchw(retain))
        ws = self._ws(z, stylecode, w_avg, truncation_psi, truncation_cutoff)
        cat_feats = cat_feats_dict(feats)
        return self._pyramid(ws, pose_feat, cat_feats, noise_mode, generator) + (pose_feat, cat_feats)


class GeneratorRaw(_AblationBase):
    """forward(z, c, retain, pose) -> (img, img, img), NHWC; c is the raw
    garment stack (6 channels)."""

    raw_encoder = True
    style_input_nc = 3 * 2

    def forward(self, z, c, retain, pose, denorm_clothes=None, denorm_mask=None, truncation_psi=1.0,
                truncation_cutoff=None, w_avg=None, noise_mode="random", generator: Optional[torch.Generator] = None):
        img = nhwc(self._common(z, c, retain, pose, truncation_psi, truncation_cutoff, w_avg, noise_mode,
                                generator)[0])
        return img, img, img


class GeneratorPatch(GeneratorRaw):
    """GeneratorRaw with the routed patch stack (48 channels) and StyleEncoderNetworkV16."""

    raw_encoder = False
    style_input_nc = 24 * 2


class GeneratorRawFull(_AblationBase):
    """forward(z, c, retain, pose) -> (img,) * 4, NHWC: the V18 pyramid, the
    raw 9-channel garment stack."""

    head = "masks2"
    raw_encoder = True
    style_input_nc = 3 * 3

    def forward(self, z, c, retain, pose, denorm_upper_input=None, denorm_lower_input=None, denorm_upper_mask=None,
                denorm_lower_mask=None, truncation_psi=1.0, truncation_cutoff=None, w_avg=None, noise_mode="random",
                generator: Optional[torch.Generator] = None):
        img = nhwc(self._common(z, c, retain, pose, truncation_psi, truncation_cutoff, w_avg, noise_mode,
                                generator)[0])
        return img, img, img, img


class GeneratorPatchFull(GeneratorRawFull):
    """GeneratorRawFull with a 60-channel patch stack and StyleEncoderNetworkV16."""

    raw_encoder = False
    style_input_nc = 30 * 2


class GeneratorAvgPatchFull(GeneratorRawFull):
    """GeneratorPatchFull over a 78-channel average-pooled patch stack (the
    averaging happens in the data; the network differs by its input width)."""

    raw_encoder = False
    style_input_nc = 39 * 2


class GeneratorPatchDenorm(_AblationBase):
    """forward(z, c, retain, pose, denorm_clothes, denorm_mask) -> (img,
    finetune_img, mask), NHWC: three SpadeResBlocks (`spade_b128_{1,2,3}`) on
    the spade encoding of the raw denorm garment, no gating."""

    cat_refine = False

    def _refinement(self):
        self.synthesis["spade_encoder"] = _SpadeEncoder()
        ch = self.channels(self.img_resolution // 2)
        prefix = "catRes_b128" if self.cat_refine else "spade_b128"
        self.refine_names = [f"{prefix}_{i + 1}" for i in range(3)]
        for name in self.refine_names:
            self.synthesis[name] = (CatResBlock(ch, ch) if self.cat_refine else
                                    SpadeResBlock(ch, ch, resolution=128, feat_multiplier=1))
        self.synthesis["texture_b256"] = self._texture_block()

    def forward(self, z, c, retain, pose, denorm_clothes, denorm_mask, truncation_psi=1.0, truncation_cutoff=None,
                w_avg=None, noise_mode="random", generator: Optional[torch.Generator] = None):
        img, mask, x_128, img_128, block_ws, pose_feat, cat_feats = self._common(
            z, c, retain, pose, truncation_psi, truncation_cutoff, w_avg, noise_mode, generator)
        denorm_clothes = nchw(denorm_clothes)
        if self.cat_refine:
            # the mask-gated garment's features, kept where the predicted and the denorm masks agree
            dt = self.dtype
            mask_256 = _thresh(mask, dt)
            feat_128 = self.synthesis["spade_encoder"](denorm_clothes * mask_256 - (1.0 - mask_256))["128"]
            mask_128 = _thresh(mask_256[:, :, ::2, ::2], dt)
            dm_128 = _thresh(nchw(denorm_mask)[:, :, ::2, ::2], dt)
            spade_feat = feat_128 * ((mask_128 + dm_128) == 2.0).to(dt)
        else:
            spade_feat = self.synthesis["spade_encoder"](denorm_clothes)["128"]
        h = x_128
        for name in self.refine_names:
            h = self.synthesis[name](h, spade_feat)
        _, finetune_img, _ = self.synthesis["texture_b256"](h, img_128, block_ws[-1], pose_feat, cat_feats,
                                                            noise_mode, generator)
        return nhwc(img), nhwc(finetune_img), nhwc(mask)


class GeneratorPatchDenormCat(GeneratorPatchDenorm):
    """GeneratorPatchDenorm with concatenating refinement blocks
    (`catRes_b128_{1,2,3}`) over the gated, agreed features."""

    cat_refine = True


class GeneratorNoCoarse(_AblationBase):
    """forward(z, c, retain, pose, denorm_upper_input, denorm_lower_input,
    denorm_upper_mask, denorm_lower_mask) -> (finetune_img,) * 4, NHWC."""

    head = "masks2"
    style_input_nc = 30 * 2
    mask_fill = True

    def _refinement(self):
        self.synthesis["spade_encoder"] = _SpadeEncoder()
        ch = self.channels(self.img_resolution // 2)
        for i in (1, 2, 3):
            self.synthesis[f"spade_b128_{i}"] = SpadeResBlock(ch, ch, resolution=128, feat_multiplier=2)
        self.synthesis["texture_b256"] = self._texture_block("masks2", is_style=True)

    def _spade_feat(self, mask, denorm_mask, denorm_input):
        """One garment's spade features: the mask-gated garment's, with the
        valid-region fill (NoMask: the raw garment's)."""
        encode = self.synthesis["spade_encoder"]
        if not self.mask_fill:
            return encode(denorm_input)["128"]
        dt = self.dtype
        mask_256 = (mask > 0.9).to(dt)
        mask_128 = _thresh(mask_256[:, :, ::2, ::2], dt)
        dm_128 = _thresh(denorm_mask[:, :, ::2, ::2], dt)
        feat = encode(denorm_input * mask_256 - (1.0 - mask_256))["128"]
        return _masked_avg_fill(feat, mask_128, dm_128, 128, pre_mask=False)

    def forward(self, z, c, retain, pose, denorm_upper_input, denorm_lower_input, denorm_upper_mask,
                denorm_lower_mask, truncation_psi=1.0, truncation_cutoff=None, w_avg=None, noise_mode="random",
                generator: Optional[torch.Generator] = None):
        _, masks, x_128, img_128, block_ws, pose_feat, cat_feats = self._common(
            z, c, retain, pose, truncation_psi, truncation_cutoff, w_avg, noise_mode, generator)
        upper_mask, lower_mask = masks[0].detach(), masks[1].detach()
        spade_feat = torch.cat([
            self._spade_feat(upper_mask, nchw(denorm_upper_mask), nchw(denorm_upper_input)),
            self._spade_feat(lower_mask, nchw(denorm_lower_mask), nchw(denorm_lower_input)),
        ], dim=1)
        h = x_128
        for i in (1, 2, 3):
            h = self.synthesis[f"spade_b128_{i}"](h, spade_feat)
        _, finetune_img, _ = self.synthesis["texture_b256"](h, img_128, block_ws[-1], pose_feat, cat_feats,
                                                            noise_mode, generator)
        finetune_img = nhwc(finetune_img)
        return finetune_img, finetune_img, finetune_img, finetune_img


class GeneratorNoCoarseNoMask(GeneratorNoCoarse):
    """GeneratorNoCoarse on the raw garments' spade features (no gating, no fill)."""

    mask_fill = False
