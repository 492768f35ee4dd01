"""GeneratorV13 / GeneratorV14, the mask-at-128 and attention-at-128
clusters (counterpart of `pasta_gan_tpu/models/generator_v13.py`), built on
the V11 blocks:

* V13: at 128 the plain block runs on a fork of the stream only to predict
  the blending mask (`mask_128`); an attention-equipped spade block, gated by
  that mask, replaces it on the main stream.  Returns (img, mask_128).
* V14: the pyramid runs plain to the end (the mask from the last ToRGB); a
  finetune branch runs from the 64x64 output through `spade_b128` (with
  attention) and `spade_b256` on the last two blocks' ws.  Returns (img,
  finetune_img, mask).

Their style encoders tap the denorm encoder after every residual block (V13:
2 NGF at /2 and 4 NGF at /4; V14 adds a same-resolution first block, NGF at
/1).  NHWC in and out.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.encoders import StyleEncoderNetworkV16
from .generator_full import nhwc
from .generator_v10 import NGF, spade_pyramid, tapped
from .generator_v11 import SynthesisBlockV11, _GeneratorV11Base


class StyleEncoderNetworkV13(StyleEncoderNetworkV16):
    """StyleEncoderNetworkV16's branches plus the denorm encoder: ResBlocks
    NGF -> 2 NGF -> 4 NGF, each halving, (V14) after a same-resolution
    NGF -> NGF block, each tapped."""

    def __init__(self, input_nc, output_nc=512, v14=False):
        super().__init__(input_nc, output_nc=output_nc, ngf=NGF, extra_convs=3)
        stages = ((1, 1, 1),) * v14 + ((1, 2, 2), (2, 4, 2))  # (in, out, down) in multiples of NGF
        self.taps = tuple(range(1, len(stages) + 1))
        self.spade_encoder = spade_pyramid(stages)

    def forward(self, x, const_input, denorm_input):
        style, feats = super().forward(x, const_input)
        return style, feats, tapped(self.spade_encoder, denorm_input, self.taps)


class _GeneratorV1314Base(_GeneratorV11Base):
    """The V11 pyramid with the attention spade block at 128 (`spade_b128`)
    and, for V14, a spade block at 256 (`spade_b256`)."""

    v14 = False

    def _spade_blocks(self, common):
        blocks = {"spade_b128": SynthesisBlockV11(self.channels(64), self.channels(128), resolution=128,
                                                  is_spade_block=True, use_atten=True, **common)}
        if self.v14:
            blocks["spade_b256"] = SynthesisBlockV11(self.channels(128), self.channels(256), resolution=256,
                                                     is_spade_block=True, **common)
        return blocks

    def _style_encoder(self, style_input_nc):
        return StyleEncoderNetworkV13(style_input_nc, output_nc=512, v14=self.v14)


class GeneratorV13(_GeneratorV1314Base):
    """forward(z, c, retain, pose, denorm_input) -> (img, mask_128), NHWC."""

    def forward(self, z, c, retain, pose, denorm_input, truncation_psi=1.0, truncation_cutoff=None, w_avg=None,
                noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat, cat_feats, spade_feats, ws = self._encode(z, c, retain, pose, denorm_input, w_avg,
                                                             truncation_psi, truncation_cutoff)
        block_ws, _ = self.split_ws(self.pyramid, ws)
        x = img = mask_128 = None
        kw = dict(noise_mode=noise_mode, generator=generator)
        for block, cur_ws in zip(self.pyramid, block_ws):
            if block.resolution != 128:
                x, img, _ = block(x, img, cur_ws, pose_feat, cat_feats, **kw)
            else:  # the plain block predicts the mask; the spade block replaces it on the stream
                _, _, mask_128 = block(x, img, cur_ws, pose_feat, cat_feats, **kw)
                x, img, _ = self.synthesis["spade_b128"](x, img, cur_ws, pose_feat, cat_feats, spade_feats,
                                                         spade_mask=mask_128, **kw)
        return nhwc(img), nhwc(mask_128)


class GeneratorV14(_GeneratorV1314Base):
    """forward(z, c, retain, pose, denorm_input) -> (img, finetune_img, mask), NHWC."""

    v14 = True

    def forward(self, z, c, retain, pose, denorm_input, truncation_psi=1.0, truncation_cutoff=None, w_avg=None,
                noise_mode="random", generator: Optional[torch.Generator] = None):
        pose_feat, cat_feats, spade_feats, ws = self._encode(z, c, retain, pose, denorm_input, w_avg,
                                                             truncation_psi, truncation_cutoff)
        block_ws, _ = self.split_ws(self.pyramid, ws)
        x = img = mask = x_64 = img_64 = None
        kw = dict(noise_mode=noise_mode, generator=generator)
        for block, cur_ws in zip(self.pyramid, block_ws):
            x, img, mask = block(x, img, cur_ws, pose_feat, cat_feats, **kw)
            if block.resolution == 64:
                x_64, img_64 = x, img
        ft_x, ft_img, _ = self.synthesis["spade_b128"](x_64, img_64, block_ws[-2], pose_feat, cat_feats, spade_feats,
                                                       spade_mask=mask[:, :, ::2, ::2], **kw)
        _, finetune_img, _ = self.synthesis["spade_b256"](ft_x, ft_img, block_ws[-1], pose_feat, cat_feats,
                                                          spade_feats, spade_mask=mask, **kw)
        return nhwc(img), nhwc(finetune_img), nhwc(mask)
