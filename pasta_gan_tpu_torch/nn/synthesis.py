"""Synthesis pyramid of the Full generator (counterpart of `pasta_gan_tpu/nn/synthesis.py`).

Wiring kept from the JAX package (and the reference it follows):
* the first (4x4) block takes the pose feature map instead of a learned
  const; the `const` parameter exists for checkpoint compatibility only;
* blocks above 16x16 concatenate the 64-channel retain features of their
  resolution and merge them with a 1x1 conv;
* each block reads num_conv + num_torgb ws but the index advances by num_conv
  (the skip ToRGB shares the next block's first w); the texture head reuses
  the last block's ws;
* SPADE refinement at the second-to-last resolution, fed by features of the
  denormalized garments, then the texture finetune block.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.modulated_conv2d import modulated_conv2d
from ..ops.upfirdn2d import upsample2d
from .layers import Conv2dLayer, FullyConnectedLayer, Layer, ResBlock, _filter_buffer, _normal_
from .spade import SpadeResBlock


class SynthesisLayer(Layer):
    """Modulated conv + optional per-pixel noise + bias_act."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3, up=1,
                 use_noise=True, activation="lrelu", resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.resolution, self.kernel_size, self.up = resolution, kernel_size, up
        self.use_noise, self.activation, self.conv_clamp = use_noise, activation, conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.noise_strength = nn.Parameter(torch.zeros(())) if use_noise else None
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _filter_buffer(self, resample_filter)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()
            if self.noise_strength is not None:
                self.noise_strength.zero_()

    def forward(self, x, w, noise_mode: str = "random", gain: float = 1.0,
                generator: Optional[torch.Generator] = None):
        if noise_mode not in ("random", "none"):
            raise ValueError(f"noise_mode must be 'random' or 'none', got {noise_mode!r}")
        dt = self.compute_dtype
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            shape = (x.shape[0], 1, self.resolution, self.resolution)
            noise = torch.randn(shape, generator=generator, device=x.device, dtype=dt)
            noise = noise * self.noise_strength.to(dt)
        x = modulated_conv2d(
            x.to(dt), self.weight.to(dt), styles, noise=noise, up=self.up,
            padding=self.kernel_size // 2,
            resample_filter=self.resample_filter if self.up > 1 else None,
            flip_weight=(self.up == 1),
        )
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayerFull(Layer):
    """1x1 modulated conv without demodulation, plus the 6-class parsing head
    on the last style block; both heads run as one conv over concatenated
    output channels."""

    def __init__(self, in_channels, out_channels, w_dim, conv_clamp=None, with_parsing=False,
                 num_parsing_classes=6):
        super().__init__()
        self.in_channels, self.out_channels, self.conv_clamp = in_channels, out_channels, conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.with_parsing = with_parsing
        if with_parsing:
            self.m_weight1 = nn.Parameter(torch.empty(num_parsing_classes, in_channels, 1, 1))
            self.m_bias1 = nn.Parameter(torch.zeros(num_parsing_classes))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()
        if self.with_parsing:
            _normal_(self.m_weight1, generator)
            with torch.no_grad():
                self.m_bias1.zero_()

    def forward(self, x, w):
        dt = self.compute_dtype
        styles = self.affine(w) * (1.0 / math.sqrt(self.in_channels))
        weight = torch.cat([self.weight, self.m_weight1], 0) if self.with_parsing else self.weight
        y = modulated_conv2d(x.to(dt), weight.to(dt), styles, demodulate=False)
        img = bias_act(y[:, : self.out_channels], self.bias, clamp=self.conv_clamp)
        aux = None
        if self.with_parsing:
            aux = bias_act(y[:, self.out_channels :], self.m_bias1, clamp=self.conv_clamp)
        return img, aux


class SynthesisBlockFull(Layer):
    """Two synthesis layers + skip ToRGB + retain-feature merge."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, is_last,
                 is_style=False, merge_min_res=16, cat_channels=64, resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, use_noise=True):
        super().__init__()
        self.in_channels, self.resolution, self.merge_min_res = in_channels, resolution, merge_min_res
        common = dict(w_dim=w_dim, resolution=resolution, resample_filter=resample_filter,
                      conv_clamp=conv_clamp, use_noise=use_noise)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **common)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        if in_channels != 0 and resolution > merge_min_res:
            self.merge_conv = Conv2dLayer(out_channels + cat_channels, out_channels, 1,
                                          resample_filter=resample_filter)
        self.torgb = ToRGBLayerFull(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                    with_parsing=is_last and is_style)
        _filter_buffer(self, resample_filter)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.in_channels == 0:
            _normal_(self.const, generator)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    num_torgb = 1  # skip architecture: every block has a ToRGB

    def forward(self, x, img, ws, pose_feature, cat_feat: Dict[str, torch.Tensor],
                noise_mode: str = "random", generator=None):
        dt = self.conv1.compute_dtype
        if self.in_channels == 0:
            x = self.conv1(pose_feature.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            w_idx = 1
        else:
            x = self.conv0(x.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, generator=generator)
            w_idx = 2
            if self.resolution > self.merge_min_res:
                x = self.merge_conv(torch.cat([x, cat_feat[str(self.resolution)].to(dt)], dim=1))
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y, pred_parsing = self.torgb(x, ws[:, w_idx])
        y = y.float()
        img = img + y if img is not None else y
        return x, img, pred_parsing


class SynthesisNetworkFull(nn.Module):
    """Skip pyramid 4 -> img_resolution + SPADE refinement + texture finetune head."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512,
                 conv_clamp=None, use_noise=True, merge_min_res=16):
        super().__init__()
        self.w_dim, self.img_resolution = w_dim, img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        common = dict(w_dim=w_dim, img_channels=img_channels, merge_min_res=merge_min_res,
                      conv_clamp=conv_clamp, use_noise=use_noise)
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockFull(
                self.channels(res // 2) if res > 4 else 0, self.channels(res), resolution=res,
                is_last=res == img_resolution, is_style=True, **common))
        ch = self.channels(self.block_resolutions[-2])
        for i in (1, 2, 3):
            setattr(self, f"spade_b128_{i}", SpadeResBlock(ch, ch, resolution=128, feat_multiplier=2))
        res = self.block_resolutions[-1]
        self.texture_b256 = SynthesisBlockFull(
            self.channels(res // 2), self.channels(res), resolution=res, is_last=True,
            is_style=False, **common)
        ngf = 64
        self.spade_encoder = nn.Sequential(
            Conv2dLayer(3, ngf, 7, activation="relu"),
            ResBlock(ngf, ngf, activation="relu"),
            ResBlock(ngf, ngf * 2, activation="relu", down=2),
        )

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def blocks(self):
        return [getattr(self, f"b{res}") for res in self.block_resolutions]

    @property
    def num_ws(self) -> int:
        return sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1

    def get_spade_feat(self, mask, denorm_mask, denorm_input):
        """Fill person-visible-but-garment-missing regions with the average of
        the valid denorm features (per sample).  NCHW."""
        mask = (mask > 0.9).to(denorm_input.dtype)
        mask_128 = (mask[:, :, ::2, ::2] > 0.9).to(mask.dtype)
        denorm_mask_128 = (denorm_mask[:, :, ::2, ::2] > 0.9).to(mask.dtype)
        valid_mask = ((mask_128 + denorm_mask_128) == 2.0).to(mask.dtype)
        res_mask = mask_128 - valid_mask
        feat = self.spade_encoder(denorm_input * mask - (1.0 - mask))
        valid_feat_sum = (feat * valid_mask).sum(dim=(2, 3), keepdim=True)
        valid_mask_sum = valid_mask.sum(dim=(2, 3), keepdim=True)
        valid_index = (valid_mask_sum > 10).to(mask.dtype)
        feat_hw = feat.shape[2] * feat.shape[3]
        valid_mask_sum = valid_mask_sum * valid_index + feat_hw * (1.0 - valid_index)
        avg_feat = valid_feat_sum / valid_mask_sum
        return feat * (1.0 - res_mask) + avg_feat * res_mask

    def forward(self, ws, pose_feat, cat_feat, denorm_upper_input, denorm_lower_input,
                denorm_upper_mask, denorm_lower_mask, noise_mode="random", generator=None):
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} entries, expected {self.num_ws}")
        block_ws = []
        w_idx = 0
        for block in self.blocks:
            block_ws.append(ws[:, w_idx : w_idx + block.num_conv + block.num_torgb])
            w_idx += block.num_conv

        x = img = aux = x_128 = img_128 = None
        for res, block, cur_ws in zip(self.block_resolutions, self.blocks, block_ws):
            x, img, aux = block(x, img, cur_ws, pose_feat, cat_feat, noise_mode, generator)
            if res == self.block_resolutions[-2]:
                x_128, img_128 = x, img

        parsing_idx = aux.detach().argmax(dim=1, keepdim=True)
        upper_mask = (parsing_idx == 1).float()
        lower_mask = (parsing_idx == 2).float()
        N = denorm_upper_input.shape[0]
        spade_both = self.get_spade_feat(
            torch.cat([upper_mask, lower_mask]),
            torch.cat([denorm_upper_mask, denorm_lower_mask]),
            torch.cat([denorm_upper_input, denorm_lower_input]),
        )
        spade_feat = torch.cat([spade_both[:N], spade_both[N:]], dim=1)
        h = self.spade_b128_1(x_128, spade_feat)
        h = self.spade_b128_2(h, spade_feat)
        h = self.spade_b128_3(h, spade_feat)
        _, finetune_img, _ = self.texture_b256(h, img_128, block_ws[-1], pose_feat, cat_feat,
                                               noise_mode, generator)
        return img, finetune_img, aux
