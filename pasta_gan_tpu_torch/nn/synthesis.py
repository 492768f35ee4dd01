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

Two variants: "full" (the last style block's ToRGB carries a 6-class parsing
head whose argmax gives the SPADE branch its upper/lower masks) and "v18"
(the released-256 checkpoint: two 1-channel sigmoid mask heads, read
directly, and the texture block builds and discards the same heads so the
parameter shapes match the checkpoint).

`SynthesisNetworkSingle` is the single-garment pyramid of the V15/V16/V20
and V21 clusters: one denorm branch, SPADE blocks at `feat_multiplier=1`, a
sigmoid clothes-mask head on every skip block ("v16") or clothes and hand
mask heads on the last blocks with the hand region of the SPADE features
filled with the average face feature ("v21").

int8 serving (ops/quant.py), as in the JAX package: a `SynthesisLayer`
quantizes its modulated activation at its own site, where
`modulated_conv2d` runs the conv int8 (the stride-1 convs and the up-convs
of inputs of at least 32 rows, with the FIR folded); the retain merge
convs and the SPADE encoder run int8; the SPADE features are quantized once
(`spade_feat_quant`) for the nine `conv_mlp` convs of the three SPADE
blocks; the ToRGB layers and their heads stay float.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.modulated_conv2d import modulated_conv2d
from ..ops.quant import ActScale, QuantMode, is_int8
from ..ops.upfirdn2d import upsample2d
from .layers import Conv2dLayer, FullyConnectedLayer, Layer, ResBlock, _filter_buffer, _normal_
from .spade import SpadeResBlock


class SynthesisLayer(Layer):
    """Modulated conv + optional per-pixel noise + bias_act; `spade_styles`
    ([N, in_channels, H, W]) are averaged with the channel styles
    (`ops/modulated_conv2d.py`), as the spade-modulated layers of the V10-V14
    clusters do."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3, up=1,
                 use_noise=True, activation="lrelu", resample_filter=(1, 3, 3, 1), conv_clamp=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.resolution, self.kernel_size, self.up = resolution, kernel_size, up
        self.use_noise, self.activation, self.conv_clamp = use_noise, activation, conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        # int8: a site where modulated_conv2d runs the conv int8 (stride 1, or the folded up-conv)
        int8_conv = up == 1 or (up == 2 and kernel_size == 3 and resolution // 2 >= 32)
        self.act_scale = ActScale() if int8_conv else None
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.noise_strength = nn.Parameter(torch.zeros(())) if use_noise else None
        self.bias = nn.Parameter(torch.zeros(out_channels))
        _filter_buffer(self, resample_filter)
        if use_noise:
            # the fixed noise map of noise_mode="const" (the training loop's snapshot grids):
            # model state like the reference's buffer, drawn for each layer with its
            # parameters, saved in the state_dict and carried from JAX's "buffers"
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()
            if self.noise_strength is not None:
                self.noise_strength.zero_()
        if self.use_noise:
            _normal_(self.noise_const, generator)

    def forward(self, x, w, noise_mode: str = "random", gain: float = 1.0,
                generator: Optional[torch.Generator] = None, spade_styles: Optional[torch.Tensor] = None):
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be 'random', 'const' or 'none', got {noise_mode!r}")
        dt = self.compute_dtype
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            shape = (x.shape[0], 1, self.resolution, self.resolution)
            noise = torch.randn(shape, generator=generator, device=x.device, dtype=dt)
            noise = noise * self.noise_strength.to(dt)
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength).to(dt)[None, None]
        x = modulated_conv2d(
            x.to(dt), self.weight.to(dt), styles, noise=noise, up=self.up,
            padding=self.kernel_size // 2, spade_styles=spade_styles,
            resample_filter=self.resample_filter if self.up > 1 else None,
            flip_weight=(self.up == 1), quant=self.quant, quant_site=self.act_scale,
        )
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayerFull(Layer):
    """1x1 modulated conv without demodulation, plus an optional head:
    `head="parsing6"`, 6 parsing logits (`m_weight1`); `head="masks2"`, upper
    and lower sigmoid masks (`m_weight1`, `m_weight2`); `head="mask1"`, one
    sigmoid clothes mask (`m_weight`); `head="masks_hand"`, clothes and hand
    sigmoid masks (`m_weight`, `hm_weight`).  All heads run as one conv over
    concatenated output channels; each gets its own bias_act."""

    HEADS = {None: (), "parsing6": (("m_weight1", "m_bias1", 6, "linear"),),
             "masks2": (("m_weight1", "m_bias1", 1, "sigmoid"), ("m_weight2", "m_bias2", 1, "sigmoid")),
             "mask1": (("m_weight", "m_bias", 1, "sigmoid"),),
             "masks_hand": (("m_weight", "m_bias", 1, "sigmoid"), ("hm_weight", "hm_bias", 1, "sigmoid"))}

    def __init__(self, in_channels, out_channels, w_dim, conv_clamp=None, head=None):
        super().__init__()
        if head not in self.HEADS:
            raise ValueError(f"head must be one of {sorted(self.HEADS, key=str)}, got {head!r}")
        self.in_channels, self.out_channels, self.conv_clamp = in_channels, out_channels, conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.heads = self.HEADS[head]
        for name_w, name_b, ch, _ in self.heads:
            setattr(self, name_w, nn.Parameter(torch.empty(ch, in_channels, 1, 1)))
            setattr(self, name_b, nn.Parameter(torch.zeros(ch)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()
        for name_w, name_b, _, _ in self.heads:
            _normal_(getattr(self, name_w), generator)
            with torch.no_grad():
                getattr(self, name_b).zero_()

    def forward(self, x, w):
        """Returns (img, aux): aux is None, the head's output, or the tuple of
        its two masks."""
        dt = self.compute_dtype
        styles = self.affine(w) * (1.0 / math.sqrt(self.in_channels))
        weight = torch.cat([self.weight] + [getattr(self, hw) for hw, _, _, _ in self.heads], 0)
        y = modulated_conv2d(x.to(dt), weight.to(dt), styles, demodulate=False)
        img = bias_act(y[:, : self.out_channels], self.bias, clamp=self.conv_clamp)
        outs, lo = [], self.out_channels
        for _, name_b, ch, act in self.heads:
            outs.append(bias_act(y[:, lo : lo + ch], getattr(self, name_b), act=act, clamp=self.conv_clamp))
            lo += ch
        aux = None if not outs else outs[0] if len(outs) == 1 else tuple(outs)
        return img, aux


class ToRGBLayer(ToRGBLayerFull):
    """The plain ToRGB (reference `networks.py:319-334`): a 1x1 modulated conv
    without demodulation, no head; returns the image alone."""

    def __init__(self, in_channels, out_channels, w_dim, conv_clamp=None):
        super().__init__(in_channels, out_channels, w_dim, conv_clamp=conv_clamp)

    def forward(self, x, w):
        return super().forward(x, w)[0]


class SynthesisBlockFull(Layer):
    """Two synthesis layers + skip ToRGB + retain-feature merge.  The ToRGB
    carries `head` on the last style block, or on every block with
    `head_always`."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, is_last,
                 is_style=False, merge_min_res=16, cat_channels=64, resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, use_noise=True, head="parsing6", head_always=False):
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
                                          resample_filter=resample_filter, quant_site=True)
        self.torgb = ToRGBLayerFull(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                    head=head if (is_last and is_style) or head_always else None)
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


class SynthesisNetworkFull(QuantMode, nn.Module):
    """Skip pyramid start_res -> img_resolution + SPADE refinement + texture finetune head.

    The 512 generator starts its pyramid at 8 (`start_res=8`); its SPADE
    blocks and texture block keep the 256 names (`spade_b128_*` at the
    second-to-last resolution, `texture_b256` at the last), as the reference
    checkpoint does."""

    VARIANTS = {"full": "parsing6", "v18": "masks2"}  # variant -> the last style block's ToRGB head

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512,
                 conv_clamp=None, use_noise=True, merge_min_res=16, variant="full", start_res=4):
        super().__init__()
        if variant not in self.VARIANTS:
            raise ValueError(f"variant must be one of {sorted(self.VARIANTS)}, got {variant!r}")
        self.w_dim, self.img_resolution, self.variant = w_dim, img_resolution, variant
        self.channel_base, self.channel_max, self.start_res = channel_base, channel_max, start_res
        self.block_resolutions = [2**i for i in range(int(math.log2(start_res)), int(math.log2(img_resolution)) + 1)]
        common = dict(w_dim=w_dim, img_channels=img_channels, merge_min_res=merge_min_res,
                      conv_clamp=conv_clamp, use_noise=use_noise, head=self.VARIANTS[variant])
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockFull(
                self.channels(res // 2) if res > start_res else 0, self.channels(res), resolution=res,
                is_last=res == img_resolution, is_style=True, **common))
        ch = self.channels(self.block_resolutions[-2])
        for i in (1, 2, 3):
            setattr(self, f"spade_b128_{i}", SpadeResBlock(ch, ch, resolution=128, feat_multiplier=2,
                                                           feat_site=False))
        self.spade_feat_quant = ActScale()  # int8: one quantize of the SPADE features for all three blocks
        res = self.block_resolutions[-1]
        # V18's texture block builds (and discards) the mask heads, Full's does not
        self.texture_b256 = SynthesisBlockFull(
            self.channels(res // 2), self.channels(res), resolution=res, is_last=True,
            is_style=variant == "v18", **common)
        ngf = 64
        self.spade_encoder = nn.Sequential(
            Conv2dLayer(3, ngf, 7, activation="relu", quant_site=True),
            ResBlock(ngf, ngf, activation="relu", quant_site=True),
            ResBlock(ngf, ngf * 2, activation="relu", down=2, quant_site=True),
        )

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def blocks(self):
        return [getattr(self, f"b{res}") for res in self.block_resolutions]

    @property
    def num_ws(self) -> int:
        return sum(1 if res == self.start_res else 2 for res in self.block_resolutions) + 1

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

        if self.variant == "v18":  # the predicted sigmoid masks, detached
            upper_mask, lower_mask = aux[0].detach(), aux[1].detach()
        else:  # parsing argmax -> upper / lower masks (not differentiated)
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
        if is_int8(self.quant):
            spade_feat = self.spade_feat_quant.quantize(spade_feat, self.quant)
        h = self.spade_b128_1(x_128, spade_feat)
        h = self.spade_b128_2(h, spade_feat)
        h = self.spade_b128_3(h, spade_feat)
        _, finetune_img, _ = self.texture_b256(h, img_128, block_ws[-1], pose_feat, cat_feat,
                                               noise_mode, generator)
        if self.variant == "v18":
            return img, finetune_img, (upper_mask, lower_mask)
        return img, finetune_img, aux


class SynthesisNetworkSingle(nn.Module):
    """Single-denorm-branch pyramid of the V15/V16/V20 ("v16") and V21
    ("v21") clusters.

    Differences from SynthesisNetworkFull: one garment branch (clothes and
    its mask), SPADE blocks at feat_multiplier=1; "v16" has a sigmoid
    clothes-mask head on every skip block and returns (img, finetune_img,
    mask); "v21" has clothes and hand mask heads on the last blocks, fills
    the hand region of the SPADE features with the average face feature
    (`face_encoder` over the retain features at the second-to-last
    resolution, masked by `face_mask`) and returns (img, finetune_img, mask,
    h_mask).  NCHW."""

    VARIANTS = {"v16": ("mask1", True), "v21": ("masks_hand", False)}  # variant -> (head, head_always)

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512,
                 conv_clamp=None, use_noise=True, variant="v16"):
        super().__init__()
        if variant not in self.VARIANTS:
            raise ValueError(f"variant must be one of {sorted(self.VARIANTS)}, got {variant!r}")
        self.w_dim, self.img_resolution, self.variant = w_dim, img_resolution, variant
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        head, head_always = self.VARIANTS[variant]
        common = dict(w_dim=w_dim, img_channels=img_channels, conv_clamp=conv_clamp, use_noise=use_noise,
                      head=head, head_always=head_always)
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockFull(
                self.channels(res // 2) if res > 4 else 0, self.channels(res), resolution=res,
                is_last=res == img_resolution, is_style=True, **common))
        ch = self.channels(self.block_resolutions[-2])
        for i in (1, 2, 3):
            setattr(self, f"spade_b128_{i}", SpadeResBlock(ch, ch, resolution=128, feat_multiplier=1))
        res = self.block_resolutions[-1]
        self.texture_b256 = SynthesisBlockFull(self.channels(res // 2), self.channels(res), resolution=res,
                                               is_last=True, is_style=True, **common)
        ngf = 64
        self.spade_encoder = nn.Sequential(
            Conv2dLayer(3, ngf, 7, activation="relu"),
            ResBlock(ngf, ngf, activation="relu"),
            ResBlock(ngf, ngf * 2, activation="relu", down=2),
        )
        if variant == "v21":
            self.face_encoder = Conv2dLayer(64, 128, 1)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def blocks(self):
        return [getattr(self, f"b{res}") for res in self.block_resolutions]

    @property
    def num_ws(self) -> int:
        return sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1

    def forward(self, ws, pose_feat, cat_feat, denorm_clothes, denorm_mask, face_mask=None,
                noise_mode="random", generator=None):
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} entries, expected {self.num_ws}")
        if self.variant == "v21" and face_mask is None:
            raise ValueError("the v21 variant needs face_mask")
        block_ws = []
        w_idx = 0
        for block in self.blocks:
            block_ws.append(ws[:, w_idx : w_idx + block.num_conv + block.num_torgb])
            w_idx += block.num_conv

        x = img = aux = x_128 = img_128 = None
        for res, block, cur_ws in zip(self.block_resolutions, self.blocks, block_ws):
            x, img, cur_aux = block(x, img, cur_ws, pose_feat, cat_feat, noise_mode, generator)
            if cur_aux is not None:
                aux = cur_aux
            if res == self.block_resolutions[-2]:
                x_128, img_128 = x, img
        if self.variant == "v21":
            mask, h_mask = aux[0].detach(), aux[1].detach()
        else:
            mask, h_mask = aux.detach(), None

        # the spade feature: the valid-region average fills the person-visible,
        # garment-missing pixels (per sample; fewer than 11 valid pixels average over all)
        dt = denorm_clothes.dtype
        mask_t = (mask > 0.9).to(dt)
        mask_128 = (mask_t[:, :, ::2, ::2] > 0.9).to(dt)
        denorm_mask_128 = (denorm_mask[:, :, ::2, ::2] > 0.9).to(dt)
        valid_mask = ((mask_128 + denorm_mask_128) == 2.0).to(dt)
        res_mask = mask_128 - valid_mask
        feat = self.spade_encoder(denorm_clothes * mask_t - (1.0 - mask_t))
        feat_hw = feat.shape[2] * feat.shape[3]
        valid_sum = (feat * valid_mask).sum(dim=(2, 3), keepdim=True)
        vmask_sum = valid_mask.sum(dim=(2, 3), keepdim=True)
        vidx = (vmask_sum > 10).to(dt)
        vmask_sum = vmask_sum * vidx + feat_hw * (1.0 - vidx)
        spade_feat = feat * (1.0 - res_mask) + (valid_sum / vmask_sum) * res_mask

        if self.variant == "v21":  # hand regions take the average face feature
            face_feat = self.face_encoder(cat_feat[str(self.block_resolutions[-2])])
            fm_128 = (face_mask[:, :, ::2, ::2] > 0.9).to(dt)
            f_sum = (face_feat * fm_128).sum(dim=(2, 3), keepdim=True)
            fm_sum = fm_128.sum(dim=(2, 3), keepdim=True)
            fidx = (fm_sum > 10).to(dt)
            fm_sum = fm_sum * fidx + feat_hw * (1.0 - fidx)
            hm_256 = (h_mask > 0.9).to(dt)
            hm_128 = (hm_256[:, :, ::2, ::2] > 0.9).to(dt)
            spade_feat = spade_feat * (1.0 - hm_128) + (f_sum / fm_sum) * hm_128

        h = self.spade_b128_1(x_128, spade_feat)
        h = self.spade_b128_2(h, spade_feat)
        h = self.spade_b128_3(h, spade_feat)
        _, finetune_img, _ = self.texture_b256(h, img_128, block_ws[-1], pose_feat, cat_feat, noise_mode, generator)
        if self.variant == "v21":
            return img, finetune_img, mask, h_mask
        return img, finetune_img, mask
