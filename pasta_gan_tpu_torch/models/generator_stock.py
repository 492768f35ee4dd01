"""The stock (unconditional) StyleGAN2-ADA generator, the landing target of
legacy TensorFlow pickles (counterpart of `pasta_gan_tpu/models/generator_stock.py`).

A TF StyleGAN2 export (the reference's transfer-learning resume presets,
`train_wo_flow_fullbody.py:319-325`) holds the upstream const-input
generator: mapping z (and c) -> w, then a 4x4 const and a pyramid of blocks
of `conv0` (up=2) + `conv1`.  Architectures "skip" (every block adds its
ToRGB to the upsampled image, each block's `torgb` reading the next block's
first w), "resnet" (a 1x1 up=2 `skip` conv beside the two convs at gain
sqrt(0.5), ToRGB on the last block only) and "orig" (the last block's ToRGB
only).  The image skip and the up-convs' FIR are `upsample2d`'s and
`conv2d_resample`'s, i.e. the `up2` kernel on the card.

State_dict names are the reference's (`mapping.fc{i}`, `synthesis.b{r}.const`,
`synthesis.b{r}.conv0.affine.weight`, `...torgb.weight`, `...skip.weight`),
each synthesis layer with its `noise_const` buffer; `io/tf_legacy.py` fills
them from a TF pickle.  `forward` takes z [N, z_dim] (and c) and returns
(img NHWC float32, w_raw).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import Conv2dLayer, Layer, _filter_buffer, _normal_
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SynthesisLayer, ToRGBLayer
from ..ops.upfirdn2d import upsample2d
from .generator_full import GeneratorBase

ARCHITECTURES = ("orig", "skip", "resnet")


class SynthesisBlockStock(Layer):
    """Const or upsampled input, two modulated convs and the architecture's skip."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels, is_last, architecture="skip",
                 resample_filter=(1, 3, 3, 1), conv_clamp=None, use_noise=True, activation="lrelu"):
        super().__init__()
        if architecture not in ARCHITECTURES:
            raise ValueError(f"architecture must be one of {ARCHITECTURES}, got {architecture!r}")
        self.in_channels, self.out_channels, self.resolution = in_channels, out_channels, resolution
        self.is_last, self.architecture = is_last, architecture
        common = dict(w_dim=w_dim, resolution=resolution, resample_filter=resample_filter, conv_clamp=conv_clamp,
                      use_noise=use_noise, activation=activation)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **common)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **common)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp)
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, 1, bias=False, up=2, resample_filter=resample_filter)
        _filter_buffer(self, resample_filter)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.in_channels == 0:
            _normal_(self.const, generator)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    @property
    def num_torgb(self) -> int:
        return 1 if (self.is_last or self.architecture == "skip") else 0

    def forward(self, x, img, ws, noise_mode="random", generator=None):
        """x NCHW (None for the const block), img NCHW float32 or None, ws
        [N, num_conv + num_torgb, w_dim].  Returns (x, img)."""
        dt = self.conv1.compute_dtype
        if self.in_channels == 0:
            x = self.const.to(dt)[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, ws[:, 0], noise_mode=noise_mode, generator=generator)
        elif self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, gain=math.sqrt(0.5), generator=generator)
            x = y + x
        else:
            x = self.conv0(x.to(dt), ws[:, 0], noise_mode=noise_mode, generator=generator)
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, generator=generator)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb(x, ws[:, self.num_conv]).float()
            img = img + y if img is not None else y
        return x, img


class SynthesisNetworkStock(nn.Module):
    """The 4x4 -> img_resolution const-input pyramid."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512, num_fp16_res=0,
                 conv_clamp=None, architecture="skip", resample_filter=(1, 3, 3, 1), use_noise=True,
                 activation="lrelu"):
        super().__init__()
        # num_fp16_res is the reference's mixed-precision split, accepted for the converted
        # kwargs; the compute dtype is the generator's
        self.w_dim, self.img_resolution, self.img_channels = w_dim, img_resolution, img_channels
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockStock(
                self.channels(res // 2) if res > 4 else 0, self.channels(res), w_dim=w_dim, resolution=res,
                img_channels=img_channels, is_last=res == img_resolution, architecture=architecture,
                resample_filter=resample_filter, conv_clamp=conv_clamp, use_noise=use_noise, activation=activation))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return 2 * len(self.block_resolutions)  # 1 conv (b4) + 2 a block above + the last block's torgb

    def forward(self, ws, noise_mode="random", generator=None):
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} entries, expected {self.num_ws}")
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            # a skip block's torgb reads the next block's first w
            x, img = block(x, img, ws[:, w_idx : w_idx + block.num_conv + block.num_torgb], noise_mode, generator)
            w_idx += block.num_conv
        return img


class GeneratorStock(GeneratorBase):
    """Mapping + stock synthesis; `io/tf_legacy.py:generator_kwargs_from_tf`'s
    kwargs land on these arguments as they are."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels, mapping_kwargs=None,
                 synthesis_kwargs=None, dtype=torch.float32):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.synthesis = SynthesisNetworkStock(w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
                                               **(synthesis_kwargs or {}))
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, num_ws=self.num_ws,
                                      **(mapping_kwargs or {}))
        self.set_dtype(dtype)

    def forward(self, z, c=None, w_avg=None, truncation_psi=1.0, truncation_cutoff=None, noise_mode="random",
                generator=None):
        ws, w_raw = self.mapping(z, c, w_avg=w_avg, truncation_psi=truncation_psi,
                                 truncation_cutoff=truncation_cutoff)
        img = self.synthesis(ws, noise_mode=noise_mode, generator=generator)
        return img.permute(0, 2, 3, 1).contiguous(), w_raw
