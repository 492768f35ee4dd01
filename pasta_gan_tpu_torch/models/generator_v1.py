"""GeneratorV1, the original flow-based PASTA-GAN generator (counterpart of
`pasta_gan_tpu/models/generator_v1.py`; reference `training/networks.py:
338-502,805-913`, registered there as `training.networks.Generator`).

A plain skip pyramid (the pose feature replaces the learned const, the
retain features merge above 16x16) and a FlowNet (nn/flow.py) that predicts
a dense flow warping the affine-aligned garment `aff_top`; the warped
garment is mask-merged into the synthesis features at the second-to-last
resolution.  The forward takes NHWC tensors and returns the skip image
[N, H, W, 3].  There is no SPADE branch and no int8 mode: the FIR kernels
run as the up-convs' pre-FIR and the image skips' upsample (`up2`), nothing
downsamples through `down2`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.encoders import ConstEncoderNetwork, StyleEncoderNetwork
from ..nn.flow import FlowNet, grid_sample_border
from ..nn.layers import Conv2dLayer
from ..nn.mapping import MappingNetwork
from ..nn.synthesis import SynthesisBlockFull
from .generator_full import GeneratorBase, cat_feats_dict, nchw, nhwc


class SynthesisNetworkV1(nn.Module):
    """Skip pyramid with the flow-warped garment merged at the second-to-last
    resolution (reference `networks.py:444-502`): `mask_conv.0` predicts a
    sigmoid mask, the garment is subsampled by nearest neighbour
    (F.interpolate's default; `[::sy, ::sx]`), and `merge_conv.0` mixes
    [x, mask * top - (1 - mask)] back to the block's width.  The reference's
    merge is kept as it is, the `- (1 - mask)` included."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768, channel_max=512, conv_clamp=None,
                 use_noise=True):
        super().__init__()
        self.img_resolution = img_resolution
        self.channel_base, self.channel_max = channel_base, channel_max
        self.block_resolutions = [2**i for i in range(2, int(math.log2(img_resolution)) + 1)]
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlockFull(
                self.channels(res // 2) if res > 4 else 0, self.channels(res), w_dim, resolution=res,
                img_channels=img_channels, is_last=res == img_resolution, is_style=False, head=None,
                conv_clamp=conv_clamp, use_noise=use_noise))
        self.merge_res = self.block_resolutions[-2]
        ch = self.channels(self.merge_res)
        self.mask_conv = nn.Sequential(Conv2dLayer(ch, 1, 1, activation="sigmoid"))
        self.merge_conv = nn.Sequential(Conv2dLayer(ch + 3, ch, 1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1

    def forward(self, ws, pose_feat, cat_feat, rec_top, noise_mode="random", generator=None):
        """`rec_top`: the warped garment [N, 3, H, W]; returns the image NCHW."""
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img, _ = block(x, img, ws[:, w_idx : w_idx + block.num_conv + 1], pose_feat, cat_feat,
                              noise_mode=noise_mode, generator=generator)
            w_idx += block.num_conv
            if res == self.merge_res:
                mask = self.mask_conv(x)
                sy, sx = rec_top.shape[2] // x.shape[2], rec_top.shape[3] // x.shape[3]
                top = rec_top[:, :, ::sy, ::sx].to(x.dtype)
                merge_top = mask * top - (1.0 - mask)
                x = self.merge_conv(torch.cat([x, merge_top], dim=1))
        return img


class GeneratorV1(GeneratorBase):
    """Reference `Generator` (`networks.py:871-913`): pose encoder, the
    attention style encoder, mapping, FlowNet(12) and SynthesisNetworkV1."""

    def __init__(self, z_dim=0, c_dim=512, w_dim=512, img_resolution=256, img_channels=3, mapping_layers=1,
                 channel_base=32768, channel_max=512, conv_clamp=None, use_noise=True, style_input_nc=48,
                 dtype=torch.float32):
        super().__init__()
        self.config = dict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
                           img_channels=img_channels, mapping_layers=mapping_layers, channel_base=channel_base,
                           channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise,
                           style_input_nc=style_input_nc)
        self.synthesis = SynthesisNetworkV1(w_dim, img_resolution, img_channels, channel_base=channel_base,
                                            channel_max=channel_max, conv_clamp=conv_clamp, use_noise=use_noise)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, self.num_ws, num_layers=mapping_layers)
        n_down = int(math.log2(img_resolution)) - 2
        self.const_encoding = ConstEncoderNetwork(6, output_nc=self.synthesis.channels(4), ngf=64,
                                                  n_downsampling=min(n_down, 6))
        self.style_encoding = StyleEncoderNetwork(style_input_nc, output_nc=512, ngf=64)
        self.flownet = FlowNet(3 + 3 + 3 + 3)
        self.set_dtype(dtype)

    @staticmethod
    def flow_input(pose, aff_pose, aff_top, lower) -> torch.Tensor:
        """FlowNet's 12-channel NCHW input of the NHWC tensors."""
        return nchw(torch.cat([lower, aff_top, aff_pose[..., :3], pose[..., :3]], dim=-1))

    def flow(self, pose, aff_pose, aff_top, lower) -> torch.Tensor:
        """The sampling grid [N, H, W, 2] of the NHWC inputs."""
        return self.flownet(self.flow_input(pose, aff_pose, aff_top, lower))

    def forward(self, z, c, retain, pose, aff_pose, aff_top, lower, truncation_psi=1.0, truncation_cutoff=None,
                w_avg=None, noise_mode="random", generator=None):
        """c: the style patch stack [N, h, w, style_input_nc]; retain, aff_top,
        lower [N, H, W, 3]; pose [N, H, W, 6]; aff_pose [N, H, W, >= 3]."""
        pose_feat = self.const_encoding(nchw(pose))
        stylecode, feats = self.style_encoding(nchw(c), nchw(retain))
        ws, _ = self.mapping(z, stylecode, w_avg=w_avg, truncation_psi=truncation_psi,
                             truncation_cutoff=truncation_cutoff)
        rec_top = grid_sample_border(nchw(aff_top), self.flow(pose, aff_pose, aff_top, lower))
        img = self.synthesis(ws, pose_feat, cat_feats_dict(feats), rec_top, noise_mode=noise_mode,
                             generator=generator)
        return nhwc(img)
