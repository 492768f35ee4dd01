"""StyleGAN2-style patch discriminators of the co-occurrence /
swapping-autoencoder family (counterpart of
`pasta_gan_tpu/nn/patch_discriminator.py`; reference `training/networks.py:
1431-1655` for the rosinality-style layers, `:1723-1807` for the tile
sampling and random transform, `:1808-1894` StyleGAN2PatchDiscriminator and
`:1896-1991` its V2).

NCHW images in.  Names are the reference state_dict's: `convs.<layer>` with
the layers `0`, `<2^i>x<2^i>` for i > 6, `7 - i` for i <= 6, then `5`, `6`;
inside a layer `Blur.kernel` (a buffer), `Conv.weight` (OIHW) and the bias as
`Act.bias` when the layer activates, else `Conv.bias`; the head
`pairlinear.N` ([out, in]).

* EqualConv2d scales its weight by 1/sqrt(in * k^2) at run time;
  FusedLeakyReLU is leaky_relu(x + bias, 0.2) * sqrt(2).
* A downsampling layer blurs with [1, 3, 3, 1] and then runs a stride-2
  conv: `conv2d_resample(down=2, padding=k // 2)` on the layer's `Blur.kernel`
  (`setup_filter([1, 3, 3, 1])`), `flip_weight=True` since rosinality's
  convs are plain cross-correlations.  The 3x3 case is the padded FIR (pad 2)
  then a stride-2 conv; the 1x1 skip is `down2` at pad 1 then a 1x1 conv, so
  it runs on the `down2` kernel on the card, and its gradient on `up2`.
* Patch sampling: an s x s tile grid after a random crop offset when the
  image size is not a multiple of s, a random subset of `max_num_tiles`
  tiles, and per patch a random reflection and rotation (+-30 degrees) warp
  with a zero border on `data/warp.py:warp_perspective_inv`.
* V1 discriminates (real, rolled) feature pairs through a 4-layer head; V2
  scores single patch features.

Random draws are made on the host from an explicit CPU `torch.Generator`
(`draw_patches`), like the ADA pipe's: the crop offset (oy, ox), the tile
permutation and, per patch, the reflection and rotation uniforms.  A call
takes them through `draws=` instead, which is how the tests hand in the JAX
package's draws: JAX takes oy and ox from one key (so they are equal when
H mod s and W mod s are) and the fake branch's draws from `fold_in(rng, 1)`,
with the real branch's tile indices; the fake branch here, too, reuses the
real branch's indices and has draws of its own.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.warp import warp_perspective_inv
from ..ops.conv2d_resample import conv2d_resample
from ..ops.upfirdn2d import setup_filter
from ..ops.warp_math import inv3x3
from .layers import Layer

Draws = Dict[str, torch.Tensor]


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x + bias.reshape([-1] + [1] * (x.ndim - 2)).to(x.dtype), 0.2) * math.sqrt(2.0)


class Blur(nn.Module):
    """Holds the normalized FIR kernel `kernel` [4, 4] of a downsampling layer."""

    def __init__(self, taps: Sequence[float]):
        super().__init__()
        self.register_buffer("kernel", setup_filter(list(taps)))


class EqualConv2d(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, bias):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channels * kernel_size**2)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class PDConvLayer(nn.Module):
    """rosinality ConvLayer (reference `networks.py:1528-1585`)."""

    def __init__(self, in_channels, out_channels, kernel_size, downsample=False, blur_kernel=(1, 3, 3, 1),
                 bias=True, activate=True, pad=None):
        super().__init__()
        self.kernel_size, self.downsample, self.activate = kernel_size, downsample, activate
        self.pad = kernel_size // 2 if pad is None else pad
        layers = []
        if downsample:
            layers.append(("Blur", Blur(blur_kernel)))
        layers.append(("Conv", EqualConv2d(in_channels, out_channels, kernel_size, bias=bias and not activate)))
        if activate and bias:
            layers.append(("Act", FusedLeakyReLU(out_channels)))
        for name, m in layers:
            self.add_module(name, m)
        self.has_act_bias = activate and bias

    def forward(self, x):
        conv = self.Conv
        dt = conv.compute_dtype
        w = (conv.weight * conv.scale).to(dt)
        if self.downsample:
            x = conv2d_resample(x.to(dt), w, f=self.Blur.kernel, down=2, padding=self.kernel_size // 2,
                                flip_weight=True)
        else:
            x = F.conv2d(x.to(dt), w, padding=self.pad)
        if conv.bias is not None:
            x = x + conv.bias.to(dt)[:, None, None]
        if self.has_act_bias:
            return self.Act(x)
        if self.activate:
            return F.leaky_relu(x, 0.2) * math.sqrt(2.0)
        return x


class PDResBlock(nn.Module):
    """ResBlock_PD (reference `networks.py:1587-1610`): (conv2(conv1(x)) + skip(x)) / sqrt(2)."""

    def __init__(self, in_channels, out_channels, blur_kernel=(1, 3, 3, 1), downsample=True):
        super().__init__()
        self.conv1 = PDConvLayer(in_channels, in_channels, 3)
        self.conv2 = PDConvLayer(in_channels, out_channels, 3, downsample=downsample, blur_kernel=blur_kernel)
        self.skip = PDConvLayer(in_channels, out_channels, 1, downsample=downsample, blur_kernel=blur_kernel,
                                activate=False, bias=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


class EqualLinearPD(Layer):
    """EqualLinear (reference `networks.py:1611-1655`): weight [out, in] drawn
    N(0, 1) / lr_mul, scaled by lr_mul / sqrt(in) at run time."""

    def __init__(self, in_dim, out_dim, lr_mul=1.0, activation=None):
        super().__init__()
        self.lr_mul, self.activation = lr_mul, activation
        self.scale = 1.0 / math.sqrt(in_dim) * lr_mul
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator).div_(self.lr_mul)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        y = x.to(dt) @ (self.weight * self.scale).t().to(dt)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, self.bias * self.lr_mul)
        return y + (self.bias * self.lr_mul).to(dt)


def patch_transform_matrices(ref: torch.Tensor, rot: torch.Tensor, s: int) -> torch.Tensor:
    """dst -> src pixel homographies [B, 3, 3] of the reflection `ref` (+-1)
    and rotation `rot` (radians) about the patch centre, in float32 on the
    host (reference RandomSpatialTransformer, `networks.py:1145-1190`: scale 1,
    no translation, affine_grid / grid_sample with align_corners=False)."""
    ref, rot = ref.float().cpu(), rot.float().cpu()
    c, sn = torch.cos(rot), torch.sin(rot)
    zero, one = torch.zeros_like(rot), torch.ones_like(rot)
    A = torch.stack([torch.stack([ref * c, -sn, zero], -1), torch.stack([ref * sn, c, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    # normalized coords of a pixel (align_corners=False): u = (2x + 1) / s - 1
    Nm = torch.tensor([[2.0 / s, 0.0, 1.0 / s - 1.0], [0.0, 2.0 / s, 1.0 / s - 1.0], [0.0, 0.0, 1.0]])
    return torch.einsum("ij,bjk,kl->bil", inv3x3(Nm), A, Nm)


def random_patch_transform(patches: torch.Tensor, ref: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Reflect (`ref` +-1) and rotate (`rot` radians) each patch [B, C, s, s]
    about its centre, bilinear, zero border; float32 out."""
    M = patch_transform_matrices(ref, rot, patches.shape[-1]).to(patches.device)
    return warp_perspective_inv(patches, M, tuple(patches.shape[-2:]), "constant")


class StyleGAN2PatchDiscriminator(nn.Module):
    """Reference StyleGAN2PatchDiscriminator (`networks.py:1808-1894`).

    `forward(real, fake, generator=, draws=)`: samples tile patches of both
    images (the same tiles) and returns (pred_real, pred_fake) [B, T] from the
    pairwise head; `fake=None` gives (pred_real, real_patches), `fake_only`
    pred_fake alone.  `variant="v2"` scores single patch features:
    `forward(target)` -> pred [B * T, 1]."""

    variant = "v1"

    def __init__(self, scale_capacity=4.0, max_nc=256 + 128, patch_size=64, max_num_tiles=8, use_antialias=True,
                 dtype=torch.float32):
        super().__init__()
        self.scale_capacity, self.max_nc = scale_capacity, max_nc
        self.patch_size, self.max_num_tiles = patch_size, max_num_tiles
        log_size = int(math.ceil(math.log2(patch_size)))
        blur = (1, 3, 3, 1) if use_antialias else (1,)
        in_ch = self.channels(2**log_size)
        convs = [("0", PDConvLayer(3, in_ch, 3))]
        for i in range(log_size, 2, -1):
            out_ch = self.channels(2 ** (i - 1))
            convs.append((str(7 - i) if i <= 6 else f"{2**i}x{2**i}", PDResBlock(in_ch, out_ch, blur)))
            in_ch = out_ch
        convs.append(("5", PDResBlock(in_ch, max_nc * 2, blur, downsample=False)))
        convs.append(("6", PDConvLayer(max_nc * 2, max_nc, 3, pad=0)))
        self.convs = nn.Sequential(OrderedDict(convs))
        feat_dim = self.channels(4) * 2 * 2
        pair_in = feat_dim * 2 if self.variant == "v1" else feat_dim
        self.pairlinear = nn.Sequential(EqualLinearPD(pair_in, 2048, activation="fused_lrelu"),
                                        EqualLinearPD(2048, 2048, activation="fused_lrelu"),
                                        EqualLinearPD(2048, 1024, activation="fused_lrelu"),
                                        EqualLinearPD(1024, 1))
        self.set_dtype(dtype)

    def channels(self, res: int) -> int:
        cap = self.scale_capacity
        return {4: min(self.max_nc, int(256 * cap)), 8: min(self.max_nc, int(128 * cap)),
                16: min(self.max_nc, int(64 * cap)), 32: int(32 * cap), 64: int(16 * cap), 128: int(8 * cap),
                256: int(4 * cap)}[res]

    def set_dtype(self, dtype: torch.dtype) -> "StyleGAN2PatchDiscriminator":
        for m in self.modules():
            if isinstance(m, Layer):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "StyleGAN2PatchDiscriminator":
        """Redraw every weight from `generator` (biases 0), in module order."""
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)
            elif isinstance(m, FusedLeakyReLU):
                with torch.no_grad():
                    m.bias.zero_()
        return self

    # -- the random draws

    def tile_grid(self, H: int, W: int) -> Tuple[int, int, int]:
        """(tiles down, tiles across, tiles sampled) of an H x W image."""
        ny, nx = H // self.patch_size, W // self.patch_size
        return ny, nx, min(self.max_num_tiles, ny * nx)

    def draw_patches(self, B: int, H: int, W: int, generator: Optional[torch.Generator] = None) -> Draws:
        """One branch's draws, on the host: the crop offset `oy`, `ox` (0 when
        the size is a multiple of the patch), the tile `indices` [T] and per
        patch the reflection `ref` and rotation `rot` [B * T]."""
        s = self.patch_size
        ny, nx, T = self.tile_grid(H, W)
        oy = int(torch.randint(0, max(H % s, 1), (), generator=generator))
        ox = int(torch.randint(0, max(W % s, 1), (), generator=generator))
        indices = torch.randperm(ny * nx, generator=generator)[:T]
        ref = torch.round(torch.rand(B * T, generator=generator)) * 2.0 - 1.0
        max_rot = 30.0 * math.pi / 180.0
        rot = torch.rand(B * T, generator=generator) * (2 * max_rot) - max_rot
        return dict(oy=oy, ox=ox, indices=indices, ref=ref, rot=rot)

    def sample_patches(self, img: torch.Tensor, draws: Draws, indices: Optional[torch.Tensor] = None,
                       transform: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, C, H, W] -> ([B, T, C, s, s] float32, tile indices [T]) (reference
        `:1757-1775`); `indices` overrides the draws' tile indices."""
        B, C, H, W = img.shape
        s = self.patch_size
        ny, nx, _ = self.tile_grid(H, W)
        oy, ox = int(draws["oy"]), int(draws["ox"])
        img = img[:, :, oy : oy + s * ny, ox : ox + s * nx]
        tiles = img.reshape(B, C, ny, s, nx, s).permute(0, 2, 4, 1, 3, 5).reshape(B, ny * nx, C, s, s)
        indices = draws["indices"] if indices is None else indices
        tiles = tiles[:, indices.to(img.device)]
        if transform:
            T = tiles.shape[1]
            tiles = random_patch_transform(tiles.reshape(B * T, C, s, s), draws["ref"], draws["rot"])
            tiles = tiles.reshape(B, T, C, s, s)
        return tiles, indices

    # -- the networks

    def extract_features(self, patches: torch.Tensor, aggregate: bool = False) -> torch.Tensor:
        """[B, T, C, s, s] -> features [B * T, C', h, w]."""
        B, T = patches.shape[:2]
        x = self.convs(patches.reshape((B * T,) + patches.shape[2:]))
        if aggregate:
            x = x.reshape((B, T) + x.shape[1:]).mean(dim=1, keepdim=True).expand((B, T) + x.shape[1:])
            x = x.reshape((B * T,) + x.shape[2:])
        return x

    def discriminate_features(self, f1: torch.Tensor, f2: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = f1.flatten(1)
        if self.variant == "v1":
            x = torch.cat([x, f2.flatten(1)], dim=1)
        return self.pairlinear(x)

    @staticmethod
    def _rolled(feat: torch.Tensor, B: int) -> torch.Tensor:
        return feat.reshape((B, -1) + feat.shape[1:]).roll(1, dims=1).reshape(feat.shape)

    def forward(self, real: torch.Tensor, fake: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, fake_only: bool = False,
                draws: Optional[Tuple[Draws, Optional[Draws]]] = None):
        """`draws`: (real branch, fake branch) from `draw_patches`; drawn from
        `generator` when not given (the fake branch's indices are never read)."""
        B, _, H, W = real.shape
        if draws is None:
            draws = (self.draw_patches(B, H, W, generator),
                     self.draw_patches(B, H, W, generator) if fake is not None else None)
        if self.variant == "v2":
            patches, _ = self.sample_patches(real, draws[0])
            return self.discriminate_features(self.extract_features(patches))
        real_patches, ids = self.sample_patches(real, draws[0])
        real_feat = self.extract_features(real_patches)
        pred_real = None
        if fake is None or not fake_only:
            pred_real = self.discriminate_features(real_feat, self._rolled(real_feat, B)).reshape(B, -1)
        if fake is None:
            return pred_real, real_patches
        fake_patches, _ = self.sample_patches(fake, draws[1], indices=ids)
        fake_feat = self.extract_features(fake_patches)
        pred_fake = self.discriminate_features(real_feat, self._rolled(fake_feat, B)).reshape(B, -1)
        if fake_only:
            return pred_fake
        return pred_real, pred_fake


class StyleGAN2PatchDiscriminatorV2(StyleGAN2PatchDiscriminator):
    """Reference StyleGAN2PatchDiscriminator_V2 (`networks.py:1896-1991`)."""

    variant = "v2"
