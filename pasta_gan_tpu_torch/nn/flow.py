"""The FlowNet op family of the flow generator V1 (counterpart of
`pasta_gan_tpu/nn/flow.py`; the reference's `util_classes.py:17-178` and
`training/networks.py:805-868`).

V1 predicts a dense 2-channel offset field with a UNet-like encoder and
decoder (spectrally normalized convs, batch-statistics norm) and warps the
affine-aligned garment with it before the synthesis pyramid's mask merge.
NCHW activations; parameter and buffer names are the reference's
(`torch.nn.utils.spectral_norm`: `weight_orig` a parameter, `weight_u` and
`weight_v` buffers; the Sequential children `model.N`, `shortcut.0`).

* Spectral norm is torch's estimator, sigma = u . (W2d v) over the
  `[out, -1]` flattening (dim 1 first for a transposed conv), with the JAX
  package's explicit switch, set by `FlowNet.set_update_sn`: `update_sn` runs
  one power iteration a call and writes u and v back without gradient;
  otherwise u and v stay as they are.
* `batch_norm_2d` is BatchNorm2d(affine, track_running_stats=False): batch
  statistics with the biased variance in train and eval alike, in float32;
  nothing is kept between calls.
* `apply_offset` normalizes the offset grid as align_corners=True would and
  `grid_sample_border` samples it with F.grid_sample's default
  align_corners=False, the reference's own mismatch, kept as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Layer


def l2_normalize_channels(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """`Normalize` (util_classes.py:6-14): x / (||x||_2 over channels + eps)."""
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + eps)


def apply_offset(offset: torch.Tensor) -> torch.Tensor:
    """Offset field [N, 2, H, W] (x offset, y offset) -> sampling grid
    [N, H, W, 2] normalized as pos / ((size - 1) / 2) - 1 (util_classes.py:17-32)."""
    H, W = offset.shape[2], offset.shape[3]
    gx = torch.arange(W, dtype=offset.dtype, device=offset.device)[None, None, :]
    gy = torch.arange(H, dtype=offset.dtype, device=offset.device)[None, :, None]
    x = (gx + offset[:, 0]) / ((W - 1.0) / 2.0) - 1.0
    y = (gy + offset[:, 1]) / ((H - 1.0) / 2.0) - 1.0
    return torch.stack([x, y], dim=-1)


def grid_sample_border(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(img, grid, padding_mode="border") with torch's default
    align_corners=False (reference `networks.py:908`), in float32."""
    return F.grid_sample(img.float(), grid.float(), mode="bilinear", padding_mode="border", align_corners=False)


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm().clamp_min(eps)


class _SpectralNorm(Layer):
    """A weight `weight_orig` divided by its spectral norm; subclasses give
    the shape and the flattening."""

    update_sn = False
    _flat_dim = 0  # the output-channel dim of weight_orig

    def _init_sn(self, weight_shape, out_ch: int, nflat: int, bias: bool) -> None:
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.register_buffer("weight_u", torch.empty(out_ch))
        self.register_buffer("weight_v", torch.empty(nflat))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """kaiming_uniform(a=sqrt(5)) over fan_in (torch's Conv2d default; the
        JAX package's `_torch_conv_init`), zero bias, normalized N(0, 1) u, v."""
        bound = math.sqrt(1.0 / self.weight_orig[0].numel())  # fan_in: in*k*k, or out*k*k transposed
        with torch.no_grad():
            self.weight_orig.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            for buf in (self.weight_u, self.weight_v):
                buf.normal_(0.0, 1.0, generator=generator)
                buf.copy_(_l2n(buf))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight_orig
        w2d = (w if self._flat_dim == 0 else w.transpose(0, 1)).reshape(self.weight_u.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if self.update_sn:
            with torch.no_grad():
                v = _l2n(w2d.t() @ u)
                u = _l2n(w2d @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w / torch.dot(u, w2d @ v)


class SpectralConv(_SpectralNorm):
    """nn.Conv2d wrapped in torch's spectral_norm; weight OIHW."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_sn((out_ch, in_ch, kernel, kernel), out_ch, in_ch * kernel * kernel, bias)

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.normalized_weight().to(dt), b, stride=self.stride, padding=self.padding)


class SpectralConvTranspose(_SpectralNorm):
    """nn.ConvTranspose2d(k, stride 2, padding 1, output_padding 1) wrapped in
    spectral_norm, which flattens a transposed conv's weight [in, out, kh, kw]
    along dim 1 first."""

    _flat_dim = 1

    def __init__(self, in_ch, out_ch, kernel=3):
        super().__init__()
        self._init_sn((in_ch, out_ch, kernel, kernel), out_ch, in_ch * kernel * kernel, True)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.normalized_weight().to(dt), self.bias.to(dt), stride=2, padding=1,
                                  output_padding=1)


def batch_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d(affine, track_running_stats=False): batch statistics (the
    biased variance) in train and eval, computed and returned in float32."""
    x = x.float()
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight[:, None, None] + bias[:, None, None]


class BatchNorm2dNoStats(Layer):
    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return batch_norm_2d(x, self.weight, self.bias)


def _leaky(x):
    return F.leaky_relu(x, 0.01)  # torch's LeakyReLU default slope


class AddCoords(nn.Module):
    """CoordConv coordinate channels (util_classes.py:43-73); `with_r` adds the
    radius.  V1 does not use it (use_coord=False)."""

    def __init__(self, with_r: bool = False):
        super().__init__()
        self.with_r = with_r

    def forward(self, x):
        N, _, H, W = x.shape
        xx = (torch.arange(W, dtype=x.dtype, device=x.device) / (W - 1.0) * 2.0 - 1.0)[None, None, None, :]
        yy = (torch.arange(H, dtype=x.dtype, device=x.device) / (H - 1.0) * 2.0 - 1.0)[None, None, :, None]
        xx, yy = xx.expand(N, 1, H, W), yy.expand(N, 1, H, W)
        out = [x, xx, yy]
        if self.with_r:
            out.append((xx.square() + yy.square()).sqrt())
        return torch.cat(out, dim=1)


class EncoderBlock(nn.Module):
    """util_classes.py:103-125: BN, lrelu, conv (4x4 stride 2, or 3x3), BN,
    lrelu, conv 3x3 as `model.0` ... `model.5`."""

    def __init__(self, in_ch, out_ch, downsample=True):
        super().__init__()
        k, s = (4, 2) if downsample else (3, 1)
        self.model = nn.Sequential(BatchNorm2dNoStats(in_ch), nn.LeakyReLU(0.01),
                                   SpectralConv(in_ch, out_ch, k, s, 1),
                                   BatchNorm2dNoStats(out_ch), nn.LeakyReLU(0.01),
                                   SpectralConv(out_ch, out_ch, 3, 1, 1))

    def forward(self, x):
        return self.model(x)


class ResBlockDecoder(nn.Module):
    """util_classes.py:128-157: the residual (upsampling) decoder block."""

    def __init__(self, in_ch, out_ch, hidden_ch=None, upsample=True):
        super().__init__()
        hid = hidden_ch or in_ch
        self.upsample = upsample
        last = (SpectralConvTranspose(hid, out_ch, 3) if upsample
                else SpectralConv(hid, out_ch, 3, 1, 1))
        self.model = nn.Sequential(BatchNorm2dNoStats(in_ch), nn.LeakyReLU(0.01),
                                   SpectralConv(in_ch, hid, 3, 1, 1),
                                   BatchNorm2dNoStats(hid), nn.LeakyReLU(0.01), last)
        if upsample:
            self.shortcut = nn.Sequential(SpectralConvTranspose(in_ch, out_ch, 3))

    def forward(self, x):
        y = self.model(x)
        return y + (self.shortcut(x) if self.upsample else x)


class Jump(nn.Module):
    """util_classes.py:160-179 without a norm layer (the FlowNet config):
    lrelu, reflection pad, conv k x k at padding 0 (`conv1`)."""

    def __init__(self, in_ch, out_ch, kernel=3):
        super().__init__()
        self.pad = kernel // 2
        self.conv1 = SpectralConv(in_ch, out_ch, kernel, 1, 0)

    def forward(self, x):
        x = _leaky(x)
        p = self.pad
        return self.conv1(F.pad(x, (p, p, p, p), mode="reflect"))


class PlainConv(Layer):
    """nn.Conv2d with torch's default init: the flow head."""

    def __init__(self, in_ch, out_ch, kernel=3, padding=1):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        bound = math.sqrt(1.0 / self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), padding=self.padding)


class FlowNet(nn.Module):
    """Reference `networks.py:805-868`: an `encoder_layer`-level encoder, as
    many residual decoder blocks with Jump skips, and the 2-channel flow head
    turned into a sampling grid [N, H, W, 2] by `apply_offset`.  The
    reference builds a head at every level and uses the last one; only that
    one, `flow{E-1}`, is built here."""

    def __init__(self, input_nc, ngf=64, img_f=512, encoder_layer=4):
        super().__init__()
        E = self.encoder_layer = encoder_layer
        self.encoder0 = EncoderBlock(input_nc, ngf, downsample=False)
        mult = 1
        for i in range(E - 1):
            mult_prev, mult = mult, min(2 ** (i + 1), img_f // ngf)
            setattr(self, f"encoder{i + 1}", EncoderBlock(ngf * mult_prev, ngf * mult))
        for i in range(E):
            mult_prev = mult
            mult = min(2 ** (E - i - 2), img_f // ngf) if i != E - 1 else 1
            setattr(self, f"decoder{i}", ResBlockDecoder(ngf * mult_prev, ngf * mult, ngf * mult,
                                                         upsample=i != E - 1))
            if i != E - 1:
                setattr(self, f"jump{i}", Jump(ngf * mult, ngf * mult, 3))
        setattr(self, f"flow{E - 1}", PlainConv(ngf * mult_prev, 2))

    def set_update_sn(self, on: bool) -> "FlowNet":
        """One power iteration a call (training) or frozen u, v (eval)."""
        for m in self.modules():
            if isinstance(m, _SpectralNorm):
                m.update_sn = on
        return self

    def offset(self, x: torch.Tensor) -> torch.Tensor:
        """The flow head's offset field [N, 2, H, W] of the NCHW input."""
        E = self.encoder_layer
        results = [self.encoder0(x)]
        for i in range(E - 1):
            results.append(getattr(self, f"encoder{i + 1}")(results[-1]))
        out = results[-1]
        for i in range(E):
            out = getattr(self, f"decoder{i}")(out)
            if i != E - 1:
                out = out + getattr(self, f"jump{i}")(results[E - i - 2])
        return getattr(self, f"flow{E - 1}")(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_offset(self.offset(x))
