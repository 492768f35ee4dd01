"""ADA augmentation pipe (counterpart of `pasta_gan_tpu/train/augment.py`).

The pipe of "Training Generative Adversarial Networks with Limited Data":
pixel blitting and general geometric transforms composed into one inverse
matrix per sample and executed as one warp of a 2x sym6-supersampled image,
then a color matrix, wavelet-band filtering, additive noise and cutout, each
gated per sample by the probability p.  Images are NHWC in and out, NCHW
inside.

Draws.  Every random number is drawn on the host, from a CPU
`torch.Generator`, in `AugmentPipe.draw`, which also composes the matrices
(float32, on the host); `AugmentPipe.apply` moves them to the images' device
and transforms the images.  So one seed gives the same augmentation on the
CPU and on the card.  `debug_percentile` replaces every draw by a fixed
percentile and applies every transform, the reference's determinism hook
(the noise image itself stays random).

As in the JAX package, the geometric pad is a static reflect margin
(W // 4 + 6 by default, `static_margin` overrides it) where the reference
computes one per batch, and `fast_geom` runs the warp as the two-pass affine
resample (ops/shear_warp.py) instead of the exact bilinear warp
(data/warp.py:warp_perspective_inv).  Every step has derivatives of every
order in the images (gathers, depthwise FIRs, matrix products, elementwise
math), as R1 through the pipe needs.  Output dtype follows the JAX code's
promotion: float32 after a warp, a color matrix or noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.warp import warp_perspective_inv
from ..ops.shear_warp import affine_resample_two_pass
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d

# Standard orthogonal wavelet filter coefficients (public constants).
WAVELETS = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025],
    "sym6": [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
}

_BLIT = dict(xflip=1, rotate90=1, xint=1)
_GEOM = dict(scale=1, rotate=1, aniso=1, xfrac=1)
_COLOR = dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)
# augpipe presets (reference `train_wo_flow_fullbody.py:297-308`)
AUGPIPE_SPECS = {
    "blit": _BLIT,
    "geom": _GEOM,
    "color": _COLOR,
    "filter": dict(imgfilter=1),
    "noise": dict(noise=1),
    "cutout": dict(cutout=1),
    "bg": {**_BLIT, **_GEOM},
    "bgc": {**_BLIT, **_GEOM, **_COLOR},
    "bgcf": {**_BLIT, **_GEOM, **_COLOR, "imgfilter": 1},
    "bgcfn": {**_BLIT, **_GEOM, **_COLOR, "imgfilter": 1, "noise": 1},
    "bgcfnc": {**_BLIT, **_GEOM, **_COLOR, "imgfilter": 1, "noise": 1, "cutout": 1},
}


# ---- batched homogeneous matrices from [N] float32 tensors (reference augment.py:43-107)

def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, tx], [z, o, ty], [z, z, o]])


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z], [z, sy, z], [z, z, o]])


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def _translate3d(t):  # t [N, 3]
    out = torch.eye(4).repeat(t.shape[0], 1, 1)
    out[:, :3, 3] = t
    return out


def _scale3d(s):  # s [N, 3]
    out = torch.eye(4).repeat(s.shape[0], 1, 1)
    out[:, 0, 0], out[:, 1, 1], out[:, 2, 2] = s[:, 0], s[:, 1], s[:, 2]
    return out


def _rotate3d(v, theta):
    vx, vy, vz = v[0], v[1], v[2]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, z],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, z],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, z],
        [z, z, z, o],
    ])


def _build_fbank() -> np.ndarray:
    """4-band wavelet filter bank (reference augment.py:169-179)."""
    import scipy.signal

    Hz_lo = np.asarray(WAVELETS["sym2"])
    Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
    Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
    Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
    Hz_fbank = np.eye(4, 1)
    for i in range(1, Hz_fbank.shape[0]):
        Hz_fbank = np.dstack([Hz_fbank, np.zeros_like(Hz_fbank)]).reshape(Hz_fbank.shape[0], -1)[:, :-1]
        Hz_fbank = scipy.signal.convolve(Hz_fbank, [Hz_lo2])
        Hz_fbank[i, (Hz_fbank.shape[1] - Hz_hi2.size) // 2 : (Hz_fbank.shape[1] + Hz_hi2.size) // 2] += Hz_hi2
    return Hz_fbank.astype(np.float32)


class Draws(NamedTuple):
    """One call's draws, float32 on the host; None where the pipe has no such stage."""

    G_inv: Optional[torch.Tensor]  # [N, 3, 3] inverse geometric transform, centered pixels
    C4: Optional[torch.Tensor]  # [N, 4, 4] color matrix
    filter: Optional[torch.Tensor]  # [N, taps] per-sample wavelet-band filter
    noise: Optional[torch.Tensor]  # [N, H, W, C] additive noise, already scaled by sigma
    cutout: Optional[torch.Tensor]  # [N, 4] (size x, size y, center x, center y)
    gates: Dict[str, torch.Tensor]  # stage -> bool [N], which samples drew the transform (random mode)


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """Stateless ADA pipe; p is passed at call time (it lives in TrainState)."""

    # pixel blitting
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # geometric
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # color
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # image-space filtering
    imgfilter: float = 0.0
    imgfilter_bands: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # corruptions
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # static reflect margin of the geometric stage (module docstring)
    static_margin: Optional[int] = None
    # two-pass affine warp (ops/shear_warp.py) instead of the exact bilinear one
    fast_geom: bool = False

    @classmethod
    def from_spec(cls, name: str = "bgc", **kw) -> "AugmentPipe":
        return cls(**{**AUGPIPE_SPECS[name], **kw})

    def __call__(self, images: torch.Tensor, p, generator: Optional[torch.Generator] = None,
                 debug_percentile=None) -> torch.Tensor:
        """images [N, H, W, C] float; p the augment probability (a float, or
        a tensor read once); generator a CPU generator for the draws."""
        N, H, W, C = images.shape
        return self.apply(images, self.draw(N, H, W, C, p, generator, debug_percentile))

    # ------------------------------------------------------------- draws

    def draw(self, N: int, H: int, W: int, C: int, p, generator: Optional[torch.Generator] = None,
             debug_percentile=None) -> Draws:
        """All draws of one call and the matrices they compose (reference
        augment.py:185-420 in its order: geometric draws compose G_inv by
        right-multiplication, color draws C4 by left-multiplication)."""
        p = torch.as_tensor(p, dtype=torch.float32).detach().cpu()
        dp = None if debug_percentile is None else torch.as_tensor(debug_percentile, dtype=torch.float32)
        gates: Dict[str, torch.Tensor] = {}

        def uniform(*shape):
            return torch.rand((N,) + shape, generator=generator)

        def normal(*shape):
            return torch.randn((N,) + shape, generator=generator)

        def gate(name, value, identity, prob):
            if dp is not None:
                return value  # debug mode: every transform applied
            sel = uniform() < prob
            gates[name] = sel
            return torch.where(sel.reshape((N,) + (1,) * (value.ndim - 1)), value, identity)

        def full(v, *shape):
            return v.expand((N,) + shape).clone()

        # ---------------------------------------------------- geometric
        G_inv = torch.eye(3).repeat(N, 1, 1)
        if self.xflip > 0:
            i = torch.floor(uniform() * 2)
            i = gate("xflip", i, torch.zeros_like(i), self.xflip * p)
            if dp is not None:
                i = full(torch.floor(dp * 2))
            G_inv = G_inv @ _scale2d(1.0 / (1 - 2 * i), torch.ones_like(i))
        if self.rotate90 > 0:
            i = torch.floor(uniform() * 4)
            i = gate("rotate90", i, torch.zeros_like(i), self.rotate90 * p)
            if dp is not None:
                i = full(torch.floor(dp * 4))
            G_inv = G_inv @ _rotate2d(-(-np.pi / 2) * i)
        if self.xint > 0:
            t = (uniform(2) * 2 - 1) * self.xint_max
            t = gate("xint", t, torch.zeros_like(t), self.xint * p)
            if dp is not None:
                t = full((dp * 2 - 1) * self.xint_max, 2)
            G_inv = G_inv @ _translate2d(-torch.round(t[:, 0] * W), -torch.round(t[:, 1] * H))
        if self.scale > 0:
            s = torch.exp2(normal() * self.scale_std)
            s = gate("scale", s, torch.ones_like(s), self.scale * p)
            if dp is not None:
                s = full(torch.exp2(torch.erfinv(dp * 2 - 1) * self.scale_std))
            G_inv = G_inv @ _scale2d(1 / s, 1 / s)
        # both rotations gate at p_rot, so that one of them is applied with p * rotate
        p_rot = 1 - torch.sqrt(torch.clamp(1 - self.rotate * p, 0, 1))
        if self.rotate > 0:
            theta = (uniform() * 2 - 1) * np.pi * self.rotate_max
            theta = gate("rotate", theta, torch.zeros_like(theta), p_rot)
            if dp is not None:
                theta = full((dp * 2 - 1) * np.pi * self.rotate_max)
            G_inv = G_inv @ _rotate2d(theta)
        if self.aniso > 0:
            s = torch.exp2(normal() * self.aniso_std)
            s = gate("aniso", s, torch.ones_like(s), self.aniso * p)
            if dp is not None:
                s = full(torch.exp2(torch.erfinv(dp * 2 - 1) * self.aniso_std))
            G_inv = G_inv @ _scale2d(1 / s, s)
        if self.rotate > 0:
            theta = (uniform() * 2 - 1) * np.pi * self.rotate_max
            theta = gate("rotate_post", theta, torch.zeros_like(theta), p_rot)
            if dp is not None:
                theta = torch.zeros(N)  # the reference zeroes the post-rotation in debug mode
            G_inv = G_inv @ _rotate2d(theta)
        if self.xfrac > 0:
            t = normal(2) * self.xfrac_std
            t = gate("xfrac", t, torch.zeros_like(t), self.xfrac * p)
            if dp is not None:
                t = full(torch.erfinv(dp * 2 - 1) * self.xfrac_std, 2)
            G_inv = G_inv @ _translate2d(-t[:, 0] * W, -t[:, 1] * H)
        any_geom = any(v > 0 for v in (self.xflip, self.rotate90, self.xint, self.scale, self.rotate,
                                       self.aniso, self.xfrac))

        # ---------------------------------------------------- color
        C4 = torch.eye(4).repeat(N, 1, 1)
        v_luma = torch.tensor([1.0, 1.0, 1.0, 0.0]) / np.sqrt(3)
        vv = torch.outer(v_luma, v_luma)
        if self.brightness > 0:
            b = normal() * self.brightness_std
            b = gate("brightness", b, torch.zeros_like(b), self.brightness * p)
            if dp is not None:
                b = full(torch.erfinv(dp * 2 - 1) * self.brightness_std)
            C4 = _translate3d(torch.stack([b, b, b], -1)) @ C4
        if self.contrast > 0:
            c = torch.exp2(normal() * self.contrast_std)
            c = gate("contrast", c, torch.ones_like(c), self.contrast * p)
            if dp is not None:
                c = full(torch.exp2(torch.erfinv(dp * 2 - 1) * self.contrast_std))
            C4 = _scale3d(torch.stack([c, c, c], -1)) @ C4
        if self.lumaflip > 0:
            i = torch.floor(uniform() * 2)
            i = gate("lumaflip", i, torch.zeros_like(i), self.lumaflip * p)
            if dp is not None:
                i = full(torch.floor(dp * 2))
            C4 = (torch.eye(4) - 2 * vv * i[:, None, None]) @ C4
        if self.hue > 0 and C > 1:
            theta = (uniform() * 2 - 1) * np.pi * self.hue_max
            theta = gate("hue", theta, torch.zeros_like(theta), self.hue * p)
            if dp is not None:
                theta = full((dp * 2 - 1) * np.pi * self.hue_max)
            C4 = _rotate3d(v_luma[:3] / torch.linalg.norm(v_luma[:3]), theta) @ C4
        if self.saturation > 0 and C > 1:
            s = torch.exp2(normal() * self.saturation_std)
            s = gate("saturation", s, torch.ones_like(s), self.saturation * p)
            if dp is not None:
                s = full(torch.exp2(torch.erfinv(dp * 2 - 1) * self.saturation_std))
            C4 = (vv + (torch.eye(4) - vv) * s[:, None, None]) @ C4
        any_color = any(v > 0 for v in (self.brightness, self.contrast, self.lumaflip, self.hue, self.saturation))

        # ---------------------------------------------------- wavelet-band filter
        Hz_prime = None
        if self.imgfilter > 0:
            fbank = torch.from_numpy(_build_fbank())  # [bands, taps]
            num_bands = fbank.shape[0]
            expected_power = torch.tensor([10.0, 1.0, 1.0, 1.0]) / 13.0
            g = torch.ones(N, num_bands)
            for i, band_strength in enumerate(self.imgfilter_bands):
                t_i = torch.exp2(normal() * self.imgfilter_std)
                t_i = gate(f"imgfilter{i}", t_i, torch.ones_like(t_i), self.imgfilter * p * band_strength)
                if dp is not None:
                    t_i = (full(torch.exp2(torch.erfinv(dp * 2 - 1) * self.imgfilter_std)) if band_strength > 0
                           else torch.ones(N))
                t = torch.ones(N, num_bands)
                t[:, i] = t_i
                t = t / torch.sqrt(torch.sum(expected_power * torch.square(t), dim=-1, keepdim=True))
                g = g * t
            Hz_prime = g @ fbank

        # ---------------------------------------------------- corruptions
        noise = None
        if self.noise > 0:
            sigma = normal().abs() * self.noise_std
            sigma = gate("noise", sigma, torch.zeros_like(sigma), self.noise * p)
            if dp is not None:
                sigma = full(torch.erfinv(dp) * self.noise_std)
            noise = torch.randn((N, H, W, C), generator=generator) * sigma[:, None, None, None]
        cutout = None
        if self.cutout > 0:
            size = torch.full((N, 2), self.cutout_size)
            sel = uniform() < self.cutout * p
            if dp is None:
                gates["cutout"] = sel
            size = torch.where(sel[:, None], size, torch.zeros_like(size))
            center = uniform(2)
            if dp is not None:
                size = torch.full((N, 2), self.cutout_size)
                center = full(dp, 2)
            cutout = torch.cat([size, center], dim=1)

        return Draws(G_inv if any_geom else None, C4 if any_color else None, Hz_prime, noise, cutout, gates)

    # ------------------------------------------------------------- execution

    def apply(self, images: torch.Tensor, d: Draws) -> torch.Tensor:
        """Transform images [N, H, W, C] by the draws `d` (see `draw`)."""
        N, H, W, C = images.shape
        dev = images.device
        x = images.permute(0, 3, 1, 2)
        if d.G_inv is not None:
            x = self._execute_geometric(x, d.G_inv)
        if d.C4 is not None:
            C4 = d.C4.to(dev)
            flat = x.reshape(N, C, H * W).float()
            if C == 3:
                flat = torch.bmm(C4[:, :3, :3], flat) + C4[:, :3, 3:]
            elif C == 1:
                Cm = C4[:, :3, :].mean(dim=1, keepdim=True)  # [N, 1, 4]
                flat = flat * Cm[:, :, :3].sum(dim=2, keepdim=True) + Cm[:, :, 3:]
            else:
                raise ValueError("images must be RGB or L")
            x = flat.reshape(N, C, H, W)
        if d.filter is not None:
            x = self._execute_imgfilter(x, d.filter.to(dev))
        if d.noise is not None:
            x = x + d.noise.to(dev).permute(0, 3, 1, 2)
        if d.cutout is not None:
            cut = d.cutout.to(dev)
            cx = torch.arange(W, device=dev)[None, None, :]
            cy = torch.arange(H, device=dev)[None, :, None]
            mask_x = ((cx + 0.5) / W - cut[:, 2, None, None]).abs() >= cut[:, 0, None, None] / 2
            mask_y = ((cy + 0.5) / H - cut[:, 3, None, None]).abs() >= cut[:, 1, None, None] / 2
            x = x * (mask_x | mask_y)[:, None].to(x.dtype)
        return x.permute(0, 2, 3, 1)

    def _execute_geometric(self, x: torch.Tensor, G_inv: torch.Tensor) -> torch.Tensor:
        """Reflect pad, 2x sym6 upsample, warp, 2x sym6 downsample and crop
        (reference augment.py:272-301); x NCHW, G_inv [N, 3, 3] on the host."""
        N, C, H, W = x.shape
        Hz_geom = setup_filter(WAVELETS["sym6"], device=x.device)
        Hz_pad = len(WAVELETS["sym6"]) // 4
        m = self.static_margin if self.static_margin is not None else W // 4 + Hz_pad * 2
        x = F.pad(x, (m, m, m, m), mode="reflect")
        x = upsample2d(x, Hz_geom, up=2)
        Hu, Wu = x.shape[2], x.shape[3]
        Ho, Wo = (H + Hz_pad * 2) * 2, (W + Hz_pad * 2) * 2

        def t2(tx, ty):
            return _translate2d(torch.full((N,), float(tx)), torch.full((N,), float(ty)))

        def s2(sx, sy):
            return _scale2d(torch.full((N,), float(sx)), torch.full((N,), float(sy)))

        # the reference's normalized-frame chain (augment.py:287-296); the
        # symmetric pad cancels
        G = s2(2, 2) @ G_inv @ s2(0.5, 0.5)
        G = t2(-0.5, -0.5) @ G @ t2(0.5, 0.5)
        G = s2(2 / Wu, 2 / Hu) @ G @ s2(Wo / 2, Ho / 2)
        # pixel-space dst -> src: Ninv_in @ G @ N_out
        N_out = t2(-1, -1) @ s2(2 / Wo, 2 / Ho) @ t2(0.5, 0.5)
        Ninv_in = t2(-0.5, -0.5) @ s2(Wu / 2, Hu / 2) @ t2(1, 1)
        A = (Ninv_in @ G @ N_out).to(x.device)
        if self.fast_geom:
            warped = affine_resample_two_pass(x, A[:, :2, :], (Ho, Wo))
        else:
            warped = warp_perspective_inv(x, A, (Ho, Wo), "constant")
        return downsample2d(warped, Hz_geom, down=2, padding=-Hz_pad * 2, flip_filter=True)

    @staticmethod
    def _execute_imgfilter(x: torch.Tensor, Hz_prime: torch.Tensor) -> torch.Tensor:
        """Per-(sample, channel) separable filter, reflect padded (reference
        augment.py:395-420); x NCHW, Hz_prime [N, taps]."""
        N, C, H, W = x.shape
        taps = Hz_prime.shape[1]
        pad = taps // 2
        dtype = torch.promote_types(x.dtype, torch.float32)
        x = F.pad(x.to(dtype), (pad, pad, pad, pad), mode="reflect").reshape(1, N * C, H + 2 * pad, W + 2 * pad)
        kern = Hz_prime.repeat_interleave(C, dim=0).to(dtype)  # [N*C, taps], sample-major
        x = F.conv2d(x, kern[:, None, :, None], groups=N * C)
        x = F.conv2d(x, kern[:, None, None, :], groups=N * C)
        return x.reshape(N, C, H, W)
