"""The port's CUDA kernels against their plain PyTorch versions: the three
routing kernels (norm_warp at 4 and 8 channels, composite, denorm_warp with
both borders), the two FIR resampling kernels (up2, down2), the int8
convolution of int8 serving (int8_conv, bit for bit: every tile width, the
persistent walk over more tiles than SMs, the input-dilation phases, the
16-channel activations, the activation tile gathered and loaded by TMA) and its quantize-and-pack pass (quantize_pack, bit
for bit: fp32 and bf16, ties, clamping, ragged and unaligned planes, a
channel count that is not a multiple of 16); norm_warp and
composite also on the routing operands of the real fixture pairs
(tests/fixtures/upt_mini, decoded by the port without PIL).

This file imports no JAX, so it also runs on a machine with an NVIDIA GPU
and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest` because tests/conftest.py sets up JAX).  Without a card the
`cuda` tests skip; the numpy input makers here are shared with
tests/test_torch_routing.py, which holds the plain versions against JAX.

Routing tolerance atol 5e-5.  The composite inputs are seeds whose mask values keep
farther than 1e-5 from 254.5/255 (tests/test_torch_routing.py asserts it),
so every pixel is compared.  denorm_warp and norm_warp repeat their plain
versions' rounded operations in order, so on the card they agree to the bit
(chip_smoke.py prints the error); the first denorm_warp test holds it to the
routing tolerance, and every norm_warp test holds it to the bit (rtol 0,
atol 0): ragged rows and planes, an output at an odd element offset, all
parts from one source, one part, an invalid sample, and 65 537 planes.

FIR tolerances: fp32 atol 1e-6 (the kernels repeat the plain version's
rounded products and sums in its order, so they agree to the bit on the
card); bf16 within 2 ulp (relative 2^-7) of the plain version.

The cases of the index paths that denorm_warp's and up2's vector stores and
paired loads add (ragged rows, one part, an invalid sample; ragged flat
ends, narrow rows, inputs at an odd element offset) are held to the bit in
fp32: rtol 0, atol 0.  So are down2's strip and per-output paths (rows of
2W + 2, output rows of 1 to 8, ragged strips and row chunks, odd offsets;
fp32 and bf16) and composite's skipped (part, strip) pairs (small quads,
support edges within a pixel of a strip, eroded parts seen only through
the halo, skipped hand parts, a part far off the frame and a horizon).  On
the CPU, `composite_live_tiles` (the skip test's plain version) is checked
to keep every pixel whose coordinates fall inside a part's support.
"""

import os

import numpy as np
import pytest
import torch

from pasta_gan_tpu_torch.ops import cuda_kernels as ck
from pasta_gan_tpu_torch.ops import upfirdn_kernels as uk
from pasta_gan_tpu_torch.ops import warp_kernels as wk
from pasta_gan_tpu_torch.ops.warp_math import inv3x3

TOL = 5e-5
GROUPS = (0, 0, 0, 1, 1)
ERODE = (True, True, False, False, True)
HANDS = (1, 3)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided at run time, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _homographies(rng, n, frame, patch, to_patch=True):
    """Random well-conditioned quad <-> patch homographies (DLT via SVD)."""
    Ms = []
    for _ in range(n):
        cx, cy = rng.uniform(0.3 * frame, 0.7 * frame, 2)
        wq, hq = rng.uniform(0.2 * frame, 0.45 * frame, 2)
        ang = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        base = np.array([[-wq / 2, -hq / 2], [wq / 2, -hq / 2], [wq / 2, hq / 2], [-wq / 2, hq / 2]])
        quad = (base @ R.T + [cx, cy]).astype(np.float32)
        box = np.array([[0, 0], [patch - 1, 0], [patch - 1, patch - 1], [0, patch - 1]], np.float32)
        src, dst = (quad, box) if to_patch else (box, quad)
        A = []
        for (x, y), (u, v) in zip(src, dst):
            A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        M = np.linalg.svd(np.asarray(A))[2][-1].reshape(3, 3)
        Ms.append(M / M[2, 2])
    return np.stack(Ms).astype(np.float32)


def _norm_inputs(seed, B=2, N=5, n0=3, frame=64, patch=16, C=4):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (2, B, frame, frame, C)).astype(np.float32)
    M = np.stack([_homographies(rng, N, frame, patch) for _ in range(B)])
    valid = np.ones((B, N), np.float32)
    valid[0, 1] = 0.0
    return src, M, valid, n0, (patch, patch)


def _composite_inputs(seed, B=2, N=5, frame=64, patch=32):
    rng = np.random.default_rng(seed)
    srcs = rng.uniform(0, 1, (B, N, 4, patch, patch)).astype(np.float32)
    srcs[:, :, 3] = (srcs[:, :, 3] > 0.35).astype(np.float32)  # blobby masks: real erosion edges
    M = np.stack([_homographies(rng, N, frame, patch, to_patch=False) for _ in range(B)])
    valid = np.ones((B, N), np.float32)
    valid[1, 2] = 0.0
    return srcs, M, valid, (frame, frame)


def _denorm_inputs(seed, B=2, N=4, C=4, frame=64, patch=16):
    """Patches [B, N, C, patch, patch] and patch->frame homographies: random
    quads, plus in sample 0 a part whose quad lies far off the frame and a
    degenerate one (a perspective whose horizon crosses the frame, so the
    denominator changes sign there); part 2 of sample 1 is invalid."""
    rng = np.random.default_rng(seed)
    srcs = rng.uniform(0, 1, (B, N, C, patch, patch)).astype(np.float32)
    M = np.stack([_homographies(rng, N, frame, patch, to_patch=False) for _ in range(B)])
    M[0, 1, :2, 2] += 10.0 * frame  # far off
    M[0, 3] = M[0, 3] @ np.array([[1, 0, 0], [0, 1, 0], [0.05, -0.12, 1]], np.float32)  # degenerate
    valid = np.ones((B, N), np.float32)
    valid[1, 2] = 0.0
    return srcs, M.astype(np.float32), valid, (frame, frame)


def _denorm_args(seed, device):
    srcs, M, valid, hw = _denorm_inputs(seed)
    return (torch.from_numpy(srcs).to(device), inv3x3(torch.from_numpy(M)).to(device).contiguous(),
            torch.from_numpy(valid).to(device), hw)


def _norm_args(seed, device, C=4):
    src, M, valid, n0, hw = _norm_inputs(seed, C=C)
    return (torch.from_numpy(src[0]).to(device), torch.from_numpy(src[1]).to(device),
            inv3x3(torch.from_numpy(M)).to(device).contiguous(), torch.from_numpy(valid).to(device), n0, hw)


def _composite_args(seed, device, hw=None):
    srcs, M, valid, frame_hw = _composite_inputs(seed)
    return (torch.from_numpy(srcs).to(device), inv3x3(torch.from_numpy(M)).to(device).contiguous(),
            torch.from_numpy(valid).to(device), hw or frame_hw, GROUPS, ERODE, HANDS)


def _norm_exact(args):
    before = ck.NORM_WARP.launches
    out = wk.norm_warp(*args)
    torch.cuda.synchronize()
    assert ck.NORM_WARP.launches == before + 1
    torch.testing.assert_close(out, wk.norm_warp_reference(*args), rtol=0, atol=0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed,C", [(0, 4), (1, 4), (0, 8)])
def test_norm_warp_kernel_matches_plain(cuda_device, seed, C):
    _norm_exact(_norm_args(seed, cuda_device, C))


# (16, 13): rows not a multiple of 4 but a plane that is, so the 16-byte
# stores cross rows; (7, 6) and (5, 1): planes that are not, the scalar-store
# path; every shape ends in a partial unit of 32 * kPass pixels
@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 8])
@pytest.mark.parametrize("hw", [(16, 13), (7, 6), (5, 1), (64, 64)])
def test_norm_warp_kernel_ragged_rows_bit_exact(cuda_device, hw, C):
    src0, src1, minv, valid, n0, _ = _norm_args(4, cuda_device, C)
    args = (src0, src1, minv, valid, n0, hw)
    out = _norm_exact(args)
    # the same launch into an output at an odd element offset (not 16-byte
    # aligned): the scalar-store path at every shape
    buf = torch.full((out.numel() + 1,), float("nan"), device=cuda_device)
    odd = buf[1:].view(out.shape)
    B, H, W, _ = src0.shape
    before = ck.NORM_WARP.launches
    ck.NORM_WARP.launch(src0.data_ptr(), src1.data_ptr(), minv.data_ptr(), valid.data_ptr(), odd.data_ptr(),
                        B, minv.shape[1], n0, H, W, hw[0], hw[1], C, src0.device)
    torch.cuda.synchronize()
    assert ck.NORM_WARP.launches == before + 1
    torch.testing.assert_close(odd, out, rtol=0, atol=0)
    assert bool(buf[0].isnan()), "the kernel wrote before its output"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 8])
@pytest.mark.parametrize("case", ["n0=0", "n0=N", "N=1", "invalid sample"])
def test_norm_warp_kernel_part_split_and_invalid_bit_exact(cuda_device, case, C):
    src0, src1, minv, valid, n0, hw = _norm_args(5, cuda_device, C)
    N = minv.shape[1]
    if case == "n0=0":
        n0 = 0
    elif case == "n0=N":
        n0 = N
    elif case == "N=1":
        minv, valid = minv[:, 3:4].contiguous(), valid[:, 3:4].contiguous()
    else:
        valid = valid.clone()
        valid[1] = 0.0
    out = _norm_exact((src0, src1, minv, valid, n0, hw))
    if case == "invalid sample":
        assert not out[1].any(), "an invalid sample must give all-zero patches"


@pytest.mark.cuda
def test_norm_warp_kernel_many_planes(cuda_device):
    """65 537 (sample, part) planes of 2x2 pixels from 2x2 frames: more planes
    than one grid dimension of 65 535 blocks would hold."""
    rng = np.random.default_rng(6)
    B, N, C = 65537, 1, 4
    src = rng.uniform(0, 1, (2, B, 2, 2, C)).astype(np.float32)
    minv = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    minv[..., :2, :] += rng.uniform(-0.7, 0.7, (B, N, 2, 3)).astype(np.float32)
    minv[..., 2, :2] = rng.uniform(-0.05, 0.05, (B, N, 2)).astype(np.float32)
    valid = (rng.uniform(size=(B, N)) > 0.1).astype(np.float32)
    args = (torch.from_numpy(src[0]).to(cuda_device), torch.from_numpy(src[1]).to(cuda_device),
            torch.from_numpy(minv).to(cuda_device), torch.from_numpy(valid).to(cuda_device), 0, (2, 2))
    _norm_exact(args)
    _norm_exact(args[:4] + (1, (2, 2)))  # every part from src0


# (64, 64): whole 32x32 tiles; (72, 40): ragged tiles on both axes, so the
# erosion halo crosses partial tiles and the frame edge
@pytest.mark.cuda
@pytest.mark.parametrize("seed,hw", [(0, None), (3, None), (0, (72, 40))])
def test_composite_kernel_matches_plain(cuda_device, seed, hw):
    args = _composite_args(seed, cuda_device, hw)
    before = ck.COMPOSITE.launches
    g, h = wk.composite(*args)
    torch.cuda.synchronize()
    assert ck.COMPOSITE.launches == before + 1
    g_p, h_p = wk.composite_reference(*args)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), atol=TOL)
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("border", ["constant", "replicate"])
@pytest.mark.parametrize("seed", [0, 1])
def test_denorm_warp_kernel_matches_plain(cuda_device, seed, border):
    args = _denorm_args(seed, cuda_device)
    before = ck.DENORM_WARP.launches
    out = wk.denorm_warp(*args, border)
    torch.cuda.synchronize()
    assert ck.DENORM_WARP.launches == before + 1
    ref = wk.denorm_warp_reference(*args, border)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=TOL)
    assert not out[1, 2].any(), "an invalid part must give an all-zero plane"


def _denorm_exact(args, border):
    before = ck.DENORM_WARP.launches
    out = wk.denorm_warp(*args, border)
    torch.cuda.synchronize()
    assert ck.DENORM_WARP.launches == before + 1
    torch.testing.assert_close(out, wk.denorm_warp_reference(*args, border), rtol=0, atol=0)
    return out


# frames whose width is not a multiple of 4 take the scalar-store path with a
# ragged last quad of each row
@pytest.mark.cuda
@pytest.mark.parametrize("border", ["constant", "replicate"])
@pytest.mark.parametrize("frame,hw", [(256, (256, 190)), (64, (72, 41))])
def test_denorm_warp_kernel_ragged_rows_bit_exact(cuda_device, frame, hw, border):
    srcs, M, valid, _ = _denorm_inputs(2, frame=frame)
    args = (torch.from_numpy(srcs).to(cuda_device), inv3x3(torch.from_numpy(M)).to(cuda_device).contiguous(),
            torch.from_numpy(valid).to(cuda_device), hw)
    _denorm_exact(args, border)


@pytest.mark.cuda
@pytest.mark.parametrize("border", ["constant", "replicate"])
def test_denorm_warp_kernel_one_part_and_an_invalid_sample(cuda_device, border):
    srcs, minv, valid, hw = _denorm_args(3, cuda_device)
    one = (srcs[:, 2:3].contiguous(), minv[:, 2:3].contiguous(), valid[:, 2:3].contiguous(), hw)
    _denorm_exact(one, border)
    valid = valid.clone()
    valid[0] = 0.0
    out = _denorm_exact((srcs, minv, valid, hw), border)
    assert not out[0].any(), "an invalid sample must give all-zero planes"


@pytest.mark.parametrize("kernel", ["norm_warp", "composite", "denorm_warp"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(kernel):
    before = {k.name: k.launches for k in ck.KERNELS.values()}
    if kernel == "norm_warp":
        args = _norm_args(0, "cpu", C=8)
        torch.testing.assert_close(wk.norm_warp(*args), wk.norm_warp_reference(*args), rtol=0, atol=0)
    elif kernel == "denorm_warp":
        args = _denorm_args(0, "cpu")
        for border in ("constant", "replicate"):
            torch.testing.assert_close(wk.denorm_warp(*args, border), wk.denorm_warp_reference(*args, border),
                                       rtol=0, atol=0)
    else:
        args = _composite_args(0, "cpu")
        for a, b in zip(wk.composite(*args), wk.composite_reference(*args)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert {k.name: k.launches for k in ck.KERNELS.values()} == before


@pytest.mark.parametrize("current", [0, 1])
def test_launch_makes_the_tensors_device_current(monkeypatch, current):
    """`CudaKernel.launch` runs the C entry point on the current stream of the
    device it is given, with that device current: CUDA refuses a launch into
    a stream of another device, which `--dp` serving over several cards
    would otherwise make (chunk r runs on cuda:r while cuda:0 is current).
    The CUDA calls are stood in for, so this runs without a card."""
    calls, guards = [], []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            guards.append(self.device)

        def __exit__(self, *exc):
            guards.append(None)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(ck, "stream_of", lambda device: 7000 + device.index)
    kernel = ck.CudaKernel("probe", "probe.cu", "probe", [])
    monkeypatch.setattr(kernel, "_function", lambda: lambda *a: calls.append((a, list(guards))) or 0)
    kernel.launch(3, 4, torch.device("cuda", 1))
    assert calls == [((3, 4, 7001), [] if current == 1 else [torch.device("cuda", 1)])]
    assert guards == ([] if current == 1 else [torch.device("cuda", 1), None]) and kernel.launches == 1
    monkeypatch.setattr(kernel, "_function", lambda: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.launch(torch.device("cuda", 0))
    assert kernel.launches == 1


def test_kernel_wrappers_reject_bad_cuda_inputs_without_a_card():
    """A wrapper given a tensor that is neither CPU nor CUDA raises; it never
    falls back."""
    src = torch.zeros((1, 8, 8, 4), device="meta")
    with pytest.raises(ValueError):
        wk.norm_warp(src, src, torch.zeros((1, 2, 3, 3), device="meta"), torch.zeros((1, 2), device="meta"), 1, (4, 4))
    srcs = torch.zeros((1, 2, 4, 8, 8), device="meta")
    with pytest.raises(ValueError):
        wk.composite(srcs, torch.zeros((1, 2, 3, 3), device="meta"), torch.zeros((1, 2), device="meta"),
                     (16, 16), (0, 1), (True, False), (1,))
    with pytest.raises(ValueError):
        wk.denorm_warp(srcs, torch.zeros((1, 2, 3, 3), device="meta"), torch.zeros((1, 2), device="meta"), (16, 16))
    with pytest.raises(ValueError):  # an unknown border, on any device
        wk.denorm_warp(*_denorm_args(0, "cpu"), border="reflect")


@pytest.mark.cuda
def test_kernel_wrappers_check_cuda_inputs(cuda_device):
    src0, src1, minv, valid, n0, hw = _norm_args(0, cuda_device)
    for bad in (src0.double(), src0.transpose(1, 2), src0[:, :, :, :3].contiguous()):
        with pytest.raises(ValueError):
            wk.norm_warp(bad, src1, minv, valid, n0, hw)
    with pytest.raises(ValueError):
        wk.norm_warp(src0, src1, minv.cpu(), valid, n0, hw)
    srcs, cminv, cvalid, frame_hw, groups, erode, hands = _composite_args(0, cuda_device)
    with pytest.raises(ValueError):
        wk.composite(srcs, cminv, cvalid, frame_hw, groups, erode, (3, 1))  # hand parts out of order
    with pytest.raises(ValueError):
        wk.composite(srcs.half(), cminv, cvalid, frame_hw, groups, erode, hands)
    with pytest.raises(ValueError):  # 6 channels: the norm kernel takes 4 or 8
        wk.norm_warp(src0[..., :2].repeat(1, 1, 1, 3).contiguous(), src1[..., :2].repeat(1, 1, 1, 3).contiguous(),
                     minv, valid, n0, hw)
    dsrcs, dminv, dvalid, dhw = _denorm_args(0, cuda_device)
    for bad in (dsrcs.double(), dsrcs.transpose(3, 4)):
        with pytest.raises(ValueError):
            wk.denorm_warp(bad, dminv, dvalid, dhw)
    with pytest.raises(ValueError):
        wk.denorm_warp(dsrcs, dminv.cpu(), dvalid, dhw)


# ------------------------------------------------------------------ up2 / down2

FIR_F32_TOL = 1e-6
BF16_REL = 2.0 ** -7  # 2 ulp of bf16's 8-bit mantissa
# every block size of the 256px G and D, and an odd one
FIR_SIZES = (4, 5, 8, 16, 32, 64, 128, 256)


def _fir_input(seed, shape, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device=device, dtype=dtype)


def _fir_close(a, b, dtype):
    a, b = a.float().cpu(), b.float().cpu()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(a, b, rtol=BF16_REL, atol=BF16_REL * float(b.abs().max()) * 2 ** -8)
    else:
        torch.testing.assert_close(a, b, rtol=0, atol=FIR_F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("size", FIR_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_kernels_match_plain(cuda_device, size, dtype):
    channels = max(1, 2048 // (size * size))
    x = _fir_input(size, (2, channels, size, size + 2), dtype, cuda_device)
    for extend in (0, 1):
        before = ck.UP2.launches
        y = uk.up2(x, extend=extend)
        torch.cuda.synchronize()
        assert ck.UP2.launches == before + 1
        assert y.dtype == dtype and y.shape[2:] == (2 * size + 2 * extend, 2 * size + 4 + 2 * extend)
        _fir_close(y, uk.up2_reference(x, extend), dtype)
    if size % 2 == 0:
        for pad in (0, 1):
            before = ck.DOWN2.launches
            y = uk.down2(x, pad=pad, gain=4.0)
            torch.cuda.synchronize()
            assert ck.DOWN2.launches == before + 1
            _fir_close(y, uk.down2_reference(x, pad, 4.0), dtype)


def _odd_offset_view(x):
    """The same values, contiguous, starting one element past an aligned base."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % (2 * x.element_size())  # not aligned to a pair
    return view


# up2 indexes its output as flat 16-byte chunks: a flat size that is not a
# multiple of 8 leaves a ragged last chunk, rows narrower than a chunk make
# chunks cross row and plane ends, rows shorter than a thread's unit of 16
# bf16 or 8 fp32 outputs take the one-thread-per-output kernel, and an input
# at an odd element offset (or an odd width) cannot take the paired loads
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,extend,shape", [
    ("ragged end", 0, (1, 3, 5, 7)),  # 3 x 10 x 14 = 420 outputs
    ("ragged end", 1, (1, 3, 4, 6)),  # 3 x 10 x 14 = 420 outputs
    ("one plane", 0, (1, 1, 16, 10)),
    ("one plane", 1, (1, 1, 16, 10)),
    ("narrow rows", 0, (2, 3, 4, 6)),
    ("narrow rows", 1, (2, 3, 5, 7)),
    ("odd offset", 0, (2, 4, 8, 10)),
    ("odd offset", 1, (2, 4, 8, 10)),
    ("odd offset", 1, (1, 2, 3, 5)),
    ("short rows", 0, (2, 3, 4, 3)),  # rows of 6
    ("short rows", 1, (2, 3, 3, 2)),  # rows of 6
    ("short rows", 1, (2, 3, 4, 4)),  # rows of 10: short in bf16, not in fp32
    ("short rows", 1, (1, 2, 4, 4)),
])
def test_up2_kernel_flat_chunks_and_unaligned_inputs(cuda_device, case, extend, shape, dtype):
    x = _fir_input(7, shape, dtype, cuda_device)
    if case == "odd offset":
        x = _odd_offset_view(x)
    else:
        assert x.numel() and x.data_ptr() % 16 == 0
    before = ck.UP2.launches
    gain = 4.0 if case in ("one plane", "short rows") else 1.0
    y = uk.up2(x, extend=extend, gain=gain)
    torch.cuda.synchronize()
    assert ck.UP2.launches == before + 1
    ref = uk.up2_reference(x, extend, gain)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=0, atol=0)
    else:
        _fir_close(y, ref, dtype)


# down2 streams strips of 8 outputs (4 on rows of 4 to 7) over up to 16
# output rows with 16-byte, pair or element loads by the alignment of the rows
# and the pointer: rows of 2W + 2 (the pad-0 adjoint's, 4-byte aligned in
# bf16), output rows of 1, 2, 4 and 8, a ragged last strip and row chunk, and
# an input at an odd element offset.  Launches with fewer strip units than a
# quarter of the threads the card holds (and rows of 1 or 2) take one thread
# per output instead: each case runs with its few planes (that path) and with
# enough planes for the strips on any card of up to 132 SMs x 2048 threads.
STRIP_UNITS = 132 * 2048 // 4


def _many_planes(shape, pad):
    """`shape` with its channels raised until the strip kernel takes it."""
    N, C, H, W = shape
    Ho, Wo = H // 2 + pad - 1, W // 2 + pad - 1
    per_plane = Ho * -(-Wo // (8 if Wo >= 8 else 4))
    return (N, max(C, -(-STRIP_UNITS // (N * per_plane))), H, W)


DOWN2_CASES = [
    ("2W+2 rows", 0, (2, 3, 10, 18)),
    ("2W+2 rows", 1, (2, 3, 10, 18)),  # output rows of 9: a ragged last strip
    ("2W+2 rows", 0, (1, 2, 34, 34)),
    ("rows of 1", 1, (2, 3, 2, 2)),
    ("rows of 1", 0, (2, 3, 4, 4)),
    ("rows of 2", 1, (2, 3, 4, 4)),
    ("rows of 2", 0, (2, 3, 6, 6)),
    ("rows of 4", 1, (2, 5, 8, 8)),
    ("rows of 4", 0, (2, 5, 10, 10)),
    ("rows of 8", 1, (2, 3, 16, 16)),
    ("rows of 8", 0, (2, 3, 18, 18)),
    ("ragged flat end", 1, (1, 3, 6, 22)),
    ("ragged flat end", 0, (1, 3, 38, 24)),  # 18 output rows: a short last chunk
    ("odd offset", 1, (2, 4, 16, 16)),
    ("odd offset", 0, (2, 4, 18, 18)),
    ("odd offset", 1, (1, 2, 8, 10)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,pad,shape,planes", [
    (case, pad, shape, planes) for case, pad, shape in DOWN2_CASES for planes in ("few", "many")
    if planes == "few" or shape[3] // 2 + pad - 1 >= 4  # rows of 1 or 2 outputs: one thread per output always
])
def test_down2_kernel_strips_and_unaligned_inputs_bit_exact(cuda_device, case, pad, shape, dtype, planes):
    if planes == "many":
        shape = _many_planes(shape, pad)
    x = _fir_input(11, shape, dtype, cuda_device)
    if case == "odd offset":
        x = _odd_offset_view(x)
    before = ck.DOWN2.launches
    y = uk.down2(x, pad=pad)
    torch.cuda.synchronize()
    assert ck.DOWN2.launches == before + 1
    assert y.shape[2:] == (shape[2] // 2 + pad - 1, shape[3] // 2 + pad - 1)
    torch.testing.assert_close(y, uk.down2_reference(x, pad), rtol=0, atol=0)


# one plane large enough for the strips (544 output rows x 128 strips), with
# a gain; and a wide row whose 20 output rows end in a short chunk
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,shape,gain", [
    (1, (1, 1, 1088, 2048), 4.0),
    (0, (1, 1, 1090, 2050), 4.0),
    (1, (4, 400, 40, 256), 1.0),
])
def test_down2_kernel_one_plane_and_wide_rows_bit_exact(cuda_device, pad, shape, gain, dtype):
    x = _fir_input(12, shape, dtype, cuda_device)
    y = uk.down2(x, pad=pad, gain=gain)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, uk.down2_reference(x, pad, gain), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", (4, 8, 64))
def test_fir_kernels_adjoint_and_double_backward_on_card(cuda_device, size):
    """<up2(x), g> = <x, 4 down2(g)> on the card, and the first and second
    derivatives (R1's) equal the CPU's, which run the plain versions."""
    x = _fir_input(1, (2, 3, size, size))
    for extend in (0, 1):
        g = _fir_input(2, (2, 3, 2 * size + 2 * extend, 2 * size + 2 * extend))
        xc, gc = x.to(cuda_device), g.to(cuda_device)
        lhs = float((uk.up2(xc, extend) * gc).double().sum())
        rhs = float((xc * uk.down2(gc, 1 - extend, 4.0)).double().sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs) + 1e-4

        def second(dev):
            xi = x.to(dev).requires_grad_(True)
            w = _fir_input(3, (2, 3, size, size)).to(dev)
            y = uk.down2(uk.up2(xi, extend) * g.to(dev), pad=1 - extend)
            (gx,) = torch.autograd.grad((y * y).sum(), xi, create_graph=True)
            (ggx,) = torch.autograd.grad((gx * w).sum(), xi)
            return gx.detach().cpu(), ggx.cpu()

        for a, b in zip(second(cuda_device), second("cpu")):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fir_wrappers_on_cpu_take_the_plain_version_and_refuse_other_devices():
    x = _fir_input(0, (1, 2, 8, 8))
    before = ck.launch_counts()
    torch.testing.assert_close(uk.up2(x, 1), uk.up2_reference(x, 1), rtol=0, atol=0)
    torch.testing.assert_close(uk.down2(x, 1), uk.down2_reference(x, 1), rtol=0, atol=0)
    assert ck.launch_counts() == before
    meta = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        uk.up2(meta)
    with pytest.raises(ValueError):
        uk.down2(meta)
    with pytest.raises(ValueError):
        uk.down2(torch.zeros((1, 1, 5, 6)))
    with pytest.raises(ValueError):
        uk.up2(x, extend=2)


@pytest.mark.cuda
def test_fir_wrappers_check_cuda_inputs(cuda_device):
    x = _fir_input(0, (1, 2, 8, 8), device=cuda_device)
    with pytest.raises(ValueError):
        uk.up2(x.double())
    with pytest.raises(ValueError):
        uk.down2(x.half())
    with pytest.raises(ValueError):
        uk.down2(x[:, :, :7, :6])


def test_registry_holds_every_kernel_once():
    assert sorted(ck.KERNELS) == ["composite", "denorm_warp", "down2", "int8_conv", "norm_warp", "quantize_pack", "up2"]
    for k in ck.KERNELS.values():
        assert os.path.exists(k.source_path), k.source


@pytest.mark.cuda
def test_routing_kernels_on_real_fixture_pairs(cuda_device):
    """norm_warp (bit for bit) and composite (TOL, pixels near the saturation
    threshold left out) on the routing operands of real test pairs, decoded
    from tests/fixtures/upt_mini by the port alone."""
    from pasta_gan_tpu_torch.data import dataset as tds

    ds = tds.UvitonDataset256Test(os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "upt_mini"))
    pairs = [ds[i] for i in range(8)]
    r = tds.tryon_warp_inputs(tds.collate([p["person"] for p in pairs]), tds.collate([p["garment"] for p in pairs]),
                              device=cuda_device)
    patches = _norm_exact((r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"]))
    cargs = (patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"], r["groups"], r["erode_parts"],
             r["hand_parts"])
    g, h = wk.composite(*cargs)
    g_p, h_p = wk.composite_reference(*cargs)
    m = wk.denorm_warp_reference(patches, r["minv_denorm"], r["valid_denorm"], r["frame_hw"])[:, :, 3]
    near = ((m - wk.MASK_SATURATION_THRESHOLD).abs() <= 1e-5).float()
    ero = [p for p, e in enumerate(r["erode_parts"]) if e]
    near[:, ero] = torch.nn.functional.max_pool2d(near[:, ero], 5, stride=1, padding=2)
    keep = (near.amax(dim=1) == 0).float()
    assert float(((g - g_p).abs() * keep[:, None, None]).max()) <= TOL
    assert float(((h - h_p).abs() * keep[:, None]).max()) <= TOL


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ renames the library of every source, so a
    stale build is never loaded."""
    for name in ("composite.cu", "warp_math.cuh"):
        (tmp_path / name).write_bytes(open(os.path.join(ck.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(ck, "CSRC_DIR", str(tmp_path))
    before = ck.COMPOSITE.library_path()
    with open(tmp_path / "warp_math.cuh", "a") as f:
        f.write("// edited\n")
    assert ck.COMPOSITE.library_path() != before


# ------------------------------------------------------- composite tile skipping

def _affine_minv(ox, oy, s):
    """frame -> patch map (x, y) -> ((x - ox) / s, (y - oy) / s): the part's
    support (-1, Ws) in x is the frame interval (ox - s, ox + s Ws)."""
    return np.array([[1 / s, 0, -ox / s], [0, 1 / s, -oy / s], [0, 0, 1]], np.float32)


def _tile_case(case, seed=0, frame=256, patch=32):
    """Composite operands on a 256x256 frame (32x32 tiles) where the kernel
    skips (part, tile) pairs: (srcs, minv [B, N, 3, 3], valid, hw, groups,
    erode_parts, hand_parts), numpy."""
    rng = np.random.default_rng(seed)
    B, N = 2, 5
    srcs = rng.uniform(0, 1, (B, N, 4, patch, patch)).astype(np.float32)
    srcs[:, :, 3] = (srcs[:, :, 3] > 0.25).astype(np.float32)
    groups, erode, hands = (0, 0, 0, 1, 1), (True, True, False, False, True), (1, 3)
    minv = np.zeros((B, N, 3, 3), np.float32)
    valid = np.ones((B, N), np.float32)
    if case in ("small quads", "hand skipped"):
        # quads of 13-29 pixels (a 64-pixel frame's) placed at random in the 256 frame
        for b in range(B):
            M = _homographies(rng, N, 64, patch, to_patch=False)
            for p in range(N):
                T = np.array([[1, 0, rng.uniform(-20, 200)], [0, 1, rng.uniform(-20, 200)], [0, 0, 1]])
                minv[b, p] = np.linalg.inv(T @ M[p]).astype(np.float32)
        valid[1, 3] = 0.0  # an invalid hand part
    elif case == "tile edges":
        # support edges within a pixel of the tile edge x = 32 or y = 64 (s = 0.5:
        # support (ox - 0.5, ox + 16)): right edge 32.25 / 31.75, left edge
        # 30.9975 (pixel 31, the last of tile 0, samples at -0.995), bottom edge
        # 64.1 / 63.9
        offs = [(16.25, 100.0), (15.75, 130.0), (31.4975, 40.0), (150.0, 48.1), (180.0, 47.9)]
        for b in range(B):
            for p, (ox, oy) in enumerate(offs):
                minv[b, p] = _affine_minv(ox + 64 * b, oy, 0.5)
    elif case == "erosion halo":
        # eroded parts whose support ends 1-2 pixels before a tile edge, so the
        # next tile sees them only through its 2-pixel erosion halo
        offs = [(15.75, 10.0), (200.0, 15.9), (79.0, 150.0), (120.0, 220.0), (40.5, 180.0)]
        for b in range(B):
            for p, (ox, oy) in enumerate(offs):
                minv[b, p] = _affine_minv(ox, oy + 32 * b, 0.5)
        srcs[:, :, 3] = 1.0  # saturated wherever the sample is inside
        erode = (True, True, True, False, True)
    elif case == "far and horizon":
        d_srcs, M, valid4, _ = _denorm_inputs(seed, B=B, N=4, frame=frame, patch=patch)
        srcs, valid = d_srcs, valid4
        minv = inv3x3(torch.from_numpy(M)).numpy()
        groups, erode, hands = (0, 1, 0, 1), (True, True, False, True), (1, 3)
    else:
        raise ValueError(case)
    return srcs, minv, valid, (frame, frame), groups, erode, hands


def _pixels_inside_support(minv, valid, hw, patch_hw):
    """[B, N, H, W] bool: the pixels whose fp32 sample coordinates (the
    kernel's) fall inside the support (-1, Ws) x (-1, Hs) of a valid part."""
    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    Hs, Ws = patch_hw
    sx, sy = warp_coords(minv, hw)
    return (valid != 0)[..., None, None] & (sx > -1) & (sx < Ws) & (sy > -1) & (sy < Hs)


def _tile_map(live, hw, tile=wk.COMPOSITE_STRIP):
    """[..., ty, tx] -> [..., H, W]: each pixel's strip's value."""
    H, W = hw
    return live.repeat_interleave(tile[0], -2).repeat_interleave(tile[1], -1)[..., :H, :W]


@pytest.mark.parametrize("case", ["small quads", "tile edges", "erosion halo", "far and horizon", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_composite_live_tiles_keep_every_pixel_that_samples(case, seed):
    """The skip test never drops a (part, strip) pair where a pixel of the
    strip samples the part; and it does drop some."""
    if case == "random":
        srcs, M, valid, hw = _denorm_inputs(seed, B=4, N=6, frame=96, patch=16)
        minv = inv3x3(torch.from_numpy(M))
        # stretch some maps so that quads reach 10x beyond the frame or shrink to a pixel
        scale = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 10, (4, 6))).float()
        minv = (minv * torch.stack([scale, scale, torch.ones_like(scale)], -1)[..., None]).contiguous()
        patch_hw = (16, 16)
    else:
        srcs, minv, valid, hw, *_ = _tile_case(case, seed)
        minv = torch.from_numpy(minv)
        patch_hw = srcs.shape[-2:]
    valid = torch.from_numpy(valid)
    live = wk.composite_live_tiles(minv, valid, hw, patch_hw)
    th, tw = wk.COMPOSITE_STRIP
    assert live.shape == minv.shape[:2] + (-(-hw[0] // th), -(-hw[1] // tw))
    inside = _pixels_inside_support(minv, valid, hw, patch_hw)
    assert not (inside & ~_tile_map(live, hw)).any(), "a skipped tile holds a pixel that samples the part"
    assert not live.all(), "nothing skipped: the case tests nothing"


def _composite_exact(args):
    before = ck.COMPOSITE.launches
    g, h = wk.composite(*args)
    torch.cuda.synchronize()
    assert ck.COMPOSITE.launches == before + 1
    g_p, h_p = wk.composite_reference(*args)
    torch.testing.assert_close(g, g_p, rtol=0, atol=0)
    torch.testing.assert_close(h, h_p, rtol=0, atol=0)
    return g, h


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small quads", "tile edges", "erosion halo", "far and horizon"])
def test_composite_kernel_skipped_tiles_bit_exact(cuda_device, case):
    srcs, minv, valid, hw, groups, erode, hands = _tile_case(case)
    args = (torch.from_numpy(srcs).to(cuda_device), torch.from_numpy(minv).to(cuda_device).contiguous(),
            torch.from_numpy(valid).to(cuda_device), hw, groups, erode, hands)
    live = wk.composite_live_tiles(args[1], args[2], hw, srcs.shape[-2:])
    assert not live.all()
    _composite_exact(args)


@pytest.mark.cuda
def test_composite_kernel_skipped_hand_part_writes_zero(cuda_device):
    srcs, minv, valid, hw, groups, erode, hands = _tile_case("hand skipped", seed=4)
    args = (torch.from_numpy(srcs).to(cuda_device), torch.from_numpy(minv).to(cuda_device).contiguous(),
            torch.from_numpy(valid).to(cuda_device), hw, groups, erode, hands)
    live = wk.composite_live_tiles(args[1], args[2], hw, srcs.shape[-2:])
    hand_live = _tile_map(live[:, list(hands)], hw)  # [B, n_hands, H, W]
    assert not hand_live.all() and hand_live.any()
    _, h = _composite_exact(args)
    assert not h[~hand_live].any(), "a skipped hand part must leave a zero mask"
    assert not h[1, 1].any(), "an invalid hand part must leave a zero mask"


# ------------------------------------------------------------------ int8_conv

# (N, C, O, k, H, W, stride, (top, bottom, left, right), dilation): the generators' classes, and ragged
# pixel / channel / K tails (O not a multiple of 64, C not a multiple of 4, K past one 64-byte step)
INT8_CASES = {
    "3x3": (2, 64, 64, 3, 16, 16, 1, (1, 1, 1, 1), 1),
    "3x3_ragged": (3, 37, 70, 3, 13, 9, 1, (1, 1, 1, 1), 1),
    "1x1_6ch": (2, 6, 64, 1, 20, 20, 1, (0, 0, 0, 0), 1),
    "7x7_3ch": (2, 3, 64, 7, 24, 24, 1, (3, 3, 3, 3), 1),
    "3x3_stride2": (2, 64, 128, 3, 33, 33, 2, (0, 0, 0, 0), 1),
    "1x1_stride2": (2, 64, 128, 1, 31, 31, 2, (0, 0, 0, 0), 1),
    "6x6_dilation2": (2, 32, 48, 6, 12, 10, 1, (3, 3, 3, 3), 2),
    "3x3_512": (1, 512, 64, 3, 8, 8, 1, (1, 1, 1, 1), 1),
    "3x3_c40_o200": (2, 40, 200, 3, 11, 13, 1, (1, 1, 1, 1), 1),
    # more tiles than SMs (the persistent walk), tile widths 64, 128 and 256, the folded up-conv's phases
    "3x3_64_many_tiles": (2, 64, 64, 3, 128, 128, 1, (1, 1, 1, 1), 1),
    "3x3_128_many_tiles": (2, 128, 128, 3, 96, 96, 1, (1, 1, 1, 1), 1),
    "1x1_512_to_256": (2, 512, 256, 1, 24, 24, 1, (0, 0, 0, 0), 1),
    "3x3_256_to_512_tiny": (3, 256, 512, 3, 4, 4, 1, (1, 1, 1, 1), 1),
    "6x6_dilation2_128_to_64": (2, 128, 64, 6, 24, 20, 1, (3, 3, 3, 3), 2),
    "3x3_stride2_odd": (2, 96, 136, 3, 65, 63, 2, (0, 0, 0, 0), 1),
    # the activation tile by TMA (stride 1, C a multiple of 128, tiles that are boxes of the input): rows of a
    # sample, boxes across samples with a ragged last one, a row wider than a tile, the folded up-conv's phases
    "3x3_128_tma_rows": (2, 128, 128, 3, 64, 64, 1, (1, 1, 1, 1), 1),
    "3x3_384_tma_samples": (3, 384, 128, 3, 8, 8, 1, (1, 1, 1, 1), 1),
    "1x1_256_tma_wide_row": (1, 256, 128, 1, 4, 512, 1, (0, 0, 0, 0), 1),
    "6x6_dilation2_tma": (2, 128, 64, 6, 16, 16, 1, (3, 3, 3, 3), 2),
    # channels in 64s (64-byte K steps where the tile is a box)
    "1x1_192_tma": (2, 192, 128, 1, 16, 16, 1, (0, 0, 0, 0), 1),
    "3x3_320_to_256_tma": (3, 320, 256, 3, 8, 8, 1, (1, 1, 1, 1), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["per_sample", "scalar"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_conv_kernel_bit_exact(cuda_device, case, out, scale):
    from pasta_gan_tpu_torch.ops import quant as tq

    N, C, O, k, H, W, stride, (pt, pb, pl, pr), dil = INT8_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(len(case))
    xq = torch.randint(-127, 128, (N, C, H, W), generator=g, device=cuda_device, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, C, k, k), generator=g, device=cuda_device, dtype=torch.int8)
    sx = (torch.rand((N, 1, 1, 1) if scale == "per_sample" else (), generator=g, device=cuda_device) * 0.1)
    sw = torch.rand(O, generator=g, device=cuda_device) * 0.01
    before = ck.INT8_CONV.launches
    y = tq.int8_conv(xq, wq, sx, sw, stride, ((pt, pb), (pl, pr)), dil, out)
    assert ck.INT8_CONV.launches == before + 1
    yp = tq.int8_conv_reference(xq, wq, sx, sw, stride, ((pt, pb), (pl, pr)), dil, out)
    torch.cuda.synchronize()
    assert y.dtype == out and y.shape == yp.shape
    torch.testing.assert_close(y, yp, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_int8_conv_packed_kernel_bit_exact(cuda_device, out):
    """The served path: a float activation through quantize_pack and a
    float weight through pack_weight, then int8_conv_packed, against the
    plain version on the same int8 operands."""
    from pasta_gan_tpu_torch.ops import quant as tq

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4, 72, 33, 35, generator=g, device=cuda_device).to(out)
    w = torch.randn(136, 72, 3, 3, generator=g, device=cuda_device)
    xa = tq.quantize_activation(x)
    pw = tq.pack_weight(w, ((1, 1), (1, 1)))
    before = ck.INT8_CONV.launches
    y = tq.int8_conv_packed(xa, pw, out)
    assert ck.INT8_CONV.launches == before + 1
    yp = tq.int8_conv_reference(xa.nchw(), pw.wq, xa.scale, pw.sw, 1, ((1, 1), (1, 1)), 1, out)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, rtol=0, atol=0)


# (N, C, H, W): aligned planes, 6 and 3 channels (one 16-byte piece), a ragged plane of odd length, 576 channels,
# a plane shorter than a block and one of 257 x 257
QUANTIZE_CASES = {"aligned": (2, 128, 16, 16), "6ch": (2, 6, 20, 20), "3ch": (3, 3, 9, 7), "ragged": (3, 37, 13, 9),
                  "576ch": (1, 576, 8, 8), "short": (5, 40, 3, 5), "257": (2, 64, 257, 257)}


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["per_sample", "scalar", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(QUANTIZE_CASES))
def test_quantize_pack_kernel_bit_exact(cuda_device, case, dtype, scale):
    """quantize_pack against its plain version (quantize_act_with_scale, then
    NHWC and the pad) to the bit; "ties" puts x / s on k + 0.5 and past
    +-127 (round half to even, the clamp)."""
    from pasta_gan_tpu_torch.ops import quant as tq

    N, C, H, W = QUANTIZE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(len(case))
    if scale == "ties":
        x = (torch.randint(-300, 300, (N, C, H, W), generator=g, device=cuda_device) + 0.5).to(dtype)
        s = torch.ones((), device=cuda_device)
    else:
        x = (torch.randn(N, C, H, W, generator=g, device=cuda_device) * 3).to(dtype)
        s = tq.per_sample_scale(x) if scale == "per_sample" else torch.tensor(0.0123, device=cuda_device)
    before = ck.QUANTIZE_PACK.launches
    q = tq.quantize_pack(x, s)
    assert ck.QUANTIZE_PACK.launches == before + 1
    qp = tq.quantize_pack_reference(x, s)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == qp.shape == (N, H, W, -(-C // 16) * 16)
    assert torch.equal(q, qp)


@pytest.mark.cuda
def test_quantize_pack_kernel_unaligned_input_bit_exact(cuda_device):
    """An activation whose storage starts 2 bytes past a 16-byte boundary
    takes the kernel's scalar loads."""
    from pasta_gan_tpu_torch.ops import quant as tq

    g = torch.Generator(device=cuda_device).manual_seed(9)
    base = torch.randn(2 * 48 * 32 * 32 + 1, generator=g, device=cuda_device).to(torch.bfloat16)
    x = base[1:].view(2, 48, 32, 32)
    assert x.data_ptr() % 16 == 2
    s = tq.per_sample_scale(x)
    torch.testing.assert_close(tq.quantize_pack(x, s), tq.quantize_pack_reference(x, s), rtol=0, atol=0)


def test_int8_conv_refuses_what_the_kernel_does_not_take():
    from pasta_gan_tpu_torch.ops import quant as tq

    xq = torch.zeros(1, 4, 6, 6, dtype=torch.int8)
    wq = torch.zeros(2, 4, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="out_dtype"):
        tq.int8_conv(xq, wq, torch.ones(()), torch.ones(2), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="stride 1"):
        tq._int8_conv_kernel(xq, wq, torch.ones(()), torch.ones(2), 2, ((1, 1), (1, 1)), 2, torch.float32)
    with pytest.raises(ValueError, match="scale"):
        tq._int8_conv_kernel(xq, wq, torch.ones(3), torch.ones(2), 1, ((1, 1), (1, 1)), 1, torch.float32)
