"""The port's two CUDA routing kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a machine with an NVIDIA GPU
and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest` because tests/conftest.py sets up JAX).  Without a card the
`cuda` tests skip; the numpy input makers here are shared with
tests/test_torch_routing.py, which holds the plain versions against JAX.

Tolerance atol 5e-5.  The composite inputs are seeds whose mask values keep
farther than 1e-5 from 254.5/255 (tests/test_torch_routing.py asserts it),
so every pixel is compared.
"""

import numpy as np
import pytest
import torch

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


def _norm_inputs(seed, B=2, N=5, n0=3, frame=64, patch=16):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (2, B, frame, frame, 4)).astype(np.float32)
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


def _norm_args(seed, device):
    src, M, valid, n0, hw = _norm_inputs(seed)
    return (torch.from_numpy(src[0]).to(device), torch.from_numpy(src[1]).to(device),
            inv3x3(torch.from_numpy(M)).to(device).contiguous(), torch.from_numpy(valid).to(device), n0, hw)


def _composite_args(seed, device, hw=None):
    srcs, M, valid, frame_hw = _composite_inputs(seed)
    return (torch.from_numpy(srcs).to(device), inv3x3(torch.from_numpy(M)).to(device).contiguous(),
            torch.from_numpy(valid).to(device), hw or frame_hw, GROUPS, ERODE, HANDS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_norm_warp_kernel_matches_plain(cuda_device, seed):
    args = _norm_args(seed, cuda_device)
    before = wk.NORM_WARP.launches
    out = wk.norm_warp(*args)
    torch.cuda.synchronize()
    assert wk.NORM_WARP.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), wk.norm_warp_reference(*args).cpu().numpy(), atol=TOL)


# (64, 64): whole 32x32 tiles; (72, 40): ragged tiles on both axes, so the
# erosion halo crosses partial tiles and the frame edge
@pytest.mark.cuda
@pytest.mark.parametrize("seed,hw", [(0, None), (3, None), (0, (72, 40))])
def test_composite_kernel_matches_plain(cuda_device, seed, hw):
    args = _composite_args(seed, cuda_device, hw)
    before = wk.COMPOSITE.launches
    g, h = wk.composite(*args)
    torch.cuda.synchronize()
    assert wk.COMPOSITE.launches == before + 1
    g_p, h_p = wk.composite_reference(*args)
    np.testing.assert_allclose(g.cpu().numpy(), g_p.cpu().numpy(), atol=TOL)
    np.testing.assert_allclose(h.cpu().numpy(), h_p.cpu().numpy(), atol=TOL)


@pytest.mark.parametrize("kernel", ["norm_warp", "composite"])
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(kernel):
    before = {k.name: k.launches for k in wk.KERNELS.values()}
    if kernel == "norm_warp":
        args = _norm_args(0, "cpu")
        torch.testing.assert_close(wk.norm_warp(*args), wk.norm_warp_reference(*args), rtol=0, atol=0)
    else:
        args = _composite_args(0, "cpu")
        for a, b in zip(wk.composite(*args), wk.composite_reference(*args)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert {k.name: k.launches for k in wk.KERNELS.values()} == before


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
