"""Keypoint quads -> perspective transforms for patch routing.

Counterpart of `pasta_gan_tpu/data/geometry.py` (the reference's `get_crop`):
each of 10 keypoint-anchored body parts defines a source quadrilateral; M
normalizes it into the canonical patch frame and M_inv re-projects it.
Vectorized over batch x parts with `torch.where` selects, and
`cv2.getPerspectiveTransform` as a batched 8x8 DLT solve.

`_solve8` is the JAX package's unrolled Gauss-Jordan with one-hot partial
pivoting, op for op, not `torch.linalg.solve`: another solver moves the
matrices by ulps, which moves sample coordinates and flips pixels next to the
mask saturation threshold downstream.
"""

from __future__ import annotations

import numpy as np
import torch

KEYPOINT_ORDER = [
    "cnose", "cneck", "rshoulder", "relbow", "rwrist", "lshoulder",
    "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
    "lankle", "reye", "leye", "rear", "lear",
]
_IDX = {name: i for i, name in enumerate(KEYPOINT_ORDER)}

BPARTS = [
    ["lshoulder", "lhip", "rhip", "rshoulder"],
    ["lshoulder", "rshoulder", "cnose"],
    ["lshoulder", "lelbow"],
    ["lelbow", "lwrist"],
    ["rshoulder", "relbow"],
    ["relbow", "rwrist"],
    ["lhip", "lknee"],
    ["lknee", "lankle"],
    ["rhip", "rknee"],
    ["rknee", "rankle"],
]
NUM_PARTS = len(BPARTS)
# Lower-body parts additionally route the lower garment.
LOWER_PART_START = 6
# Hand parts whose denorm masks are emitted beside the composite.
HAND_PARTS = (2, 3, 4, 5)

BPART_INDICES = np.array(
    [[_IDX[n] for n in part] + [_IDX[part[-1]]] * (4 - len(part)) for part in BPARTS],
    dtype=np.int64,
)  # [10, 4] padded with repeats
BPART_SIZES = np.array([len(p) for p in BPARTS], dtype=np.int64)

VALID_CONF = 0.1
DEFAULT_AR = 0.5


def _perp(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _segment_quad(a, b, alpha):
    """Box around segment a->b extruded by alpha * normal."""
    normal = _perp(b - a)
    return torch.stack(
        [a + alpha * normal, a - alpha * normal, b - alpha * normal, b + alpha * normal], dim=-2
    )


def part_quads(
    keypoints: torch.Tensor,  # [B, 18, 3] (x, y, confidence)
    img_h: int,
    pad_x: float = 32.0,
    ar: float = DEFAULT_AR,
    knee_fallbacks: bool = False,
):
    """Source quads for all 10 parts: (quads [B, 10, 4, 2], valid [B, 10] bool),
    with `get_crop`'s fallback ladder (see the JAX counterpart)."""
    keypoints = torch.as_tensor(keypoints, dtype=torch.float32)
    dev = keypoints.device
    B = keypoints.shape[0]
    pts = keypoints[..., :2] + torch.tensor([pad_x, 0.0], dtype=torch.float32, device=dev)
    conf = keypoints[..., 2]

    idx = torch.as_tensor(BPART_INDICES, device=dev)
    part_pts = pts[:, idx]  # [B, 10, 4, 2]
    part_conf = conf[:, idx]  # [B, 10, 4]
    sizes = torch.as_tensor(BPART_SIZES, device=dev)
    used = torch.arange(4, device=dev)[None, :] < sizes[:, None]  # [10, 4]
    primary_valid = torch.where(used[None], part_conf >= VALID_CONF, torch.ones_like(used[None])).all(-1)

    def kp(name):
        return pts[:, _IDX[name]]

    def kconf(name):
        return conf[:, _IDX[name]]

    quads, valids = [], []
    for p, names in enumerate(BPARTS):
        if len(names) == 4:
            quad = part_pts[:, p]
            v = primary_valid[:, p]
        elif len(names) == 3:
            lsh, rsh, nose = kp("lshoulder"), kp("rshoulder"), kp("cnose")
            neck = 0.5 * (lsh + rsh)
            p0 = neck + 2.0 * (nose - neck)
            p1 = neck
            normal = _perp(p1 - p0)
            alpha = 0.5
            quad3 = torch.stack(
                [p0 - alpha * normal, p1 - alpha * normal, p1 + alpha * normal, p0 + alpha * normal],
                dim=-2,
            )
            normal_f = _perp(rsh - lsh)
            normal_f = torch.where(normal_f[..., 1:2] > 0.0, -normal_f, normal_f)
            quad_fb = torch.stack([lsh + normal_f, lsh, rsh, rsh + normal_f], dim=-2)
            v3 = primary_valid[:, p]
            v_fb = (kconf("lshoulder") >= VALID_CONF) & (kconf("rshoulder") >= VALID_CONF)
            quad = torch.where(v3[:, None, None], quad3, quad_fb)
            v = v3 | v_fb
        else:
            a, b = kp(names[0]), kp(names[1])
            quad2 = _segment_quad(a, b, ar / 2.0)
            v2 = primary_valid[:, p]
            has_fallback = names in (["lhip", "lknee"], ["rhip", "rknee"]) or (
                knee_fallbacks and names in (["lknee", "lankle"], ["rknee", "rankle"])
            )
            if has_fallback:
                bottom = torch.stack([a[..., 0], torch.full_like(a[..., 0], img_h - 1.0)], dim=-1)
                quad_fb = _segment_quad(a, bottom, ar / 2.0)
                v_fb = kconf(names[0]) >= VALID_CONF
                quad = torch.where(v2[:, None, None], quad2, quad_fb)
                v = v2 | v_fb
            else:
                quad = quad2
                v = v2
        quads.append(quad)
        valids.append(v)
    return torch.stack(quads, dim=1), torch.stack(valids, dim=1).reshape(B, NUM_PARTS)


def _solve8(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 8x8 solve A x = b: unrolled Gauss-Jordan with one-hot partial
    pivoting, the same sequence of operations as the JAX package's."""
    Ab = torch.cat([A, b[..., None]], dim=-1)  # [..., 8, 9]
    rows = torch.arange(8, device=A.device)
    for k in range(8):
        col = Ab[..., :, k].abs()
        piv = torch.where(rows >= k, col, torch.full_like(col, -1.0)).argmax(dim=-1)
        is_piv = torch.nn.functional.one_hot(piv, 8).to(Ab.dtype)  # [..., 8]
        is_k = (rows == k).to(Ab.dtype)  # [8]
        pivot_row = torch.einsum("...r,...rc->...c", is_piv, Ab)  # [..., 9]
        row_k = Ab[..., k, :]
        Ab = (
            Ab
            + is_k[:, None] * (pivot_row[..., None, :] - Ab[..., k : k + 1, :])
            + is_piv[..., :, None] * (row_k[..., None, :] - pivot_row[..., None, :])
        )
        pv = Ab[..., k, k]
        pv = torch.where(pv.abs() < 1e-12, torch.full_like(pv, 1e-12), pv)
        norm_row = Ab[..., k, :] / pv[..., None]
        factors = Ab[..., :, k] * (1.0 - is_k)
        Ab = Ab - factors[..., :, None] * norm_row[..., None, :]
        Ab = torch.where((rows == k)[:, None], norm_row[..., None, :], Ab)
    return Ab[..., :, 8]


def perspective_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched cv2.getPerspectiveTransform: M with M @ [sx, sy, 1] ~ [dx, dy].
    src, dst: [..., 4, 2] -> [..., 3, 3] (last entry 1)."""
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32)
    x, y = src[..., 0], src[..., 1]
    X, Y = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rx = torch.stack([x, y, ones, zeros, zeros, zeros, -X * x, -X * y], dim=-1)
    ry = torch.stack([zeros, zeros, zeros, x, y, ones, -Y * x, -Y * y], dim=-1)
    A = torch.cat([rx, ry], dim=-2)  # [..., 8, 8]
    rhs = torch.cat([X, Y], dim=-1)  # [..., 8]
    m = _solve8(A, rhs)
    M = torch.cat([m, torch.ones_like(m[..., :1])], dim=-1)
    return M.reshape(M.shape[:-1] + (3, 3))


def dst_quad(w: int, h: int) -> np.ndarray:
    """Canonical patch frame corners: [0,0],[0,h],[w,h],[w,0]."""
    return np.asarray([[0.0, 0.0], [0.0, h], [w, h], [w, 0.0]], np.float32)


def part_transforms(
    keypoints: torch.Tensor,  # [B, 18, 3]
    img_h: int,
    patch_w: int,
    patch_h: int,
    pad_x: float = 32.0,
    ar: float = DEFAULT_AR,
    knee_fallbacks: bool = False,
):
    """(M [B,10,3,3], M_inv [B,10,3,3], valid [B,10]); invalid parts get
    identity matrices, keeping the batched solve non-singular."""
    quads, valid = part_quads(keypoints, img_h=img_h, pad_x=pad_x, ar=ar, knee_fallbacks=knee_fallbacks)
    dq = torch.as_tensor(dst_quad(patch_w, patch_h), device=quads.device).expand(quads.shape)
    safe_quads = torch.where(valid[..., None, None], quads, dq)
    M = perspective_transform(safe_quads, dq)
    M_inv = perspective_transform(dq, safe_quads)
    eye = torch.eye(3, dtype=torch.float32, device=quads.device).expand(M.shape)
    M = torch.where(valid[..., None, None], M, eye)
    M_inv = torch.where(valid[..., None, None], M_inv, eye)
    return M, M_inv, valid
