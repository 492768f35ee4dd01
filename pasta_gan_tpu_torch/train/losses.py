"""Loss functions (counterpart of `pasta_gan_tpu/train/losses.py`).

* non-saturating logistic GAN terms, applied to the coarse and the finetune
  image and averaged by the caller;
* L1 against the real image;
* parsing cross-entropy with class weights [1,2,2,3,3,3] and ignore index
  255 (torch CrossEntropyLoss's weighted mean);
* the R1 penalty through `torch.autograd.grad(create_graph=True)`, so its
  gradient with respect to D's parameters is a second derivative;
* the path-length penalty from the gradient of G's image with respect to
  ws (`pl_penalty_from_grads`);
* the contextual (CX) loss over cosine affinities, computed in row chunks
  (`contextual_loss`).
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch
import torch.nn.functional as F


def g_nonsaturating(logits: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(D(fake))."""
    return F.softplus(-logits).mean()


def d_fake(logits: torch.Tensor) -> torch.Tensor:
    """-log(1 - sigmoid(D(fake)))."""
    return F.softplus(logits).mean()


def d_real(logits: torch.Tensor) -> torch.Tensor:
    """-log sigmoid(D(real))."""
    return F.softplus(-logits).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


# class weights for {bg, upper, lower, hands, legs, neck}
PARSING_CLASS_WEIGHTS = (1.0, 2.0, 2.0, 3.0, 3.0, 3.0)


def parsing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights=PARSING_CLASS_WEIGHTS) -> torch.Tensor:
    """Weighted cross-entropy over logits [N, H, W, K] (NHWC) and int labels
    [N, H, W] (255 = ignore): sum(w_i ce_i) / sum(w_i) over valid pixels."""
    K = logits.shape[-1]
    labels = labels.long()
    valid = (labels != 255) & (labels >= 0) & (labels < K)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)[safe] * valid.float()
    return (ce * w).sum() / w.sum().clamp_min(1e-8)


def r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor) -> torch.Tensor:
    """R1: ||d sum(D(x)) / dx||^2 per sample, batch-meaned; differentiable in
    D's parameters (the graph of the input gradient is kept)."""
    x = real_img.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    return grads.float().square().sum(dim=(1, 2, 3)).mean()


def pl_penalty_from_grads(pl_grads: torch.Tensor, pl_mean: torch.Tensor, pl_decay: float):
    """Path-length penalty given d sum(img * noise) / d ws [N, num_ws, w_dim]:
    (mean of (|J^T y| - new_mean)^2, new_mean), new_mean the running mean moved
    by pl_decay towards this batch's mean length (and differentiable, as in
    the JAX package)."""
    lengths = pl_grads.float().square().sum(dim=2).mean(dim=1).sqrt()
    new_mean = pl_mean + pl_decay * (lengths.mean() - pl_mean)
    return (lengths - new_mean).square().mean(), new_mean


def feature_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(dim=-1, keepdim=True).sqrt() + eps)


# 64 Mi elements: 256 MiB for each fp32 [rows, H*W] temporary of a chunk (1024
# query rows at relu1_2 of a 256x256 image, H*W = 65536).  The forward holds
# one such temporary, the backward two (and two boolean masks).
CONTEXTUAL_CHUNK_ELEMS = 1 << 26


def _cx_chunks(n: int, q: int, k: int, chunk_elems: int) -> Iterator[Tuple[slice, slice]]:
    """(samples, query rows) of each chunk: at most max(k, chunk_elems)
    affinities, whole samples together where a sample's q * k fit."""
    rows = max(1, chunk_elems // k)
    if rows >= q:
        per = max(1, rows // q)
        for n0 in range(0, n, per):
            yield slice(n0, min(n, n0 + per)), slice(0, q)
        return
    for i in range(n):
        for r0 in range(0, q, rows):
            yield slice(i, i + 1), slice(r0, min(q, r0 + rows))


def _cx_affinities(xf: torch.Tensor, yf: torch.Tensor, h: float, keep_d: bool = True):
    """d = 1 - xf yf^T [B, r, K] for query rows xf [B, r, C] against yf [B, K, C],
    its row minimum, and w = exp((1 - d / (min_k d + 1e-3)) / h), each
    operation rounded as the JAX formula rounds it; without `keep_d`, w
    overwrites d."""
    one = torch.ones((), dtype=xf.dtype)  # a host scalar: "1 - t" is one pass on the card
    d = torch.matmul(xf, yf.transpose(1, 2))
    torch.sub(one, d, out=d)
    d_min = d.amin(dim=-1, keepdim=True)
    w = torch.div(d, d_min + 1e-3) if keep_d else d.div_(d_min + 1e-3)
    torch.sub(one, w, out=w).div_(h).exp_()
    return d, d_min, w


class _CXRowMax(torch.autograd.Function):
    """Each query row's largest CX affinity m = max_k a_k, a = w / sum_k w,
    [N, Q], from normalized features xf [N, Q, C] and the constant yf
    [N, K, C], one chunk of rows at a time (`_cx_chunks`): the [Q, K]
    affinity matrix of a 256x256 relu1_2 map would be 17.2 GB a sample.

    The backward recomputes each chunk and applies the formula's derivative,
    with JAX's reduce-min/max gradients, which split evenly among ties: with
    I the c_max positions where a is m, J the c_min where d is its minimum
    (J lies in I: every operation from d to a is monotone) and D = min d +
    1e-3,

        dm/dd_k = (m / (h D)) (a_k - I_k / c_max) + g_D J_k / c_min,
        g_D = -(m / (h D^2)) sum_j (a_j - I_j / c_max) d_j,

    and dm/dxf = -(dm/dd) yf."""

    @staticmethod
    def forward(ctx, xf, yf, h, chunk_elems):
        ctx.save_for_backward(xf, yf)
        ctx.h, ctx.chunk_elems = h, chunk_elems
        n, q, _ = xf.shape
        out = xf.new_empty((n, q))
        for ns, rs in _cx_chunks(n, q, yf.shape[1], chunk_elems):
            _, _, w = _cx_affinities(xf[ns, rs], yf[ns], h, keep_d=False)
            # max_k (w_k / s) is max_k w_k / s exactly: division by s > 0 is monotone
            out[ns, rs] = w.amax(dim=-1) / w.sum(dim=-1)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        xf, yf = ctx.saved_tensors
        h = ctx.h
        gx = torch.empty_like(xf)
        n, q, _ = xf.shape
        for ns, rs in _cx_chunks(n, q, yf.shape[1], ctx.chunk_elems):
            d, d_min, a = _cx_affinities(xf[ns, rs], yf[ns], h)
            a.div_(a.sum(dim=-1, keepdim=True))
            m = a.amax(dim=-1, keepdim=True)
            at_max, at_min = a == m, d == d_min
            c_max = at_max.sum(dim=-1, keepdim=True)
            c_min = at_min.sum(dim=-1, keepdim=True)
            p = torch.where(at_max, m - 1.0 / c_max, a, out=a)  # a - I / c_max
            big_d = d_min + 1e-3
            scale = grad[ns, rs, None] * m / (h * big_d)
            g_d = -scale / big_d * torch.einsum("brk,brk->br", p, d)[..., None]
            p.mul_(scale)
            torch.where(at_min, scale * (m - 1.0 / c_max) + g_d / c_min, p, out=p)
            gx[ns, rs] = -torch.matmul(p, yf[ns])
        return gx, None, None, None


def contextual_loss(x: torch.Tensor, y: torch.Tensor, h: float = 0.1, pono: bool = True,
                    chunk_elems: int = CONTEXTUAL_CHUNK_ELEMS) -> torch.Tensor:
    """CX loss of features x against the constant target y, both [N, H, W, C]
    (NHWC), in float32: the JAX package's `contextual_loss`.  With `pono` both
    are centred on y's per-position channel mean (else on y's per-sample
    spatial mean); then cosine distances d = 1 - xf yf^T, d / (min_k d +
    1e-3), w = exp((1 - d_norm) / h), a = w / sum_k w, and the loss is the
    batch mean of -log(mean_q max_k a).  The affinities are formed
    `chunk_elems` at a time (`_CXRowMax`)."""
    n, hh, ww, c = x.shape
    x, y = x.float(), y.detach().float()
    mu = y.mean(dim=-1, keepdim=True) if pono else y.mean(dim=(1, 2), keepdim=True)
    xf = feature_normalize(x - mu).reshape(n, hh * ww, c)
    yf = feature_normalize(y - mu).reshape(n, hh * ww, c)
    cx = _CXRowMax.apply(xf, yf, h, chunk_elems).mean(dim=1)
    return (-torch.log(cx)).mean()
