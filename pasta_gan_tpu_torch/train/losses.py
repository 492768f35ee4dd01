"""Loss functions (counterpart of `pasta_gan_tpu/train/losses.py`).

* non-saturating logistic GAN terms, applied to the coarse and the finetune
  image and averaged by the caller;
* L1 against the real image;
* parsing cross-entropy with class weights [1,2,2,3,3,3] and ignore index
  255 (torch CrossEntropyLoss's weighted mean);
* the R1 penalty through `torch.autograd.grad(create_graph=True)`, so its
  gradient with respect to D's parameters is a second derivative.
"""

from __future__ import annotations

from typing import Callable

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
