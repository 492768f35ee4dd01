"""Training state (counterpart of `pasta_gan_tpu/train/state.py`).

Everything the training loop changes lives in one object: G, D and G_ema
(modules with float32 master weights), the two Adam optimizers, the mapping
w_avg, the path-length mean, the ADA probability and sign counters (kept,
and counted, with ADA off, as the JAX state keeps them) and the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    G: nn.Module
    D: nn.Module
    G_ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    w_avg: torch.Tensor  # [w_dim] float32
    pl_mean: torch.Tensor  # float32 scalar
    ada_p: torch.Tensor  # float32 scalar, augment probability
    ada_signs_sum: torch.Tensor  # float32 scalar, accumulated mean sign(D(real))
    ada_signs_count: torch.Tensor  # float32 scalar

    _TENSORS = ("w_avg", "pl_mean", "ada_p", "ada_signs_sum", "ada_signs_count")

    def state_dict(self) -> Dict[str, Any]:
        """Tensors and plain data only (loads with `torch.load(weights_only=True)`)."""
        out = {"step": self.step, "G": self.G.state_dict(), "D": self.D.state_dict(),
               "G_ema": self.G_ema.state_dict(), "g_opt": self.g_opt.state_dict(),
               "d_opt": self.d_opt.state_dict()}
        out.update({k: getattr(self, k).detach().clone() for k in self._TENSORS})
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        for name in ("G", "D", "G_ema"):
            getattr(self, name).load_state_dict(sd[name], strict=True)
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        for k in self._TENSORS:
            getattr(self, k).copy_(sd[k])
