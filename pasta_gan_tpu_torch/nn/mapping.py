"""Mapping network c (style code) -> ws (counterpart of `pasta_gan_tpu/nn/mapping.py`).

Pure forward: returns the broadcast ws and the raw per-sample w; truncation
takes `w_avg` as an argument (it lives in the snapshot, not in a buffer).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import FullyConnectedLayer, normalize_2nd_moment


class MappingNetwork(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8, embed_features=None,
                 layer_features=None, activation="lrelu", lr_multiplier=0.01):
        super().__init__()
        if z_dim <= 0 and c_dim <= 0:
            raise ValueError("MappingNetwork needs z_dim > 0 or c_dim > 0")
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features or w_dim
        features = [z_dim + embed_features] + [layer_features] * (num_layers - 1) + [w_dim]
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed_features)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation=activation, lr_multiplier=lr_multiplier))

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor], w_avg=None,
                truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None):
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=-1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        w_raw = x
        if self.num_ws is not None:
            x = x[:, None, :].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if w_avg is None:
                raise ValueError("truncation requires w_avg")
            w_avg = torch.as_tensor(w_avg, device=x.device).to(x.dtype)
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x, w_raw
