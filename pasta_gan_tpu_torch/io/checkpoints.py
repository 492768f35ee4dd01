"""Network snapshots: generator weights + w_avg + config in one `torch.save` file.

Counterpart of the JAX package's snapshot (`io/checkpoints.py`, Orbax) for
serving: `config` holds the model settings under "model", as there.  Loading
uses `weights_only=True`, so a snapshot can hold only tensors and plain data
and never runs stored code.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import torch


def save_snapshot(path: str, state_dict: Mapping[str, torch.Tensor], w_avg, config: Dict[str, Any]) -> None:
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "w_avg": torch.as_tensor(w_avg).detach().cpu().float(),
        "config": dict(config),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_snapshot(path: str, map_location="cpu") -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict[str, Any]]:
    """Returns (state_dict, w_avg, config)."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["state_dict"], payload["w_avg"], payload["config"]
