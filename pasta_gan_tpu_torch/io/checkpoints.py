"""Network snapshots and train-state checkpoints, each one `torch.save` file.

Counterpart of the JAX package's `io/checkpoints.py` (Orbax):

* a network snapshot holds generator weights + w_avg + config, where
  `config` holds the generator's constructor arguments under "model" and its
  synthesis variant ("full" or "v18", `models.GENERATORS`) under
  "generator"; it is what serving loads;
* a train-state checkpoint holds the whole `train/state.py:TrainState`
  (G, D, G_ema, both Adam states, w_avg, pl_mean, the ADA counters, the
  step) and the resolved training config, for `--resume`.

Loading uses `weights_only=True`, so a file can hold only tensors and plain
data and never runs stored code.
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
    _save(path, payload)


def _save(path: str, payload) -> None:
    """torch.save through a temporary file, so a crash leaves no torn file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_snapshot(path: str, map_location="cpu") -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Dict[str, Any]]:
    """Returns (state_dict, w_avg, config)."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return payload["state_dict"], payload["w_avg"], payload["config"]


def save_train_state(path: str, state, config: Dict[str, Any]) -> None:
    """Write `state` (a TrainState) and the training config (a plain dict)."""
    _save(path, {"state": state.state_dict(), "config": dict(config)})


def restore_train_state(path: str, state) -> Dict[str, Any]:
    """Load a train-state checkpoint into `state` (built for the same config,
    on any device); returns the checkpoint's config."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(payload["state"])
    return payload["config"]
