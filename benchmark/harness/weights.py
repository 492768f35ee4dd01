"""Seeded weights, made on the device and handed alike to the program and the reference.

The reference model, built on the host with torch's generator at 0, is the
template: each parameter that it draws at random gets N(0, 1) values scaled
by the template's standard deviation, and each that it sets to a constant
(biases, gains, `bias_init`) gets that constant plus N(0, 0.1), so that no
branch is switched off by a zero.  All values come from one draw of a
`torch.Generator` on the card (the device given), in sorted name order.
"""

from __future__ import annotations

from typing import Dict

import torch


def draw_weights(template: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    params = dict(sorted(template.named_parameters()))
    total = sum(p.numel() for p in params.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, p in params.items():
        z = flat[at: at + p.numel()].view(p.shape)
        at += p.numel()
        t = p.detach().float()
        if t.numel() > 1 and bool((t != t.reshape(-1)[0]).any()):
            out[name] = z * float(t.std())
        else:
            out[name] = z * 0.1 + float(t.reshape(-1)[0])
    return out


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `module`'s parameters of the same names (every one)."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def template_of(factory) -> torch.nn.Module:
    """The reference's own module, built on the host from torch's generator at 0."""
    state = torch.random.get_rng_state()
    torch.manual_seed(0)
    try:
        return factory()
    finally:
        torch.random.set_rng_state(state)
