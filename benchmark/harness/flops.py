"""FLOPs of a configuration at a cell's shapes, counted by the reference
(`torch.utils.flop_counter`: matrix products and convolutions, 2 per
multiply-add; elementwise work is not counted)."""

from __future__ import annotations


def count_flops(fn, *args):
    """(fn(*args), its FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, float(counter.get_total_flops())
