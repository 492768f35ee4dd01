"""Reading a `torch.profiler` trace of a segment of a run.

The segment is wrapped in a `record_function(SEGMENT)`; the benchmark's own
spans are `record_function("bench.<name>")` ranges on the host.  From the
device's kernels (one stream: the port runs on the default stream, so their
intervals are merged before they are summed) it gives the busy seconds, the
segment's length, each kernel's device time by name, and the idle gaps named
by the benchmark span the host was in when each gap began.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SEGMENT = "bench.segment"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float] = field(default_factory=dict)  # name -> device seconds in the segment
    gaps: Dict[str, float] = field(default_factory=dict)  # host span -> idle device seconds
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start s, end s)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_profile(prof) -> Trace:
    import torch

    seg, spans, kernels = None, [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("bench."):  # the device-side copies of the benchmark's own ranges
                kernels.append((e.name, tr.start / 1e6, tr.end / 1e6))
        elif e.name == SEGMENT:
            seg = (tr.start / 1e6, tr.end / 1e6)
        elif e.name.startswith("bench."):
            spans.append((tr.start / 1e6, tr.end / 1e6, e.name[len("bench."):]))
    if seg is None:
        raise RuntimeError(f"the trace holds no {SEGMENT} range")
    t0, t1 = seg
    kernels = [(n, max(a, t0), min(b, t1)) for n, a, b in kernels if b > t0 and a < t1]
    ops = defaultdict(float)
    for n, a, b in kernels:
        ops[n] += b - a
    busy = _merge([(a, b) for _, a, b in kernels])
    gaps = defaultdict(float)
    prev = t0
    spans.sort()
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps[_span_at(spans, prev)] += a - prev
        prev = max(prev, b)
    return Trace(window_s=t1 - t0, busy_s=sum(b - a for a, b in busy), device_ops=dict(ops), gaps=dict(gaps),
                 kernels=kernels)


def _span_at(spans, t) -> str:
    """The innermost benchmark span that covers time t (the latest to start)."""
    name = "outside any span"
    for a, b, n in spans:
        if a > t:
            break
        if b >= t:
            name = n
    return name
