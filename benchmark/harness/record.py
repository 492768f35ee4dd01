"""What one run hands to the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import Trace


@dataclass
class Record:
    cell: dict
    config: dict
    traffic: dict
    trace_run: bool
    setup_s: float = 0.0
    window_s: float = 0.0  # host seconds from the first timed call to the end of the last
    requests: List[Tuple[float, float]] = field(default_factory=list)  # (start, end) of each, host seconds
    units_per_request: int = 1  # images a serving batch hands out
    attempted: int = 0
    failed: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)  # name -> seconds of each occurrence
    trace: Optional[Trace] = None
    launches: List[Tuple[str, tuple]] = field(default_factory=list)  # (kernel, C-entry args) in the trace
    flops_per_unit: Optional[float] = None  # of the configuration at the cell's shapes, counted by the reference
    memory_peak_bytes: int = 0
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)  # name -> (value, limit)
    notes: List[str] = field(default_factory=list)
    diagnostics: Dict[str, float] = field(default_factory=dict)  # numbers printed, not compared
