"""Straggler detection: rolling z-score over per-step wall times (a copy of
``repro.ft.straggler``).

On a real pod the step time of every host is gathered through the
coordination service each heartbeat; here the monitor consumes whatever
times the loop reports (tests feed synthetic distributions).  Policy
actions are pluggable — log, drop the offending host from the next elastic
re-mesh, or trigger a checkpoint-now so a restart loses no work.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    step_time: float
    median: float
    ratio: float


class StragglerMonitor:
    def __init__(
        self,
        window: int = 50,
        ratio_threshold: float = 2.0,
        min_samples: int = 10,
        on_straggler: Optional[Callable[[StragglerEvent], None]] = None,
    ):
        self.window = window
        self.ratio_threshold = ratio_threshold
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self._times: Deque[float] = collections.deque(maxlen=window)
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time: float, host: int = 0) -> bool:
        """Feed one (host, step_time). Returns True if flagged straggler."""
        flagged = False
        if len(self._times) >= self.min_samples:
            ts = sorted(self._times)
            median = ts[len(ts) // 2]
            ratio = step_time / max(median, 1e-9)
            if ratio > self.ratio_threshold:
                ev = StragglerEvent(step, host, step_time, median, ratio)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
                flagged = True
        # stragglers do not poison the window
        if not flagged:
            self._times.append(step_time)
        return flagged
