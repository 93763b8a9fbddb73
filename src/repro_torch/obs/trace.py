"""Flight-recorder tracing with Chrome/Perfetto export.

Counterpart of ``repro.obs.trace``: the same ring buffer, the same event
schema, the same span names across the port.  A single process-wide
:class:`Tracer` records three Chrome-trace event kinds into a bounded ring
buffer:

* ``span(name, **args)`` — a nestable context manager emitting one
  complete ("ph": "X") event on exit, covering the region's wall time.
  Nesting is implicit: Perfetto reconstructs the stack from ts/dur
  containment per thread, so spans survive exceptions — ``__exit__``
  always runs and stamps the error type into ``args``.
* ``instant(name, **args)`` — a point event ("ph": "i"), used for
  degradation-rung transitions.
* ``counter(name, **values)`` — a counter track ("ph": "C").

A span measures HOST time only.  On the card, kernel launches are
asynchronous: a span around a launch ends when the launch is queued, before
the device has run it, and a later span that reads a result to the host
(``.tolist()``, ``.cpu()``) absorbs the wait.  Nothing here synchronizes
the device for the sake of a span; device time is measured with CUDA events
or the profiler (``chip_smoke.py``).

The disabled fast path is a single attribute check returning a shared
no-op span object — no allocation, no clock read — so production code
can leave instrumentation inline.  The ring buffer (default 64k events)
makes the tracer a flight recorder: oldest events are dropped and counted
in :attr:`Tracer.dropped`.

Timestamps are microseconds on ``time.monotonic`` relative to tracer
creation, which is what the Chrome trace-event format expects.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False

    def annotate(self, **args: Any) -> None:
        pass

    def event(self, name: str, **args: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """A live span; created only when the tracer is enabled."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = self._tracer._now_us()
        return self

    def annotate(self, **args: Any) -> None:
        """Attach extra args discovered mid-span (e.g. result sizes)."""
        self.args.update(args)

    def event(self, name: str, **args: Any) -> None:
        """An instant event stamped inside this span's thread track."""
        self._tracer.instant(name, **args)

    def __exit__(self, et, ev, tb) -> bool:
        t1 = self._tracer._now_us()
        args = self.args
        if et is not None:
            # spans close under exceptions (incl. BaseException kills);
            # record what tore through so the trace shows the failure.
            args = dict(args)
            args["error"] = et.__name__
        self._tracer._append(
            {
                "name": self.name,
                "ph": "X",
                "ts": self._t0,
                "dur": max(t1 - self._t0, 0.0),
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            }
        )
        return False


class Tracer:
    """Bounded in-memory trace recorder with Chrome-trace export."""

    def __init__(self, capacity: int = 65536, clock=time.monotonic):
        self.enabled = False
        self.clock = clock
        self.dropped = 0
        self._t0 = clock()
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    # -- recording ------------------------------------------------------
    def _now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        if not self.enabled:
            return
        self._append(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": self._now_us(),
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            }
        )

    def counter(self, name: str, **values: Any) -> None:
        if not self.enabled:
            return
        self._append(
            {
                "name": name,
                "ph": "C",
                "ts": self._now_us(),
                "pid": os.getpid(),
                "args": {k: float(v) for k, v in values.items()},
            }
        )

    # -- inspection / export --------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export_chrome_trace(self, path) -> str:
        """Write the ring buffer as a Perfetto-loadable ``trace.json``."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "recorder": "repro_torch.obs.trace",
                "dropped_events": self.dropped,
            },
        }
        path = os.fspath(path)
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return path


# -- process-wide tracer ------------------------------------------------
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests install a fresh one); returns it."""
    global _TRACER
    _TRACER = tracer
    return tracer


def enable(capacity: Optional[int] = None) -> Tracer:
    if capacity is not None and capacity != _TRACER._events.maxlen:
        set_tracer(Tracer(capacity=capacity))
    _TRACER.enabled = True
    return _TRACER


def disable() -> None:
    _TRACER.enabled = False


def span(name: str, **args: Any):
    """Module-level span helper; the disabled path is one attr check."""
    t = _TRACER
    if not t.enabled:
        return NULL_SPAN
    return Span(t, name, args)


def instant(name: str, **args: Any) -> None:
    _TRACER.instant(name, **args)


def counter(name: str, **values: Any) -> None:
    _TRACER.counter(name, **values)


if os.environ.get("REPRO_TRACE") == "1":  # opt-in via env for CLIs
    enable()
