"""Metrics registry: one snapshot, two exports.

Counterpart of ``repro.obs.metrics``: :class:`MetricsRegistry` is a
point-in-time snapshot — ``SpatialIndex.metrics()`` and
``ServingFrontEnd.metrics()`` pour ``AccessStats`` counters and the front
end's latency histograms into it, then render either Prometheus text
exposition or JSON.  Zero dependencies; the registry holds plain samples,
not live instruments, so snapshotting never perturbs the serving path.

Families follow Prometheus conventions: ``{namespace}_{name}`` with
sanitised metric names, ``# HELP`` / ``# TYPE`` headers, label sets per
sample, and latency histograms exported as summaries (``quantile``
labels + ``_sum`` / ``_count``).  The namespace stays ``repro``, so the
port and the JAX package export the same families for the same stats.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

_BAD = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}

DEFAULT_QUANTILES = (0.5, 0.99, 0.999)


def _san(name: str) -> str:
    s = _BAD.sub("_", str(name))
    return ("_" + s) if s[:1].isdigit() else s


def _esc(v: Any) -> str:
    return "".join(_LABEL_ESC.get(c, c) for c in str(v))


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class MetricsRegistry:
    """Snapshot of metric samples, renderable as Prometheus text or JSON."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = _san(namespace)
        # family -> (type, help); insertion order is render order
        self._families: Dict[str, Tuple[str, str]] = {}
        # (family, suffix, labels, value)
        self._samples: List[Tuple[str, str, Dict[str, str], float]] = []

    def _family(self, name: str, mtype: str, help_: str) -> str:
        fam = f"{self.namespace}_{_san(name)}"
        prev = self._families.get(fam)
        if prev is not None and prev[0] != mtype:
            raise ValueError(
                f"metric family {fam!r} registered as {prev[0]}, not {mtype}")
        self._families.setdefault(fam, (mtype, help_ or fam))
        return fam

    def _add(self, fam: str, suffix: str,
             labels: Optional[Dict[str, Any]], value: float) -> None:
        lbl = {_san(k): str(v) for k, v in (labels or {}).items()}
        self._samples.append((fam, suffix, lbl, float(value)))

    # -- public instruments --------------------------------------------
    def counter(self, name: str, value: float, *,
                labels: Optional[Dict[str, Any]] = None,
                help: str = "") -> None:
        self._add(self._family(name, "counter", help), "", labels, value)

    def gauge(self, name: str, value: float, *,
              labels: Optional[Dict[str, Any]] = None,
              help: str = "") -> None:
        self._add(self._family(name, "gauge", help), "", labels, value)

    def summary(self, name: str, hist, *,
                labels: Optional[Dict[str, Any]] = None, help: str = "",
                quantiles: Tuple[float, ...] = DEFAULT_QUANTILES) -> None:
        """Export a LatencyHistogram as a Prometheus summary."""
        fam = self._family(name, "summary", help)
        base = dict(labels or {})
        for q in quantiles:
            self._add(fam, "", {**base, "quantile": str(q)},
                      hist.quantile(q))
        self._add(fam, "_sum", base, hist.total)
        self._add(fam, "_count", base, hist.n)

    # -- renderers ------------------------------------------------------
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for fam, (mtype, help_) in self._families.items():
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {mtype}")
            for f, suffix, labels, value in self._samples:
                if f != fam:
                    continue
                if labels:
                    lbl = ",".join(f'{k}="{_esc(v)}"'
                                   for k, v in sorted(labels.items()))
                    lines.append(f"{fam}{suffix}{{{lbl}}} {_fmt(value)}")
                else:
                    lines.append(f"{fam}{suffix} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        return {
            "namespace": self.namespace,
            "metrics": [
                {
                    "name": fam + suffix,
                    "type": self._families[fam][0],
                    "labels": labels,
                    "value": value,
                }
                for fam, suffix, labels, value in self._samples
            ],
        }

    def write_json(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1)


# -- snapshot builders --------------------------------------------------

def stats_into(reg: MetricsRegistry, stats, *,
               prefix: str = "index",
               labels: Optional[Dict[str, Any]] = None) -> MetricsRegistry:
    """Pour an ``AccessStats`` snapshot (via ``to_dict``) into ``reg``."""
    d = stats.to_dict()
    rungs = d.pop("rung_dispatches", {}) or {}
    for k, v in d.items():
        reg.counter(f"{prefix}_{k}", v, labels=labels,
                    help=f"AccessStats.{k}")
    for rung, n in rungs.items():
        reg.counter(f"{prefix}_rung_dispatches", n,
                    labels={**(labels or {}), "rung": rung},
                    help="AccessStats.rung_dispatches")
    return reg


def telemetry_into(reg: MetricsRegistry, tel, *,
                   labels: Optional[Dict[str, Any]] = None) -> MetricsRegistry:
    """Pour a ``ServeTelemetry`` snapshot into ``reg``: scalar counters,
    overall latency/queue-wait summaries, and per-class / per-tenant
    latency summaries (p50/p99/p99.9)."""
    for k, v in tel.snapshot().items():
        if isinstance(v, (int, float)):
            reg.counter(f"serve_{k}", v, labels=labels,
                        help=f"ServeTelemetry.{k}")
    reg.summary("serve_latency_seconds", tel.latency, labels=labels,
                help="request latency (submit to complete)")
    reg.summary("serve_queue_wait_seconds", tel.queue_wait, labels=labels,
                help="queue wait (submit to launch)")
    for cls, h in sorted(tel.by_class.items()):
        reg.summary("serve_class_latency_seconds", h,
                    labels={**(labels or {}), "slo_class": cls},
                    help="request latency per SLO class")
    for tenant, h in sorted(getattr(tel, "by_tenant", {}).items()):
        reg.summary("serve_tenant_latency_seconds", h,
                    labels={**(labels or {}), "tenant": tenant},
                    help="request latency per tenant")
    return reg
