"""repro_torch.obs — the port's observability layer.

Counterpart of ``repro.obs`` for two of its three pieces:

* :mod:`repro_torch.obs.trace` — flight-recorder spans with
  Chrome/Perfetto ``trace.json`` export, threaded through the façade, the
  backends, the serving ladder and the durability paths (host time only;
  see its docstring);
* :mod:`repro_torch.obs.metrics` — a Prometheus-text / JSON metrics
  registry snapshotting ``AccessStats`` with per-tenant labels.

The reference's third piece, ``obs/counters.py`` (the per-launch byte and
tile ledger), models the TPU kernel's DMA traffic; the port's counterpart
is still to be derived for the card's launches (ROADMAP.md).

This package imports nothing from the rest of ``repro_torch`` (only the
standard library), so every layer may depend on it without cycles.
"""

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (
    Tracer,
    counter,
    disable,
    enable,
    get_tracer,
    instant,
    set_tracer,
    span,
)

__all__ = [
    "MetricsRegistry",
    "Tracer",
    "counter",
    "disable",
    "enable",
    "get_tracer",
    "instant",
    "metrics",
    "set_tracer",
    "span",
    "trace",
]
