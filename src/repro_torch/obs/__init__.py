"""repro_torch.obs — the port's observability layer.

Counterpart of ``repro.obs``, in three pieces:

* :mod:`repro_torch.obs.trace` — flight-recorder spans with
  Chrome/Perfetto ``trace.json`` export, threaded through the façade, the
  backends, the serving ladder and the durability paths (host time only;
  see its docstring);
* :mod:`repro_torch.obs.counters` — the per-launch byte and tile ledger
  (:class:`~repro_torch.obs.counters.LaunchReport`), in the bytes the
  card's sweep kernels load and store (the reference models the TPU
  kernel's DMA; ROADMAP C19), and the reference's ledger math, copied;
* :mod:`repro_torch.obs.metrics` — a Prometheus-text / JSON metrics
  registry snapshotting ``AccessStats`` and the serving front end's
  telemetry with per-tenant labels.

This package imports nothing from the rest of ``repro_torch`` (only numpy
and the standard library), so every layer may depend on it without cycles.
"""

from repro_torch.obs import counters, metrics, trace
from repro_torch.obs.counters import (
    LaunchReport,
    collect_launch_reports,
    merge_reports,
)
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
    "LaunchReport",
    "MetricsRegistry",
    "Tracer",
    "collect_launch_reports",
    "counter",
    "counters",
    "disable",
    "enable",
    "get_tracer",
    "instant",
    "merge_reports",
    "metrics",
    "set_tracer",
    "span",
    "trace",
]
