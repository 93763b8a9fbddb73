"""repro_torch.serve — the spatial serving front end.

Counterpart of ``repro.serve``: THE documented serving entry point for
spatial queries on the port.  The layering is:

* :mod:`repro_torch.launch.spatial_serve` — the low-level batch ENGINE
  (:class:`SpatialServer`: LRU + dedupe + one sweep a padded batch + the
  cuda → torch → host degradation ladder).  It only accepts pre-formed
  batches; the façade's ``backend="serve"`` wraps it per index.
* :mod:`repro_torch.serve` (this package) — the FRONT END over any number
  of tenant indexes: an async request queue that coalesces single
  region/point/knn/count arrivals into size- and deadline-bounded
  batches (continuous batching), admission control with per-class SLO
  deadlines that sheds or queues under overload, a declarative
  multi-tenant registry (config → built stack, on the card unless
  ``device="cpu"`` is asked for), and streaming latency telemetry
  (p50/p99/p99.9 histograms).
* the LM token-decoding entry point (the reference's ``repro.launch.serve``)
  is unrelated and not ported yet.

Every answer served through the queue is bit-identical to calling the
tenant's :class:`repro_torch.index.SpatialIndex` directly
(tests/test_torch_serve_front.py), including while a bound
:class:`repro_torch.ft.FaultPlan` forces the degradation ladder mid-run —
degradation shows up in tail latency, never in answers or errors.
"""

from .config import (  # noqa: F401
    DEFAULT_SLO_CLASSES,
    SLOClass,
    ServerConfig,
    TenantConfig,
)
from .frontend import (  # noqa: F401
    Answer,
    OverloadShed,
    ServingFrontEnd,
    TenantRuntime,
)
from .queue import Request  # noqa: F401
from .telemetry import LatencyHistogram, ServeTelemetry  # noqa: F401

__all__ = [
    "Answer",
    "DEFAULT_SLO_CLASSES",
    "LatencyHistogram",
    "OverloadShed",
    "Request",
    "SLOClass",
    "ServeTelemetry",
    "ServerConfig",
    "ServingFrontEnd",
    "TenantConfig",
    "TenantRuntime",
]
