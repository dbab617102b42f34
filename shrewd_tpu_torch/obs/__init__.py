"""Deterministic observability: the flight-recorder tracer and its
exporters (the port's copy of ``shrewd_tpu/obs``).

- ``obs.clock`` — the ONE sanctioned wall-clock seam;
- ``obs.trace`` — the process-wide ``Tracer``: structured events at every
  load-bearing seam, a bounded ring dumped to ``outdir/flightrec.json``
  on abnormal exits; disabled, it is a no-op constant;
- ``obs.export`` — Chrome/Perfetto ``trace_event`` JSON and summaries;
- ``obs.metrics`` — atomic per-tick fleet metrics snapshots
  (``metrics.json`` + Prometheus text exposition) published by the
  resident scheduler.
"""

from shrewd_tpu_torch.obs import clock  # noqa: F401
from shrewd_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER, Tracer, disable, enable, flight_dump, tracer)
