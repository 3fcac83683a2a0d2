"""Observability: device-resident telemetry, tracing and structured logging.

The port of the reference's ``repro/obs``: a :class:`MetricsCarry` of
device accumulators that rides every execution mode's carry and is drained
to the host once per run; the event-identity trace (:mod:`.trace`) and its
wait-blame / critical-path decomposition (:mod:`.critical_path`); and the
JSONL :class:`RunLogger`.  The exported names are the reference's, and
:func:`~repro_torch.obs.spans.span`, the port's own host spans of its hot
loops on the profiler's clock (:mod:`.spans`).
"""
from repro_torch.obs.critical_path import (attribute_wait, critical_path,
                                           straggler_tax)
from repro_torch.obs.metrics import (MetricsCarry, block_metrics_update,
                                     dense_metrics_update,
                                     fused_metrics_fold, init_metrics,
                                     metrics_summary, sparse_metrics_update)
from repro_torch.obs.runlog import RunLogger
from repro_torch.obs.spans import span
from repro_torch.obs.trace import (Trace, TraceRecorder, chrome_trace,
                                   drain_fused_payload, load_run_log,
                                   wall_track)

__all__ = [
    "MetricsCarry", "RunLogger", "Trace", "TraceRecorder",
    "attribute_wait", "block_metrics_update", "chrome_trace",
    "critical_path", "dense_metrics_update", "drain_fused_payload",
    "fused_metrics_fold", "init_metrics", "load_run_log",
    "metrics_summary", "span", "sparse_metrics_update", "straggler_tax",
    "wall_track",
]
