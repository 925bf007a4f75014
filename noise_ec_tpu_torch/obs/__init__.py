"""Observability core of the port: metrics, the registry, events, kernel
counters and device telemetry.

Port of ``noise_ec_tpu.obs`` but the collector, flight recorder,
federation, diagnosis and Perfetto modules (ROADMAP queue 1 item 5):

- :mod:`obs.metrics` — counters, fixed-bucket histograms with
  p50/p90/p99 extraction, timers;
- :mod:`obs.registry` — the labeled metric-family registry and the
  declarative metric-name table (``METRICS``, the reference's, whole, and
  the port's own ``PORT_METRICS``); ``default_registry().collect()`` reads
  every family recorded so far;
- :mod:`obs.events` — the wide structured-event log
  (``default_event_log().dump()``): the codec breaker's ``codec.refused``
  and ``codec.restore``, the device gate's ``qos.preempt``, the
  coalescer's ``qos.linger`` and the transport's connection events;
- :mod:`obs.profiling` — per-kernel call and byte counters and a
  ``torch.profiler`` capture;
- :mod:`obs.device` — per-dispatch latency with a compile/execute split,
  plan-derived program costs and device-memory gauges;
- :mod:`obs.trace` — the span tracer (stages keyed by the message's
  signature, request-scoped traces with tail sampling) that stamps every
  event with the active trace id and the node;
- :mod:`obs.health` — end-to-end outcomes and the rolling SLO evaluator;
- :mod:`obs.export` — Prometheus text exposition and its parser;
- :mod:`obs.sampler` — the always-on sampling profiler;
- :mod:`obs.server` — the node's stats server (``/metrics``, ``/spans``,
  ``/healthz``, ``/profile``, ``/xprof``, ``/events``) and periodic
  reporter.
"""

from noise_ec_tpu_torch.obs.device import (
    analyze_program,
    device_op,
    hbm_snapshot,
    peak_hbm_gbps,
)
from noise_ec_tpu_torch.obs.events import EventLog, default_event_log, event
from noise_ec_tpu_torch.obs.metrics import Counters, Histogram, Timer
from noise_ec_tpu_torch.obs.registry import (
    METRICS,
    PIPELINE_STAGES,
    Registry,
    default_registry,
    set_build_info,
)

__all__ = [
    "Counters",
    "EventLog",
    "Histogram",
    "METRICS",
    "PIPELINE_STAGES",
    "Registry",
    "Timer",
    "analyze_program",
    "default_event_log",
    "default_registry",
    "device_op",
    "event",
    "hbm_snapshot",
    "peak_hbm_gbps",
    "set_build_info",
]
