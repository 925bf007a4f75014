"""Observability of the port: metrics, the registry, events, kernel
counters, device telemetry, traces and what is built on them.

Port of ``noise_ec_tpu.obs``:

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
  plan-derived program costs, the panel route's per-tile attribution and
  device-memory gauges;
- :mod:`obs.trace` — the span tracer (stages keyed by the message's
  signature, request-scoped traces with tail sampling) that stamps every
  event with the active trace id and the node;
- :mod:`obs.health` — end-to-end outcomes and the rolling SLO evaluator;
- :mod:`obs.export` — Prometheus text exposition and its parser;
- :mod:`obs.sampler` — the always-on sampling profiler;
- :mod:`obs.server` — the node's stats server (``/metrics``, ``/spans``,
  ``/healthz``, ``/profile``, ``/xprof``, ``/events``) and periodic
  reporter;
- :mod:`obs.collector` — distributed trace collection: pull peer
  ``/spans`` dumps, align clocks, merge spans into fleet-wide traces;
- :mod:`obs.perfetto` — Chrome trace-event (Perfetto) export of merged
  traces;
- :mod:`obs.federate` — the fleet view: peers' ``/metrics`` merged on
  ``GET /fleet/metrics``;
- :mod:`obs.recorder` — the flight recorder: a ring of per-second
  deltas frozen into an incident bundle on an SLO flip or
  ``GET /incident``;
- :mod:`obs.diagnose` — the rule-table diagnosis engine behind
  ``GET /diagnose`` (its ``codec-demotion`` rule reads the breaker's
  refusals: the port never serves a device product from the host).

``utils.metrics`` / ``utils.profiling`` remain as re-export shims.
"""

from noise_ec_tpu_torch.obs.collector import TraceCollector
from noise_ec_tpu_torch.obs.device import (
    analyze_program,
    device_op,
    hbm_snapshot,
    peak_hbm_gbps,
    roofline_summary,
)
from noise_ec_tpu_torch.obs.diagnose import DiagnosisEngine
from noise_ec_tpu_torch.obs.events import EventLog, default_event_log, event
from noise_ec_tpu_torch.obs.federate import MetricsFederator
from noise_ec_tpu_torch.obs.health import SLOEvaluator, default_slo, record_e2e
from noise_ec_tpu_torch.obs.metrics import Counters, Histogram, Timer
from noise_ec_tpu_torch.obs.perfetto import to_chrome_trace, write_chrome_trace
from noise_ec_tpu_torch.obs.recorder import FlightRecorder
from noise_ec_tpu_torch.obs.registry import (
    METRICS,
    PIPELINE_STAGES,
    Registry,
    default_registry,
    set_build_info,
)
from noise_ec_tpu_torch.obs.sampler import StackSampler, default_sampler
from noise_ec_tpu_torch.obs.trace import Tracer, default_tracer, node_attrs, span

__all__ = [
    "Counters",
    "DiagnosisEngine",
    "EventLog",
    "FlightRecorder",
    "Histogram",
    "METRICS",
    "MetricsFederator",
    "PIPELINE_STAGES",
    "Registry",
    "SLOEvaluator",
    "StackSampler",
    "Timer",
    "TraceCollector",
    "Tracer",
    "analyze_program",
    "default_event_log",
    "default_registry",
    "default_sampler",
    "default_slo",
    "default_tracer",
    "device_op",
    "event",
    "hbm_snapshot",
    "node_attrs",
    "peak_hbm_gbps",
    "record_e2e",
    "roofline_summary",
    "set_build_info",
    "span",
    "to_chrome_trace",
    "write_chrome_trace",
]
