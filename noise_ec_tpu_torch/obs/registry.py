"""Labeled metric families and the declarative metric-name registry.

Port of ``noise_ec_tpu.obs.registry``. Two registries live here,
deliberately together:

- :class:`Registry` — the runtime object: named counter/gauge/histogram
  FAMILIES whose children are keyed by label values (``peer="tcp://..."``,
  ``stage="decode"``). The dispatcher and the codecs record into the
  process-wide :func:`default_registry`; read it with
  ``default_registry().collect()``.
- :data:`METRICS` — the declarative name registry: every metric name this
  codebase may export, with its type, help string and label names. It is
  a copy of the reference's table, whole, so every name a later ported
  module records is already declared, plus the families only the port
  records (:data:`PORT_METRICS`). ``Registry`` refuses names that are
  not declared (or declared with a different type), so a typo'd metric
  name is an error at first record, not a silently forked time series.

Hot-path budget: a child lookup is one dict get under a lock; a counter
add is one more lock + add (the ``record_kernel`` cost class). Callers on
per-shard paths should hold the child (``self._shards_in =
family.labels(peer=...)``) rather than re-resolving labels per event.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional, Sequence

from noise_ec_tpu_torch.obs.metrics import (
    DEVICE_LATENCY_BUCKETS,
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Histogram,
)

__all__ = [
    "METRICS",
    "PORT_METRICS",
    "PIPELINE_STAGES",
    "Registry",
    "default_registry",
    "set_build_info",
]

# The span/stage model (docs/observability.md): every pipeline stage a
# shard can spend time in, send path then receive path. Span names outside
# this tuple still record (the tracer is generic) but the stage histogram
# label set stays bounded by convention.
PIPELINE_STAGES: tuple[str, ...] = (
    "prepare",
    "encode",
    "sign",
    "wire_encode",
    "broadcast",
    "deliver",
    "decode",
    "verify",
    "reassemble",
    # Store background work (docs/store.md): one span per scrub cycle and
    # one per repair dispatch (batched group or single-stripe restore).
    "scrub",
    "repair",
    # Hot->archival conversion (docs/lrc.md): one span per converted
    # object (gather -> re-encode -> manifest swap -> GC).
    "convert",
    # Placement churn rebalance (docs/placement.md): one span per
    # ownership-delta cycle over the local store.
    "rebalance",
    # Request-scoped tracing tiers (docs/observability.md "Request
    # tracing"): the root span of every object-service op, then one
    # child per serving tier a GET touches and per PUT delivery leg.
    "request",
    "cache_probe",
    "local_join",
    "peer_fetch",
    "gather_fetch",
    "stripe_decode",
    "stripe_put",
    "placement_send",
    # Single-flight followers: the span that points a coalesced reader
    # at its leader's trace.
    "joined",
)

# name -> (type, help, label names). The single source of truth for every
# exported series, copied whole from the reference (its exporter renders
# HELP/TYPE from it); the help strings are the reference's, word for word.
METRICS: dict[str, tuple[str, str, tuple[str, ...]]] = {
    "noise_ec_build_info": (
        "gauge",
        "Deployment identity (value is always 1), labeled by codec "
        "backend, kernel and package version — the pivot for dashboards "
        "comparing rollouts",
        ("backend", "kernel", "version"),
    ),
    "noise_ec_e2e_latency_seconds": (
        "histogram",
        "End-to-end receive-path latency (first shard seen to object "
        "completion), labeled by outcome (ok, verify_failed, corrupt, "
        "incomplete)",
        ("outcome",),
    ),
    "noise_ec_stage_seconds": (
        "histogram",
        "Pipeline stage latency (span durations), labeled by stage",
        ("stage",),
    ),
    "noise_ec_decode_seconds": (
        "histogram",
        "FEC decode latency on the receive hot path",
        (),
    ),
    "noise_ec_decode_bytes": (
        "histogram",
        "FEC decode payload size per decode call",
        (),
    ),
    "noise_ec_dispatch_seconds": (
        "histogram",
        "Per-delivery plugin handler latency on the dispatcher pool",
        (),
    ),
    "noise_ec_stream_chunk_seconds": (
        "histogram",
        "Streaming encoder per-chunk encode+fetch latency",
        (),
    ),
    "noise_ec_transport_shards_in_total": (
        "counter",
        "Shard messages received, labeled by sending peer address",
        ("peer",),
    ),
    "noise_ec_transport_shards_out_total": (
        "counter",
        "Shard messages sent, labeled by destination peer address",
        ("peer",),
    ),
    "noise_ec_transport_bytes_in_total": (
        "counter",
        "Shard payload bytes received, labeled by sending peer address",
        ("peer",),
    ),
    "noise_ec_transport_bytes_out_total": (
        "counter",
        "Shard payload bytes sent, labeled by destination peer address",
        ("peer",),
    ),
    "noise_ec_transport_frame_errors_total": (
        "counter",
        "Transport frames rejected before dispatch, labeled by kind "
        "(wire, signature, unregistered, overflow, handler)",
        ("kind",),
    ),
    "noise_ec_dispatch_queue_depth": (
        "gauge",
        "Entries queued in the serial dispatcher (all senders)",
        (),
    ),
    "noise_ec_dispatch_overflows_total": (
        "counter",
        "Deliveries dropped because a sender's dispatch window was full",
        (),
    ),
    "noise_ec_kcp_retransmits_total": (
        "counter",
        "KCP segments retransmitted, labeled by trigger (rto, fast)",
        ("kind",),
    ),
    "noise_ec_kcp_dead_links_total": (
        "counter",
        "KCP sessions closed after DEAD_XMIT transmissions of a segment",
        (),
    ),
    "noise_ec_kcp_sessions_opened_total": (
        "counter",
        "KCP sessions opened (dialed or accepted)",
        (),
    ),
    "noise_ec_spans_total": (
        "counter",
        "Spans recorded by the in-process tracer, labeled by stage",
        ("stage",),
    ),
    "noise_ec_trace_requests_total": (
        "counter",
        "Request-scoped traces by tail-sampling decision (kept_error, "
        "kept_slow, kept_sampled, dropped, evicted)",
        ("decision",),
    ),
    # --- stripe store / scrub / repair (noise_ec_tpu/store, docs/store.md)
    "noise_ec_store_stripes": (
        "gauge",
        "Stripes resident in the store(s)",
        (),
    ),
    "noise_ec_store_shard_bytes": (
        "gauge",
        "Shard bytes pinned by the store(s)",
        (),
    ),
    "noise_ec_store_degraded_reads_total": (
        "counter",
        "Reads served by on-demand reconstruction (data shards missing)",
        (),
    ),
    "noise_ec_store_absorbed_shards_total": (
        "counter",
        "Wire shards absorbed into existing stripes (anti-entropy fill)",
        (),
    ),
    "noise_ec_store_absorb_rejected_total": (
        "counter",
        "Wire shards rejected by the absorb consistency check",
        (),
    ),
    "noise_ec_store_scrub_cycles_total": (
        "counter",
        "Completed scrub cycles",
        (),
    ),
    "noise_ec_store_scrubbed_stripes_total": (
        "counter",
        "Stripes examined by the scrubber",
        (),
    ),
    "noise_ec_store_missing_shards_total": (
        "counter",
        "Missing/unverified shards newly flagged by the scrubber",
        (),
    ),
    "noise_ec_store_verify_failures_total": (
        "counter",
        "Stripes whose batched parity verify failed (corruption found)",
        (),
    ),
    "noise_ec_store_corrupt_shards_total": (
        "counter",
        "Shards whose stored bytes disagreed with the repaired truth",
        (),
    ),
    "noise_ec_store_repairs_completed_total": (
        "counter",
        "Stripes restored to full health by the repair engine",
        (),
    ),
    "noise_ec_store_repair_failures_total": (
        "counter",
        "Repair attempts that could not restore the stripe",
        (),
    ),
    "noise_ec_store_repair_batches_total": (
        "counter",
        "Batched device reconstruct dispatches (>= batch_min stripes each)",
        (),
    ),
    "noise_ec_store_repair_batch_stripes_total": (
        "counter",
        "Stripes repaired through batched device dispatches",
        (),
    ),
    "noise_ec_store_repair_queue_depth": (
        "gauge",
        "Stripes awaiting repair across live repair engines",
        (),
    ),
    "noise_ec_store_anti_entropy_requests_total": (
        "counter",
        "Anti-entropy shard-fetch requests broadcast to peers",
        (),
    ),
    "noise_ec_store_anti_entropy_responses_total": (
        "counter",
        "Anti-entropy responses answered with local shards",
        (),
    ),
    "noise_ec_store_repair_shards_read_total": (
        "counter",
        "Shards read as repair inputs by the engine's group drains, "
        "labeled by codec code kind (rs, lrc) — the numerator of the "
        "repair-storm bench's repair_fetch_amplification stat",
        ("code",),
    ),
    # --- LRC repair tiers (codec/lrc.py, docs/lrc.md)
    "noise_ec_lrc_repairs_total": (
        "counter",
        "Shards healed through the LRC codec, labeled by repair tier "
        "(local = inside one group cell, global = full-k fallback)",
        ("tier",),
    ),
    "noise_ec_lrc_repair_shards_read_total": (
        "counter",
        "Shards consumed as repair inputs by the LRC codec, labeled by "
        "tier — local reads ~k/g per heal, global reads k",
        ("tier",),
    ),
    # --- hot->archival conversion (store/convert.py, docs/lrc.md)
    "noise_ec_convert_objects_total": (
        "counter",
        "Objects processed by the conversion engine, labeled by result "
        "(converted, failed)",
        ("result",),
    ),
    "noise_ec_convert_bytes_total": (
        "counter",
        "Logical object bytes re-encoded into archival stripes",
        (),
    ),
    "noise_ec_convert_stripes_total": (
        "counter",
        "Source hot-tier stripes consumed by conversions, labeled by "
        "gather mode (merge = decode-free data-shard join, reconstruct "
        "= batched degraded rebuild)",
        ("mode",),
    ),
    "noise_ec_convert_seconds": (
        "histogram",
        "Wall time per object conversion (gather, re-encode, manifest "
        "swap, GC)",
        (),
    ),
    # --- resilience (noise_ec_tpu/resilience, docs/resilience.md)
    "noise_ec_peer_circuit_state": (
        "gauge",
        "Per-peer re-dial circuit breaker state (0 closed, 1 open, "
        "2 half-open), labeled by dialed peer address",
        ("peer",),
    ),
    "noise_ec_reconnect_total": (
        "counter",
        "Supervised re-dials of lost established connections, labeled "
        "by result (ok, failed)",
        ("result",),
    ),
    "noise_ec_nack_requests_total": (
        "counter",
        "NACK shard-repair requests sent for pools stuck below k after "
        "the grace timeout",
        (),
    ),
    "noise_ec_nack_repaired_total": (
        "counter",
        "Objects delivered after at least one NACK repair round",
        (),
    ),
    "noise_ec_nack_giveups_total": (
        "counter",
        "NACK repairs abandoned after the retry budget (records an "
        "outcome=incomplete e2e event)",
        (),
    ),
    "noise_ec_codec_fallback_total": (
        "counter",
        "Encode/reconstruct calls served by the golden host codec "
        "instead of the device route, labeled by reason (error = device "
        "dispatch failed after retry, open = breaker short-circuit)",
        ("reason",),
    ),
    "noise_ec_codec_circuit_state": (
        "gauge",
        "Codec device-route circuit breaker state (0 closed, 1 open, "
        "2 half-open)",
        (),
    ),
    "noise_ec_store_announces_total": (
        "counter",
        "Anti-entropy announce broadcasts of recently stored stripes "
        "(one shard each; silent-partition recovery)",
        (),
    ),
    # --- device telemetry (obs/device.py, obs/sampler.py, ops/dispatch.py)
    "noise_ec_device_op_seconds": (
        "histogram",
        "Per-dispatch device codec latency, labeled by kernel entry and "
        "route (compile = first call for a (matrix, shape, kernel) cache "
        "key, execute = warm calls). Words entries time the async submit; "
        "stripes entries time through host materialization",
        ("kernel", "route"),
    ),
    "noise_ec_jit_compiles_total": (
        "counter",
        "First-call dispatches per (matrix, shape, kernel) cache key — "
        "geometry churn causing recompiles shows here as a rate instead "
        "of a silent p99 cliff",
        ("kernel",),
    ),
    "noise_ec_jit_compile_seconds": (
        "histogram",
        "Latency of first-call (trace + compile + run) dispatches, "
        "labeled by kernel entry",
        ("kernel",),
    ),
    "noise_ec_kernel_calls_total": (
        "counter",
        "Device-kernel invocations, labeled by entry point (the registry "
        "form of the record_kernel counter bag)",
        ("entry",),
    ),
    "noise_ec_kernel_tile_dispatches_total": (
        "counter",
        "Block-panel kernel dispatches per (entry, tile config) — tile "
        "is the auto-tuner's kbKB_rbRB_tlTL triple, so a plan change is "
        "a visible label split, not a silent re-route",
        ("entry", "tile"),
    ),
    "noise_ec_kernel_tile_bytes_total": (
        "counter",
        "Payload bytes dispatched per (entry, tile config) on the "
        "block-panel kernels",
        ("entry", "tile"),
    ),
    "noise_ec_kernel_tile_utilization": (
        "gauge",
        "Achieved execute-route payload bandwidth over the device peak "
        "(0..1) per (entry, tile config) — the tile-resolved view of "
        "noise_ec_roofline_utilization that attributes a wide-geometry "
        "gain to the panel plan that produced it",
        ("entry", "tile"),
    ),
    "noise_ec_kernel_sublaunch_dispatches_total": (
        "counter",
        "K-grid sub-launches executed per panel-routed dispatch entry "
        "(a dispatch under a G-way split plan adds G) — the split "
        "path's execution-side telemetry; / kernel_calls gives the "
        "mean G a geometry runs at",
        ("entry",),
    ),
    "noise_ec_kernel_sublaunch_programs_total": (
        "counter",
        "Distinct sub-launch pallas_call programs built (panel-tier "
        "program-cache misses, initial + accumulating) — the program-"
        "set growth the persistent compile cache amortizes",
        (),
    ),
    "noise_ec_compile_cache_hits_total": (
        "counter",
        "Persistent JAX compilation-cache hits (-compile-cache-dir): "
        "programs a restart replayed from disk instead of recompiling",
        (),
    ),
    "noise_ec_kernel_bytes_total": (
        "counter",
        "Payload bytes moved per device-kernel entry point (the registry "
        "form of the record_kernel counter bag)",
        ("entry",),
    ),
    "noise_ec_hbm_live_bytes": (
        "gauge",
        "Device bytes held by live JAX arrays (jax.live_arrays), read at "
        "collect time",
        (),
    ),
    "noise_ec_hbm_peak_bytes": (
        "gauge",
        "Peak device bytes in use (allocator memory_stats when the "
        "backend reports them, else the high-water mark of live-array "
        "scans)",
        (),
    ),
    "noise_ec_hbm_limit_bytes": (
        "gauge",
        "Device memory capacity reported by the allocator (0 when the "
        "backend does not report one)",
        (),
    ),
    "noise_ec_device_program_flops": (
        "gauge",
        "XLA cost_analysis FLOPs of the most recently compiled program, "
        "labeled by kernel entry",
        ("kernel",),
    ),
    "noise_ec_device_program_bytes": (
        "gauge",
        "XLA cost_analysis bytes accessed of the most recently compiled "
        "program, labeled by kernel entry",
        ("kernel",),
    ),
    "noise_ec_roofline_intensity": (
        "gauge",
        "Operational intensity (cost_analysis FLOPs / bytes accessed) of "
        "the most recently compiled program, labeled by kernel entry",
        ("kernel",),
    ),
    "noise_ec_roofline_utilization": (
        "gauge",
        "Achieved payload bandwidth over the device peak (0..1), from "
        "cumulative execute-route dispatch bytes/seconds, labeled by "
        "kernel entry",
        ("kernel",),
    ),
    "noise_ec_profile_samples_total": (
        "counter",
        "Stack samples folded by the always-on sampling profiler "
        "(obs/sampler.py; one per thread per tick)",
        (),
    ),
    # --- object service (noise_ec_tpu/service, docs/object-service.md)
    "noise_ec_object_puts_total": (
        "counter",
        "Objects admitted and stored through the object service PUT "
        "path, labeled by tenant",
        ("tenant",),
    ),
    "noise_ec_object_put_bytes_total": (
        "counter",
        "Logical object bytes admitted through PUT, labeled by tenant",
        ("tenant",),
    ),
    "noise_ec_object_gets_total": (
        "counter",
        "Object/range reads, labeled by result (ok, hit = every stripe "
        "served from the decoded cache, coalesced = at least one stripe "
        "rode another request's in-flight decode, degraded = at least "
        "one stripe reconstructed, unavailable = below k and anti-entropy "
        "timed out, error)",
        ("result",),
    ),
    "noise_ec_object_get_bytes_total": (
        "counter",
        "Object bytes served by GET/range reads",
        (),
    ),
    "noise_ec_object_deletes_total": (
        "counter",
        "Objects deleted (manifest dropped, unreferenced stripes "
        "evicted), labeled by tenant",
        ("tenant",),
    ),
    "noise_ec_object_rejects_total": (
        "counter",
        "PUTs refused at admission, labeled by reason (quota_bytes, "
        "quota_objects, unknown_tenant)",
        ("reason",),
    ),
    "noise_ec_object_shed_total": (
        "counter",
        "PUTs (before any encode) and cold-cache GETs (before any "
        "decode) shed by load control with 503 + Retry-After, labeled "
        "by reason (slo = health verdict degraded, hbm = device memory "
        "watermark breached); warm-cache GETs are never shed",
        ("reason",),
    ),
    "noise_ec_object_manifests": (
        "gauge",
        "Object manifests indexed across live stores",
        (),
    ),
    "noise_ec_object_tenant_bytes": (
        "gauge",
        "Logical bytes stored per tenant (quota accounting view)",
        ("tenant",),
    ),
    "noise_ec_object_cache_hits_total": (
        "counter",
        "Decoded-stripe cache lookups served from host RAM on the GET "
        "hot path (service/cache.py)",
        (),
    ),
    "noise_ec_object_cache_misses_total": (
        "counter",
        "Decoded-stripe cache lookups that missed and fell to the "
        "peer/decode tiers",
        (),
    ),
    "noise_ec_object_cache_evictions_total": (
        "counter",
        "Decoded-stripe cache entries dropped, labeled by reason (lru = "
        "capacity ceiling, pressure = HBM-watermark shrink, invalidate = "
        "address/stripe invalidation on DELETE/overwrite)",
        ("reason",),
    ),
    "noise_ec_object_cache_bytes": (
        "gauge",
        "Decoded stripe bytes resident in the object cache(s), read at "
        "collect time",
        (),
    ),
    "noise_ec_object_read_route_total": (
        "counter",
        "Underlying stripe fetches on the GET path by serving tier "
        "(cache = local decoded cache, local = trusted k-join from "
        "local shards, peer = a warm peer's /objects endpoint, decode "
        "= degraded reconstruct / anti-entropy); coalesced followers "
        "of one in-flight fetch do not double-count",
        ("route",),
    ),
    "noise_ec_object_put_seconds": (
        "histogram",
        "End-to-end PUT latency (admission through manifest broadcast)",
        (),
    ),
    "noise_ec_object_get_seconds": (
        "histogram",
        "End-to-end GET/range latency through stripe reads and decode",
        (),
    ),
    "noise_ec_object_op_seconds": (
        "histogram",
        "Per-tenant object op latency, labeled by tenant (capped at "
        "an 'other' bucket past the cardinality limit), op (put, get) "
        "and route — for GET the most expensive serving tier touched "
        "(cache < local < peer < decode), for PUT always encode; the "
        "series the tenant_isolation_p99_ratio gate reads",
        ("tenant", "op", "route"),
    ),
    "noise_ec_object_tenant_shed_total": (
        "counter",
        "Object ops shed by load control attributed to the requesting "
        "tenant, labeled by tenant and reason (slo, hbm)",
        ("tenant", "reason"),
    ),
    # --- hedged reads (service/objects.py, docs/object-service.md
    # "Read path": the hedge tier's trigger/cancel/accounting contract)
    "noise_ec_hedge_requests_total": (
        "counter",
        "Stripe fetches that entered the hedged fetch engine (>= 2 "
        "ranked sources available, hedging enabled)",
        (),
    ),
    "noise_ec_hedge_wins_total": (
        "counter",
        "Hedged fetches won by a hedge (a source launched AFTER the "
        "primary because the per-peer p95 trigger fired)",
        (),
    ),
    "noise_ec_hedge_cancelled_total": (
        "counter",
        "Losing in-flight fetches aborted after another source won "
        "(connection closed, worker reaped — never leaked)",
        (),
    ),
    "noise_ec_hedge_late_total": (
        "counter",
        "Losing fetches that completed between the winner's arrival "
        "and their cancellation (work done, result discarded)",
        (),
    ),
    "noise_ec_peer_fetch_seconds": (
        "histogram",
        "Warm-peer stripe fetch latency per peer endpoint (capped at "
        "an 'other' bucket past the cardinality limit) — the per-peer "
        "distribution whose p95 arms the hedge trigger",
        ("peer",),
    ),
    # --- host<->device data path (ops/coalesce.py, ops/dispatch.py
    # buffer pool; docs/design.md "host<->device data path" owns the
    # buffer lifecycle and flush policy those series instrument)
    "noise_ec_coalesce_batches_total": (
        "counter",
        "Coalesced dispatches flushed by the live-path coalescer (each "
        "covers >= 1 member requests)",
        (),
    ),
    "noise_ec_coalesce_batch_size": (
        "histogram",
        "Batch size each coalesced request rode (one observation per "
        "member request, so the p50 answers 'was a typical request "
        "amortized')",
        (),
    ),
    "noise_ec_coalesce_flush_reason_total": (
        "counter",
        "Why each coalesced batch flushed, labeled by reason (solo = "
        "idle dispatcher, immediate; linger = latency budget expired; "
        "full = max_batch reached; bulk = explicit pre-formed batch; "
        "shared = single-flight result broadcast, submit_shared)",
        ("reason",),
    ),
    "noise_ec_device_buffer_pool_hits_total": (
        "counter",
        "Staging-buffer acquisitions served from the device buffer pool "
        "(no allocation, pad tail already zero)",
        (),
    ),
    "noise_ec_device_buffer_pool_misses_total": (
        "counter",
        "Staging-buffer acquisitions that allocated a fresh zeroed page",
        (),
    ),
    # --- mesh dispatch tier (parallel/mesh.py; docs/design.md §13 owns
    # the axis layout, tier decision table and donation-on-mesh rules)
    "noise_ec_mesh_devices": (
        "gauge",
        "Devices the active codec mesh spans (1 = single-device tier; "
        "the power-of-two floor of the router's device list when the "
        "mesh dispatch tier is enabled)",
        (),
    ),
    "noise_ec_mesh_sharded_dispatches_total": (
        "counter",
        "Batched codec dispatches sharded over the stripes mesh axis, "
        "labeled by tier (shard_map = manual-SPMD Pallas words pipeline, "
        "pjit = GSPMD-partitioned XLA planes pipeline)",
        ("mode",),
    ),
    "noise_ec_mesh_shard_bytes": (
        "histogram",
        "Per-device payload bytes of each mesh-sharded dispatch (total "
        "batch bytes over the mesh width)",
        (),
    ),
    "noise_ec_mesh_reshard_total": (
        "counter",
        "Committed device inputs that arrived at a mesh program with a "
        "different sharding than its pinned in_shardings (a resharding "
        "transfer; stays 0 on chained encode->decode paths whose "
        "out_shardings match the next stage)",
        (),
    ),
    # --- backpressure (ops/dispatch.py device gate, host/transport.py
    # dispatcher; docs/fleet.md owns the propagation story)
    "noise_ec_backpressure_waits_total": (
        "counter",
        "Times a producer blocked on a bounded queue instead of growing "
        "it, labeled by layer (device = the device dispatch gate, "
        "dispatch = a sender's delivery window)",
        ("layer",),
    ),
    "noise_ec_backpressure_wait_seconds": (
        "histogram",
        "Time producers spent blocked on a bounded queue, labeled by "
        "layer (device, dispatch)",
        ("layer",),
    ),
    "noise_ec_backpressure_queue_depth": (
        "gauge",
        "Occupied slots plus blocked producers per bounded queue, "
        "labeled by layer (device, dispatch), read at collect time",
        ("layer",),
    ),
    # --- QoS lanes (ops/dispatch.py device gate; docs/object-service.md
    # "QoS lanes" owns the lane/weight grammar and starvation floor)
    "noise_ec_lane_queue_depth": (
        "gauge",
        "Waiters queued at the device gate per QoS lane (live, "
        "background), read at collect time",
        ("lane",),
    ),
    "noise_ec_lane_grants_total": (
        "counter",
        "Contended device-gate grants by QoS lane (live, background) — "
        "the background share proves the starvation floor drains",
        ("lane",),
    ),
    # --- fleet lab (noise_ec_tpu/fleet, docs/fleet.md)
    "noise_ec_fleet_peers": (
        "gauge",
        "In-process fleet peers by state (up, down), read at collect "
        "time while a lab is live",
        ("state",),
    ),
    "noise_ec_fleet_messages_total": (
        "counter",
        "Fleet traffic submissions admitted, labeled by kind (chat, "
        "object, repair, get = a zipfian hot read through a peer's "
        "service layer)",
        ("kind",),
    ),
    "noise_ec_fleet_deliveries_total": (
        "counter",
        "Verified fleet deliveries observed by receiver peers",
        (),
    ),
    "noise_ec_fleet_shed_total": (
        "counter",
        "Fleet submissions shed at admission with a Retry-After hint "
        "(scored separately from lost), labeled by reason (slo)",
        ("reason",),
    ),
    "noise_ec_fleet_lost_total": (
        "counter",
        "Expected fleet deliveries scored as lost (not delivered, not "
        "shed, receiver not churned mid-flight)",
        (),
    ),
    "noise_ec_fleet_churn_events_total": (
        "counter",
        "Churn schedule transitions applied to fleet peers, labeled by "
        "event (kill, restart)",
        ("event",),
    ),
    # --- metrics federation (obs/federate.py, docs/observability.md
    # "Metrics federation")
    "noise_ec_federate_scrapes_total": (
        "counter",
        "Peer /metrics scrape attempts by the federator, labeled by "
        "result (ok, error, skipped = per-peer breaker open)",
        ("result",),
    ),
    "noise_ec_federate_scrape_errors_total": (
        "counter",
        "Failed peer /metrics scrapes, labeled by peer (capped at an "
        "'other' bucket past the cardinality limit)",
        ("peer",),
    ),
    "noise_ec_federate_peers": (
        "gauge",
        "Federation scrape targets by state (up = last scrape ok, "
        "down = last scrape failed or breaker open), read at collect "
        "time",
        ("state",),
    ),
    "noise_ec_federate_series": (
        "gauge",
        "Samples in the last merged fleet exposition document",
        (),
    ),
    "noise_ec_federate_scrape_seconds": (
        "histogram",
        "Wall time of one full federation scrape+merge cycle across "
        "all targets",
        (),
    ),
    # --- flight recorder (obs/recorder.py, docs/observability.md
    # "Flight recorder")
    "noise_ec_incident_bundles_total": (
        "counter",
        "Incident bundles written by the flight recorder, labeled by "
        "trigger (flip = SLO verdict healthy->degraded, request = GET "
        "/incident); rate-limit-suppressed captures are not counted",
        ("trigger",),
    ),
    "noise_ec_incident_ring_bytes": (
        "gauge",
        "Serialized bytes currently held in the flight recorder ring "
        "(bounded by its byte cap), read at collect time",
        (),
    ),
    # --- wide events + diagnosis (obs/events.py, obs/diagnose.py,
    # docs/observability.md "Wide events" / "Diagnosis")
    "noise_ec_events_total": (
        "counter",
        "Wide structured events recorded by the event log, labeled by "
        "event name (the bounded EVENT_NAMES vocabulary) and severity; "
        "rate-limit-suppressed emissions are counted separately",
        ("name", "severity"),
    ),
    "noise_ec_events_suppressed_total": (
        "counter",
        "Event emissions dropped by the per-name token bucket, labeled "
        "by event name; the next surviving record of that name carries "
        "the dropped count as its `suppressed` attr",
        ("name",),
    ),
    "noise_ec_event_ring_bytes": (
        "gauge",
        "Approximate bytes currently pinned by the wide-event ring "
        "(bounded by the log's byte cap), set on every emit",
        (),
    ),
    "noise_ec_diagnose_runs_total": (
        "counter",
        "Diagnosis-engine runs, labeled by trigger (flip = SLO "
        "healthy->degraded listener, request = GET /diagnose, "
        "bundle = flight-recorder capture embedding)",
        ("trigger",),
    ),
    "noise_ec_diagnose_seconds": (
        "histogram",
        "Wall time of one diagnosis run (every verdict rule evaluated "
        "over the registry deltas, event window and kept traces)",
        (),
    ),
    # --- wire hot loop (host/transport.py, docs/design.md §15)
    "noise_ec_wire_verify_batch_size": (
        "histogram",
        "Frames per batched Ed25519 verify on the receive drain "
        "(1 = an idle link paying zero added latency)",
        (),
    ),
    "noise_ec_wire_verified_frames_total": (
        "counter",
        "Wire frames through the batched verify stage, labeled by "
        "outcome (ok, bad)",
        ("outcome",),
    ),
    "noise_ec_wire_verify_fallbacks_total": (
        "counter",
        "Verify batches whose combined equation failed and fanned back "
        "to per-item verification (≈ cohorts containing a bad signature)",
        (),
    ),
    "noise_ec_wire_frames_per_syscall": (
        "histogram",
        "Frames coalesced into one send-side socket flush (sendmsg "
        "iovec or single buffered write)",
        (),
    ),
    "noise_ec_wire_syscalls_saved_total": (
        "counter",
        "Send syscalls avoided by coalescing (frames flushed minus "
        "flush calls)",
        (),
    ),
    "noise_ec_wire_frames_per_fill": (
        "histogram",
        "Complete frames parsed in place per recv-ring fill",
        (),
    ),
    "noise_ec_wire_ring_bytes": (
        "histogram",
        "Bytes left unparsed in the recv ring after each fill (a frame "
        "straddling the next fill)",
        (),
    ),
    "noise_ec_wire_shards_per_frame": (
        "histogram",
        "Shards carried per SHARD_BATCH frame on the send path (one "
        "signature amortized over the cohort)",
        (),
    ),
    "noise_ec_wire_recv_shards": (
        "gauge",
        "SO_REUSEPORT acceptor shards serving this node's listen port",
        (),
    ),
    # --- shard mempool (host/mempool.py)
    "noise_ec_mempool_pools": (
        "gauge",
        "Reassembly pools open across live ShardPools",
        (),
    ),
    "noise_ec_mempool_pinned_bytes": (
        "gauge",
        "Share bytes pinned across live ShardPools",
        (),
    ),
    "noise_ec_mempool_evictions_total": (
        "counter",
        "Pools dropped, labeled by reason (ttl, explicit, overflow)",
        ("reason",),
    ),
    # --- placement ring (noise_ec_tpu/placement/, docs/placement.md)
    "noise_ec_placement_shards": (
        "gauge",
        "Shards held inside their ring-assigned failure domain, labeled "
        "by domain — settles to exact ring ownership as rebalance "
        "converges",
        ("domain",),
    ),
    "noise_ec_placement_moves_total": (
        "counter",
        "Rebalancer shard movements, labeled by reason (delta, deferred, "
        "dropped, migrate)",
        ("reason",),
    ),
    "noise_ec_placement_fanout_saved_total": (
        "counter",
        "Per-peer shard deliveries avoided by targeted placement sends "
        "versus a full broadcast of the same cohort",
        (),
    ),
}

# Families only the port records. Its codec breaker refuses a tripped
# product (ops/dispatch.py) where the reference's serves it from the host
# and counts it in noise_ec_codec_fallback_total, which the port declares
# above as a copy and never records. The batch families time and count
# the words entries from inside (parallel/batch.py, obs/device.py).
PORT_METRICS: dict[str, tuple[str, str, tuple[str, ...]]] = {
    "noise_ec_codec_refused_total": (
        "counter",
        "Encode/reconstruct products the device codec refused with "
        "CodecUnavailableError (nothing ran in their place), labeled by "
        "reason (error = device dispatch failed after retry and tripped "
        "the breaker, open = breaker not closed)",
        ("reason",),
    ),
    "noise_ec_kernel_launches": (
        "gauge",
        "Launches of each hand-written CUDA kernel in this process since "
        "the last ops.reset_launch_counts (read at collect time; exposed "
        "once a codec on a CUDA device exists)",
        ("kernel",),
    ),
    "noise_ec_batch_pattern_misses_total": (
        "counter",
        "Erasure patterns a BatchCodec planned (recovery matrix and row "
        "order) because its pattern cache did not hold them, labeled by "
        "entry (reconstruct_batch, reconstruct_batch_words)",
        ("entry",),
    ),
    "noise_ec_batch_device_seconds": (
        "histogram",
        "Device seconds of one BatchCodec words entry between CUDA timing "
        "events on its stream at its start and end, labeled by entry "
        "(encode_batch_words, reconstruct_batch_words); recorded only "
        "while a torch.profiler capture runs (GET /xprof)",
        ("entry",),
    ),
    "noise_ec_batch_assembly_total": (
        "counter",
        "BatchCodec words rebuilds by how the codeword was assembled, "
        "labeled by entry (reconstruct_batch_words) and path (in_place = "
        "written once, the lost rows stored by K5 through its row maps; "
        "gathered = the basis rows gathered, the product concatenated "
        "and put in order)",
        ("entry", "path"),
    ),
}
METRICS.update(PORT_METRICS)

# Bucket layout per histogram metric (export needs them fixed per family).
_HISTOGRAM_BUCKETS: dict[str, tuple[float, ...]] = {
    "noise_ec_decode_bytes": SIZE_BUCKETS,
    # Device dispatches live in the us range; the host-scale x2 buckets
    # collapse sub-0.1 ms ops into one bin (obs/metrics.py).
    "noise_ec_device_op_seconds": DEVICE_LATENCY_BUCKETS,
    # Small-integer counts: batch sizes, not latencies.
    "noise_ec_coalesce_batch_size": (
        1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
    ),
    # Payload bytes per device per sharded dispatch.
    "noise_ec_mesh_shard_bytes": SIZE_BUCKETS,
    # Wire hot loop: small-integer frame/shard counts + ring occupancy.
    "noise_ec_wire_verify_batch_size": (
        1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
    ),
    "noise_ec_wire_frames_per_syscall": (
        1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
        128.0, 256.0,
    ),
    "noise_ec_wire_frames_per_fill": (
        1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
        128.0, 256.0,
    ),
    "noise_ec_wire_shards_per_frame": (
        1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
    ),
    "noise_ec_wire_ring_bytes": SIZE_BUCKETS,
}


class _Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta


class _Gauge:
    __slots__ = ("value", "_lock", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self.value = 0.0
        self._lock = threading.Lock()
        self.fn = fn  # callback gauges are read at collect time

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta

    def read(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0
                return 0.0
        return self.value


class Family:
    """One named metric family; children keyed by label-value tuples."""

    def __init__(self, name: str, mtype: str, help_text: str,
                 label_names: tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.type = mtype
        self.help = help_text
        self.label_names = label_names
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _make_child(self):
        if self.type == "counter":
            return _Counter()
        if self.type == "gauge":
            return _Gauge()
        return Histogram(self.buckets or LATENCY_BUCKETS)

    def labels(self, **labels: str):
        """Child for the given label values (created on first use)."""
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def set_callback(self, fn: Callable[[], float], **labels: str) -> None:
        """Install a collect-time callback gauge child (queue depths and
        other live values that would be racy to mirror on every event).

        An existing child is mutated IN PLACE rather than replaced:
        callers cache ``labels()`` handles, and a handle grabbed before
        the owning object registered its callback (or re-grabbed after a
        test-isolation reset dropped the callback) must start reading
        the live value, not a dead zero."""
        if self.type != "gauge":
            raise ValueError(f"{self.name} is a {self.type}, not a gauge")
        key = tuple(str(labels.get(k, "")) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is not None:
                child.fn = fn
            else:
                self._children[key] = _Gauge(fn)

    def children(self) -> Iterable[tuple[tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class Registry:
    """Named metric families, validated against :data:`METRICS`."""

    def __init__(self, declarations: Optional[dict] = None):
        self._declarations = declarations if declarations is not None else METRICS
        self._families: dict[str, Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, mtype: str) -> Family:
        decl = self._declarations.get(name)
        if decl is None:
            raise KeyError(
                f"metric {name!r} is not declared in obs.registry.METRICS; "
                "add it there"
            )
        if decl[0] != mtype:
            raise TypeError(
                f"metric {name!r} is declared as {decl[0]}, requested as "
                f"{mtype}"
            )
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Family(
                    name, mtype, decl[1], decl[2],
                    buckets=_HISTOGRAM_BUCKETS.get(name),
                )
            return fam

    def counter(self, name: str) -> Family:
        return self._family(name, "counter")

    def gauge(self, name: str) -> Family:
        return self._family(name, "gauge")

    def histogram(self, name: str) -> Family:
        return self._family(name, "histogram")

    def collect(self) -> list[Family]:
        """Families in declaration order (stable exposition output)."""
        with self._lock:
            fams = dict(self._families)
        return [fams[n] for n in self._declarations if n in fams]

    def reset_values(self) -> None:
        """Zero every child's recorded state IN PLACE: counter and gauge
        values, histogram counts + exemplars. Child identity is kept, so
        references cached by instrumented layers stay live and keep
        recording. Callback-gauge children are DROPPED: their closures
        pin whatever object registered them (a gate, a lab) and would
        keep exporting a dead object's state across a test boundary —
        the next object's ``set_callback`` re-creates the child. This is
        the tests' isolation boundary (a per-test fixture), not a
        production surface: a running node never resets its registry."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam._lock:
                for key, child in list(fam._children.items()):
                    if isinstance(child, _Counter):
                        child.value = 0.0
                    elif isinstance(child, _Gauge):
                        if child.fn is not None:
                            del fam._children[key]
                        else:
                            child.value = 0.0
                    else:
                        child.reset()


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry the instrumented layers record into."""
    return _default


def set_build_info(backend: str = "cuda",
                   kernel: str = "pack,gf2mm,fused,panel,dense,mxu",
                   version: Optional[str] = None,
                   registry: Optional[Registry] = None) -> None:
    """Publish the ``noise_ec_build_info`` identity gauge (value 1).

    Scrapes pivot dashboards on it (``noise_ec_build_info * on()
    group_left(version) ...``); call once at node startup. The port's
    defaults name its backend, "cuda", and its kernel sources
    (``noise_ec_tpu_torch/csrc/<name>.cu``, the ones ``ops._build`` links
    into one library)."""
    if version is None:
        from noise_ec_tpu_torch import __version__ as version
    reg = registry if registry is not None else default_registry()
    reg.gauge("noise_ec_build_info").labels(
        backend=backend, kernel=kernel, version=version
    ).set(1)
