"""Wide structured events: the "why" layer over metrics and traces.

Port of ``noise_ec_tpu.obs.events``. In the port the codec breaker
(``codec.refused``, ``codec.restore``), the device gate (``qos.preempt``),
the coalescer (``qos.linger``) and the node's transport (``conn.*``,
``peer.drop``) emit; ``default_event_log().dump()`` reads the ring, and
``GET /events`` serves it on the stats server. Every record is stamped
from the span tracer (obs/trace.py ``default_tracer()``): the active
request's trace id and the node's short id (empty until the node calls
``set_node``). :func:`set_default_tracer` puts another stamp source in its
place, for tests.

Counters say *that* the fleet degraded; traces show *one* request's
journey. The wide-event log records every load-bearing DECISION the
node makes — a connection demoted, a codec breaker flipped, a hedge
that came back late, a tenant shed, a cache watermark shrink — as one
queryable record carrying the active request's trace id and the node
identity, following the wide-structured-event model of Scuba (Abraham
et al., VLDB 2013). The diagnosis engine (obs/diagnose.py) joins these
events back against registry deltas and sampler-kept traces to name a
probable cause on an SLO flip.

Model:

- ``event(name, severity, tenant=..., **attrs)`` appends one record to
  a byte-bounded ring (oldest evicted first) and bumps
  ``noise_ec_events_total{name,severity}``. The call NEVER raises and
  never blocks beyond one short lock — it sits on demotion/shed/hedge
  paths that must not grow a failure mode of their own.
- Every record auto-stamps the active request trace id
  (``obs.trace.current_trace_id()``) and the node's short id, so an
  event found in a window resolves to the exact request trace that
  triggered it (when the sampler kept it).
- Per-name token buckets rate-limit storms (a flapping breaker can
  emit thousands of identical events per second). Suppressed emissions
  are COUNTED, not lost: the next record of that name carries a
  ``suppressed`` attr with the number dropped since the last one, and
  ``noise_ec_events_suppressed_total{name}`` tracks the totals.
- ``GET /events?since=&name=&tenant=&limit=`` serves the ring on the
  stats-server route table, epoch-keyed exactly like ``/spans``: the
  document's ``epoch`` is the log incarnation and ``next_since`` is
  the cursor for the next poll, so a restarted node makes collectors
  restart from 0 instead of silently skipping records.

Event names are dot-scoped ``subsystem.decision`` literals (the
``EVENT_NAMES`` tuple is the bounded vocabulary — the ``name`` label on
``noise_ec_events_total`` stays enumerable the same way span stages
do). See docs/observability.md "Wide events".
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.trace import default_tracer

__all__ = [
    "EVENT_NAMES",
    "PORT_EVENT_NAMES",
    "EVENT_FIELDS",
    "EVENTS_DOC_FIELDS",
    "EventLog",
    "default_event_log",
    "event",
    "set_default_tracer",
]


# The bounded event vocabulary: every ``event("x.y", ...)`` literal in
# the package appears here (mirrors PIPELINE_STAGES for span names —
# the ``name`` label set on noise_ec_events_total must stay bounded).
EVENT_NAMES: tuple[str, ...] = (
    # host/transport.py — connection lifecycle decisions
    "conn.demote",          # duplicate connection demoted after mutual dial
    "conn.limbo_park",      # dying writer's frames parked awaiting reroute
    "conn.limbo_reroute",   # parked frames rerouted to surviving connection
    "conn.limbo_drop",      # parked frames dropped (no surviving route)
    "peer.drop",            # peer fully dropped from the transport
    # resilience/peers.py — supervisor membership decisions
    "peer.down",            # supervisor saw a connection loss
    "peer.up",              # re-dial succeeded, peer restored
    # ops/dispatch.py + ops/coalesce.py — device-path decisions
    "codec.fallback",       # device codec demoted to host fallback
    "codec.restore",        # canary probe succeeded, device route restored
    "qos.preempt",          # live lane granted ahead of waiting background
    "qos.linger",           # background flush lingered under live pressure
    # service/objects.py + service/cache.py — object-service decisions
    "object.shed",          # admission control rejected an op
    "hedge.win",            # hedged fetch won against the primary
    "hedge.cancel",         # losing hedge legs cancelled
    "hedge.late",           # a cancelled leg's reply arrived anyway
    "cache.shrink",         # decoded-object cache shrank its watermark
    # store/{repair,scrub,convert}.py — durability decisions
    "repair.giveup",        # NACK repair gave up on a stripe
    "scrub.corrupt",        # scrub flagged a corrupt shard
    "convert.swap",         # conversion atomically swapped generations
    # placement/rebalance.py — churn decisions
    "rebalance.diff",       # ownership diff computed after ring change
    "rebalance.defer",      # move deferred by the migration token bucket
)

# Names only the port emits: its codec breaker refuses a tripped product
# (ops/dispatch.py) where the reference's demotes it to the host
# ("codec.fallback", kept above as a copy and never emitted by the port).
PORT_EVENT_NAMES: tuple[str, ...] = (
    "codec.refused",        # device codec refused a product, nothing ran
)
EVENT_NAMES += PORT_EVENT_NAMES

# One event record's keys — the schema /events serves
# (docs/observability.md "Wide events").
EVENT_FIELDS: tuple[str, ...] = (
    "seq", "ts", "name", "severity", "node", "trace_id", "tenant",
    "attrs",
)

# Top-level keys of the GET /events JSON document.
EVENTS_DOC_FIELDS: tuple[str, ...] = (
    "node", "epoch", "next_since", "events",
)

_SEVERITIES = ("debug", "info", "warn", "error")

# Approximate per-record RAM cost: dict + small-field overhead plus the
# variable-length text carried (same bound-not-census philosophy as
# obs.trace._span_cost — exact sys.getsizeof walks would tax the very
# decision paths events instrument).
_EVENT_BASE_COST = 160


def _event_cost(rec: dict) -> int:
    cost = _EVENT_BASE_COST + len(rec["name"]) + len(rec["severity"])
    cost += len(rec["node"]) + len(rec["trace_id"] or "")
    cost += len(rec["tenant"] or "")
    for key, value in rec["attrs"].items():
        cost += len(key) + len(str(value))
    return cost


class EventLog:
    """Byte-bounded, rate-limited ring of wide structured events.

    ``max_bytes`` caps the ring's approximate RAM (oldest records
    evicted first); ``rate_per_name`` / ``burst_per_name`` parameterise
    the per-name token buckets (events/second refill and bucket
    depth). ``enabled=False`` turns ``emit`` into a cheap no-op — the
    bench's disabled leg and a kill switch for constrained deploys.
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        tracer=None,
        max_bytes: int = 1 << 20,
        rate_per_name: float = 50.0,
        burst_per_name: float = 100.0,
    ) -> None:
        self._registry = registry
        self._tracer = tracer
        self.max_bytes = int(max_bytes)
        self.rate = float(rate_per_name)
        self.burst = float(burst_per_name)
        self.enabled = True
        # Log incarnation (same contract as Tracer.epoch): /events
        # publishes it so a collector detects a restart — the seq
        # cursor reset to 0 — and re-fetches instead of skipping.
        self.epoch = time.time_ns()
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque()
        self._bytes = 0
        self._seq = 0
        # name -> [tokens, last_refill_monotonic]
        self._buckets: dict[str, list] = {}
        # name -> emissions suppressed since the last emitted record of
        # that name (folded into the next record's ``suppressed`` attr).
        self._pending_suppressed: dict[str, int] = {}
        # Cached metric children per (name, severity) — labels() is a
        # lock + dict get and emit sits on decision paths.
        self._count_children: dict[tuple, object] = {}
        self._supp_children: dict[str, object] = {}

    # ------------------------------------------------------------- emit

    def emit(self, name: str, severity: str = "info",
             tenant: Optional[str] = None, **attrs) -> None:
        """Record one decision event. Never raises: observability must
        not add failure modes to the paths it observes."""
        try:
            self._emit(name, severity, tenant, attrs)
        except Exception:  # noqa: BLE001 — the no-new-failure-modes
            # contract; a broken registry or clock must not take the
            # demotion/shed path down with it.
            pass

    def _emit(self, name: str, severity: str,
              tenant: Optional[str], attrs: dict) -> None:
        if not self.enabled:
            return
        if severity not in _SEVERITIES:
            severity = "info"
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None:
                bucket = self._buckets[name] = [self.burst, now]
            else:
                bucket[0] = min(
                    self.burst, bucket[0] + (now - bucket[1]) * self.rate
                )
                bucket[1] = now
            if bucket[0] < 1.0:
                # Suppressed, not lost: counted here, surfaced on the
                # next record of this name as its ``suppressed`` attr.
                self._pending_suppressed[name] = (
                    self._pending_suppressed.get(name, 0) + 1
                )
                suppressed_now = True
            else:
                bucket[0] -= 1.0
                suppressed_now = False
                carried = self._pending_suppressed.pop(name, 0)
        if suppressed_now:
            self._supp_child(name).add(1)
            return
        tracer = self._stamps()
        rec = {
            "ts": round(time.time(), 6),
            "name": name,
            "severity": severity,
            "node": tracer.node_label(),
            "trace_id": tracer.current_trace_id(),
            "tenant": tenant,
            "attrs": {k: _jsonable(v) for k, v in attrs.items()},
        }
        if carried:
            rec["attrs"]["suppressed"] = carried
        cost = _event_cost(rec)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            self._bytes += cost
            while self._bytes > self.max_bytes and len(self._ring) > 1:
                dropped = self._ring.popleft()
                self._bytes -= _event_cost(dropped)
            ring_bytes = self._bytes
        self._count_child(name, severity).add(1)
        self._ring_gauge().set(ring_bytes)

    # ---------------------------------------------------------- reading

    def dump(self, since: Optional[int] = None, name: Optional[str] = None,
             tenant: Optional[str] = None,
             limit: Optional[int] = None) -> list[dict]:
        """Records with ``seq > since``, newest last, optionally
        filtered by name prefix and tenant, capped at ``limit`` (the
        NEWEST ``limit`` survive — a lagging poller loses the oldest,
        which the byte cap was about to evict anyway)."""
        with self._lock:
            records = list(self._ring)
        if since is not None:
            records = [r for r in records if r["seq"] > since]
        if name is not None:
            records = [
                r for r in records
                if r["name"] == name or r["name"].startswith(name + ".")
            ]
        if tenant is not None:
            records = [r for r in records if r["tenant"] == tenant]
        if limit is not None and limit >= 0:
            records = records[-limit:] if limit else []
        return records

    def last_seq(self) -> int:
        """The newest record's seq — the ``next_since`` cursor."""
        with self._lock:
            return self._seq

    def ring_bytes(self) -> int:
        """Approximate bytes pinned by the ring (tests assert the cap)."""
        with self._lock:
            return self._bytes

    def suppressed_total(self, name: str) -> int:
        """Emissions of ``name`` suppressed and not yet folded into a
        record's ``suppressed`` attr (storm-accounting tests)."""
        with self._lock:
            return self._pending_suppressed.get(name, 0)

    def clear(self) -> None:
        """Drop records and limiter state; the epoch survives (a clear
        is test isolation, not a restart)."""
        with self._lock:
            self._ring.clear()
            self._bytes = 0
            self._buckets.clear()
            self._pending_suppressed.clear()

    # ------------------------------------------------------- HTTP route

    def attach(self, server) -> None:
        """Mount ``GET /events`` on a StatsServer (its route table)."""
        server.mount("GET", "/events", self._route_events)

    def _route_events(self, req: dict) -> tuple:
        q = req["query"]
        limit = since = None
        try:
            if "limit" in q:
                limit = int(q["limit"][0])
            if "since" in q:
                since = int(q["since"][0])
        except ValueError:
            return 400, "text/plain", b"bad cursor\n"
        name = q.get("name", [None])[0]
        tenant = q.get("tenant", [None])[0]
        tracer = self._stamps()
        # next_since is read BEFORE the dump (the /spans contract): an
        # event landing between the two reads is re-sent next poll
        # rather than skipped forever.
        doc = {
            "node": getattr(tracer, "node", None) or {},
            "epoch": self.epoch,
            "next_since": self.last_seq(),
            "events": self.dump(
                since=since, name=name, tenant=tenant, limit=limit
            ),
        }
        return 200, "application/json", json.dumps(doc, indent=1).encode()

    def _stamps(self):
        """The record stamp source: this log's tracer, else the one
        :func:`set_default_tracer` installed, else the process tracer."""
        if self._tracer is not None:
            return self._tracer
        return _stamp_override if _stamp_override is not None \
            else default_tracer()

    # ---------------------------------------------------- metric plumbing

    def _reg(self) -> Registry:
        return self._registry if self._registry is not None \
            else default_registry()

    def _count_child(self, name: str, severity: str):
        child = self._count_children.get((name, severity))
        if child is None:
            child = self._count_children[(name, severity)] = (
                self._reg().counter("noise_ec_events_total")
                .labels(name=name, severity=severity)
            )
        return child

    def _supp_child(self, name: str):
        child = self._supp_children.get(name)
        if child is None:
            child = self._supp_children[name] = (
                self._reg().counter("noise_ec_events_suppressed_total")
                .labels(name=name)
            )
        return child

    def _ring_gauge(self):
        return self._reg().gauge("noise_ec_event_ring_bytes").labels()


def _jsonable(value):
    """Attrs must survive json.dumps — coerce exotic values to str."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


_stamp_override = None


def set_default_tracer(tracer) -> None:
    """Stamp every record of a log built without a ``tracer`` from
    ``tracer`` (any object with ``node_label()`` and
    ``current_trace_id()``) instead of the process tracer; None restores
    the process tracer (obs/trace.py ``default_tracer()``)."""
    global _stamp_override
    _stamp_override = tracer


_default = EventLog()


def default_event_log() -> EventLog:
    """The process-wide event log the instrumented layers record into."""
    return _default


def event(name: str, severity: str = "info",
          tenant: Optional[str] = None, **attrs) -> None:
    """``default_event_log().emit(...)`` — the call sites' one-liner
    (and the literal the ``event-on-swallow`` analysis rule accepts as
    evidence a handler did not swallow silently)."""
    _default.emit(name, severity, tenant=tenant, **attrs)
