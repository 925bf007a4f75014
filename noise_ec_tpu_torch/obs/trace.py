"""In-process span tracer: per-stage timings keyed by message identity.

Port of ``noise_ec_tpu.obs.trace``, whole; the port's node opens its
spans (host/plugin.py, host/transport.py) and the port's event log stamps
each record from :func:`default_tracer` (obs/events.py).

Dapper-style attribution without the distributed machinery: a *span* is
one timed stage (``span("decode", key=...)``), a *trace* is every span
sharing a trace id. The trace id is derived from the message/stream key —
the ``file_signature`` hex prefix the plugin already logs — so the stages
of one object's journey correlate across threads (send path on the
caller's thread, receive path on a dispatch worker) and across the
sender/receiver boundary inside one process (the loopback harness), with
no context propagation protocol.

Nesting is thread-local: a span opened while another is active on the
same thread becomes its child and inherits its trace id unless it carries
its own ``key``. A key may also be attached mid-span (``sp.set_key(...)``
— the send path only knows the signature after signing).

Finished spans land in a bounded ring buffer (oldest evicted) and feed
the ``noise_ec_stage_seconds`` histogram + ``noise_ec_spans_total``
counter in the default registry, so the dump API serves forensics while
the export surface serves percentiles.

Cross-node mergeability (docs/observability.md "Distributed tracing"):
every finished span carries a monotonically increasing ``seq`` (the
``?since=`` cursor on ``/spans``), the tracer carries an optional *node
identity* (transport address + pubkey prefix, :meth:`Tracer.set_node`),
and :func:`clock_anchor` publishes the process's monotonic→wall-clock
anchor — together enough for ``obs/collector.py`` to pull dumps from
many processes, align their clocks and join spans sharing a signature
prefix into one distributed trace.

Overhead per span: two clock reads, one deque append under a lock, one
histogram observe — per *message stage*, not per kernel call, so the
encode hot loop (``record_kernel``) keeps its two counter adds.

Request-scoped tracing (docs/observability.md "Request tracing"): a
user-facing op opens :func:`request`, which mints a ``req-<16 hex>``
trace id, roots a ``request`` span, and — unlike signature-keyed
pipeline spans — routes every span of that trace into a *holding
buffer* instead of the ring. At root exit a tail-sampling policy
decides the trace's fate: error/shed traces and traces slower than the
wired per-op p95 (:meth:`Tracer.set_p95_provider`) are always kept;
the clean remainder is kept 1-in-``sample_n`` by a seeded hash of the
trace id (deterministic for a fixed ``sample_seed`` + tracer
``epoch``, and independent of completion order); everything else is
discarded before it ever reaches the span ring or a collector. The
holding buffer is byte-bounded (``hold_max_bytes``): under a stampede
the oldest held trace is evicted whole (decision ``evicted``) rather
than letting in-flight traces grow RAM. A nested :func:`request` on
the same thread joins the active request (no second root, no second
sampling decision); :func:`current_trace_id` is how lower layers stamp
propagation headers and frame attrs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from hashlib import blake2b
from typing import Callable, Optional

from noise_ec_tpu_torch.obs.registry import Registry, default_registry

__all__ = [
    "SPAN_FIELDS",
    "RequestScope",
    "Span",
    "Tracer",
    "clock_anchor",
    "current_trace_id",
    "default_tracer",
    "node_attrs",
    "request",
    "span",
    "trace_key",
]

# Every key a span dict (Span.as_dict / Tracer.dump / GET /spans) may
# carry (docs/observability.md documents each one).
SPAN_FIELDS: tuple[str, ...] = (
    "seq", "trace_id", "name", "start", "seconds", "parent", "attrs",
    "error",
)


def trace_key(file_signature: bytes) -> str:
    """Canonical trace id for a message: the signature hex prefix (the
    same 16-char identity the plugin's logs and pool keys use)."""
    return file_signature[:8].hex()


# Wall-clock anchor: spans read ONE monotonic clock on entry/exit; the
# dump derives wall time from this pair instead of a second clock read
# per span (span enter/exit is on the per-shard delivery path).
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def clock_anchor() -> dict:
    """The process's monotonic→wall-clock anchor plus a fresh wall-clock
    reading. ``/spans`` publishes this so a collector can estimate the
    peer clock offset from the request RTT midpoint (``now`` is the
    server's wall clock at render time)."""
    return {"wall": _WALL0, "perf": _PERF0, "now": time.time()}


class Span:
    """One live (then finished) stage timing. Mutable until exit.

    Its own context manager (not ``@contextlib.contextmanager``): the
    generator machinery tripled the per-span cost on the per-shard
    delivery path (~9 us -> ~3 us measured)."""

    __slots__ = (
        "name", "key", "attrs", "parent", "start", "end",
        "trace_id", "error", "seq", "_tracer",
    )

    def __init__(self, tracer: "Tracer", name: str, key: Optional[str],
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.key = key
        self.parent: Optional["Span"] = None
        self.attrs = attrs
        self.start = 0.0
        self.end = 0.0
        self.trace_id: Optional[str] = None
        self.error: Optional[str] = None
        self.seq = 0

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        if stack:
            self.parent = stack[-1]
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter()
        if exc is not None:
            self.error = repr(exc)
        tracer = self._tracer
        tracer._stack().pop()
        self.trace_id = self._resolve_trace_id(tracer)
        tracer._land(self)
        tracer._record_stage(self)
        return False  # propagate any exception

    def set_key(self, key: str) -> None:
        """Attach the trace key mid-span (send path: known after sign)."""
        self.key = key

    def set_attr(self, **attrs) -> None:
        """Attach attrs mid-span (outcome/bytes known only at the end
        of a fetch)."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _resolve_trace_id(self, tracer: "Tracer") -> str:
        # Own key wins; else nearest ancestor's key/resolved id; else a
        # fresh anonymous id (standalone spans still dump coherently).
        if self.key is not None:
            return self.key
        node = self.parent
        while node is not None:
            if node.key is not None:
                return node.key
            if node.trace_id is not None:
                return node.trace_id
            node = node.parent
        return f"anon-{tracer._next_anon()}"

    def as_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "trace_id": self.trace_id,
            "name": self.name,
            "start": _WALL0 + (self.start - _PERF0),
            "seconds": self.seconds,
            "parent": self.parent.name if self.parent is not None else None,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error is not None:
            d["error"] = self.error
        return d


class _NoopSpan:
    __slots__ = ()

    def set_key(self, key: str) -> None:
        pass

    def set_attr(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


# Approximate held-span RAM cost: object + dict overhead plus the
# variable-length text it carries. Exact byte accounting would cost a
# sys.getsizeof walk per span on the request path; the bound only needs
# to be proportional to what the holding buffer actually pins.
_SPAN_BASE_COST = 120


def _span_cost(sp: Span) -> int:
    cost = _SPAN_BASE_COST + len(sp.name)
    for key, value in sp.attrs.items():
        cost += len(key) + len(str(value))
    return cost


class RequestScope:
    """One request-scoped trace: root span + tail-sampling decision.

    Context manager. ``__enter__`` registers the trace's holding buffer
    and roots a ``request`` span (keyed by the trace id, so every child
    span on the thread inherits it); ``__exit__`` closes the root and
    commits the trace through the tail sampler. ``exemplar`` is the
    histogram-exemplar hook: a callable resolving to the trace id iff
    the trace was KEPT — pass it (unresolved) to
    ``Histogram.observe(..., exemplar=scope.exemplar)`` and the
    decision is read at snapshot/render time, after it exists."""

    __slots__ = ("tracer", "op", "trace_id", "attrs", "decision", "_root",
                 "_owner")

    def __init__(self, tracer: "Tracer", op: str,
                 trace_id: Optional[str], attrs: dict):
        self.tracer = tracer
        self.op = op
        self.trace_id = trace_id or tracer._mint_request_id()
        self.attrs = attrs
        self.decision: Optional[str] = None
        self._root: Optional[Span] = None
        self._owner = True

    def __enter__(self) -> "RequestScope":
        tr = self.tracer
        with tr._lock:
            # Ownership: the scope that REGISTERS the holding buffer is
            # the one that commits it. An adopted id already held in
            # THIS tracer means the originating request is in flight in
            # the same process (single-process rigs: the fleet lab,
            # loopback tests) — this serving leg's spans merge into that
            # buffer and the originator alone makes the sampling
            # decision. Cross-process (the production shape) each
            # tracer holds its own buffer, so each side is an owner and
            # samples its own leg.
            self._owner = self.trace_id not in tr._held
            if self._owner:
                tr._held[self.trace_id] = []
                tr._held_bytes[self.trace_id] = 0
        tr._request_stack().append(self)
        attrs = {"op": self.op}
        attrs.update(self.attrs)
        if tr.node is not None:
            attrs.setdefault("node", tr.node["id"])
        self._root = Span(tr, "request", self.trace_id, attrs)
        self._root.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        root = self._root
        root.__exit__(exc_type, exc, tb)
        stack = self.tracer._request_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._owner:
            self.decision = self.tracer._commit(
                self, error=root.error is not None
            )
        return False  # propagate any exception

    @property
    def seconds(self) -> float:
        return self._root.seconds if self._root is not None else 0.0

    @property
    def kept(self) -> bool:
        return bool(self.decision and self.decision.startswith("kept"))

    def exemplar(self) -> Optional[str]:
        """The trace id iff sampling kept this trace (else None) — the
        deferred resolver histogram exemplars call at snapshot time."""
        return self.trace_id if self.kept else None


class _JoinScope:
    """A nested :func:`request` on a thread that already has one: joins
    the active root — same trace id, no second root span, no second
    sampling decision. Exemplars delegate to the root's."""

    __slots__ = ("_root",)

    def __init__(self, root: RequestScope):
        self._root = root

    @property
    def trace_id(self) -> str:
        return self._root.trace_id

    @property
    def decision(self) -> Optional[str]:
        return self._root.decision

    @property
    def kept(self) -> bool:
        return self._root.kept

    def exemplar(self) -> Optional[str]:
        return self._root.exemplar()

    def __enter__(self) -> "_JoinScope":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


class _NoopRequest:
    """Tracing disabled: carries no id, keeps nothing."""

    __slots__ = ()
    trace_id = None
    decision = None
    kept = False

    def exemplar(self) -> None:
        return None

    def __enter__(self) -> "_NoopRequest":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_REQUEST = _NoopRequest()


class Tracer:
    """Span recorder with ring-buffer retention (see module doc)."""

    def __init__(self, capacity: int = 4096,
                 registry: Optional[Registry] = None):
        self.enabled = True
        self.capacity = capacity
        # Incarnation id: a fresh tracer (process restart) starts its
        # seq counter over at 0, so ``/spans`` publishes this epoch and
        # the collector keys its dedup/cursor state on (epoch, seq) —
        # a restarted peer's re-used seqs are new spans, not duplicates.
        self.epoch = time.time_ns()
        self._ring: deque = deque(maxlen=capacity)  # Span or ingested dict
        self._lock = threading.Lock()
        self._local = threading.local()
        self._anon_n = 0
        self._seq = 0
        self._registry = registry
        self._stage_hist = None
        self._span_counter = None
        self._stage_children: dict[str, object] = {}
        # Node identity (set_node): stamps this process's dumps so a
        # collector can tell whose spans it merged.
        self.node: Optional[dict] = None
        # --- tail-sampled request tracing (module docstring) ---
        # Keep 1 in sample_n clean-path traces; error/shed and slower-
        # than-p95 traces are always kept. The seed + epoch make the
        # kept set deterministic for a fixed request order.
        self.sample_n = 20
        self.sample_seed = 0
        # Byte bound on everything the holding buffer may pin at once;
        # overflow evicts the oldest held trace whole.
        self.hold_max_bytes = 1 << 20
        # trace id -> held spans (None marks a trace evicted under byte
        # pressure: its remaining spans drop on sight).
        self._held: dict[str, Optional[list]] = {}
        self._held_bytes: dict[str, int] = {}
        self._held_total = 0
        self._req_n = 0
        self._p95_provider: Optional[Callable[[str], Optional[float]]] = None
        self._req_counter = None
        self._req_children: dict[str, object] = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_anon(self) -> int:
        with self._lock:
            self._anon_n += 1
            return self._anon_n

    def _request_stack(self) -> list:
        st = getattr(self._local, "requests", None)
        if st is None:
            st = self._local.requests = []
        return st

    # --------------------------------------------------------- node identity

    def set_node(self, address: str, public_key: Optional[bytes] = None) -> None:
        """Attach this process's node identity (transport address + pubkey
        prefix) to the tracer. ``/spans`` publishes it as the dump's
        ``node`` metadata; the short ``id`` is what collectors use as the
        per-node track name in merged traces."""
        pk8 = bytes(public_key[:8]).hex() if public_key else ""
        self.node = {
            "address": address,
            "pubkey": pk8,
            "id": f"{address}#{pk8}" if pk8 else address,
        }

    def node_label(self) -> str:
        """Short node id (``address#pk8``) or '' when unset."""
        return self.node["id"] if self.node is not None else ""

    def _record_stage(self, sp: Span) -> None:
        reg = self._registry if self._registry is not None else default_registry()
        if self._stage_hist is None:
            self._stage_hist = reg.histogram("noise_ec_stage_seconds")
            self._span_counter = reg.counter("noise_ec_spans_total")
        # Cache children per stage name: labels() is a lock + dict get,
        # and span exit is on the delivery path.
        pair = self._stage_children.get(sp.name)
        if pair is None:
            pair = self._stage_children[sp.name] = (
                self._stage_hist.labels(stage=sp.name),
                self._span_counter.labels(stage=sp.name),
            )
        pair[0].observe(sp.seconds)
        pair[1].add(1)

    def span(self, name: str, key: Optional[str] = None, **attrs):
        """Time a stage: ``with tracer.span("decode", key=...) as sp``.
        Returns the live :class:`Span` (or a shared no-op when tracing is
        disabled); exceptions are recorded and re-raised."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, key, attrs)

    # ------------------------------------------- request-scoped tracing

    def request(self, op: str, trace_id: Optional[str] = None, **attrs):
        """Open a request-scoped trace for one user-facing op (module
        docstring). A nested call on a thread with an active request
        JOINS it (one root, one sampling decision per request, however
        many layers re-enter). ``trace_id`` adopts a propagated id (the
        ``X-NoiseEC-Trace`` header) instead of minting."""
        if not self.enabled:
            return _NOOP_REQUEST
        stack = self._request_stack()
        if stack:
            return _JoinScope(stack[-1])
        return RequestScope(self, op, trace_id, attrs)

    def current_trace_id(self) -> Optional[str]:
        """The active request's trace id on this thread (None outside a
        request scope) — what propagation headers and frame attrs carry."""
        st = getattr(self._local, "requests", None)
        return st[-1].trace_id if st else None

    def set_p95_provider(
        self, provider: Optional[Callable[[str], Optional[float]]]
    ) -> None:
        """Wire the rolling per-op p95 feed (``provider(op) -> seconds``
        or None while the histogram is too thin to trust) — the
        slower-than-p95 keep rule of the tail sampler."""
        self._p95_provider = provider

    def held_bytes(self) -> int:
        """Bytes currently pinned by the holding buffer (tests assert
        the stampede bound)."""
        with self._lock:
            return self._held_total

    def _mint_request_id(self) -> str:
        # req- + 16 hex of blake2b(epoch:n): unique across processes
        # (epoch is the tracer incarnation), deterministic within one
        # tracer for the sampling-determinism tests (pin ``epoch``).
        with self._lock:
            self._req_n += 1
            n = self._req_n
        h = blake2b(f"{self.epoch}:{n}".encode(), digest_size=8)
        return f"req-{h.hexdigest()}"

    def _land(self, sp: Span) -> None:
        """Route one finished span: held traces buffer until their
        sampling decision; everything else goes straight to the ring."""
        with self._lock:
            held = self._held.get(sp.trace_id, False)
            if held is False:
                self._seq += 1
                sp.seq = self._seq
                self._ring.append(sp)
                return
            if held is None:
                return  # trace already evicted under byte pressure
            held.append(sp)
            cost = _span_cost(sp)
            self._held_bytes[sp.trace_id] += cost
            self._held_total += cost
            self._enforce_hold_bound_locked(sp.trace_id)

    def _enforce_hold_bound_locked(self, current: str) -> None:
        while self._held_total > self.hold_max_bytes:
            victim = next(
                (tid for tid, lst in self._held.items()
                 if lst is not None and tid != current),
                None,
            )
            if victim is not None:
                # Oldest OTHER held trace: evicted whole — its root will
                # observe the marker at commit and count ``evicted``.
                self._held[victim] = None
                self._held_total -= self._held_bytes.pop(victim, 0)
                continue
            # The current trace alone exceeds the bound: shed its oldest
            # spans (the root, appended last at exit, survives).
            lst = self._held.get(current)
            if not lst:
                break
            dropped = lst.pop(0)
            cost = _span_cost(dropped)
            self._held_bytes[current] -= cost
            self._held_total -= cost

    def _commit(self, scope: RequestScope, *, error: bool) -> str:
        """The tail-sampling decision at root exit: keep (spans move to
        the ring, seqs assigned in order) or drop (spans discarded)."""
        tid = scope.trace_id
        with self._lock:
            held = self._held.pop(tid, None)
            self._held_total -= self._held_bytes.pop(tid, 0)
        if held is None:
            decision = "evicted"
        else:
            decision = self._decide(scope.op, scope.seconds, error, tid)
            if decision != "dropped":
                with self._lock:
                    for sp in held:
                        self._seq += 1
                        sp.seq = self._seq
                        self._ring.append(sp)
        self._count_decision(decision)
        return decision

    def _decide(self, op: str, seconds: float, error: bool,
                tid: str) -> str:
        if error:
            return "kept_error"  # errors AND sheds (shed raises) stay
        p95 = None
        if self._p95_provider is not None:
            try:
                p95 = self._p95_provider(op)
            except Exception:  # noqa: BLE001 — a broken feed must not
                p95 = None     # fail the request path
        if p95 is not None and seconds >= p95:
            return "kept_slow"
        n = self.sample_n
        if n <= 1:
            return "kept_sampled"
        h = blake2b(f"{self.sample_seed}:{tid}".encode(), digest_size=8)
        if int.from_bytes(h.digest(), "big") % n == 0:
            return "kept_sampled"
        return "dropped"

    def _count_decision(self, decision: str) -> None:
        reg = (
            self._registry if self._registry is not None
            else default_registry()
        )
        if self._req_counter is None:
            self._req_counter = reg.counter("noise_ec_trace_requests_total")
        child = self._req_children.get(decision)
        if child is None:
            child = self._req_children[decision] = (
                self._req_counter.labels(decision=decision)
            )
        child.add(1)

    # ------------------------------------------------------------- dump API

    def dump(self, trace_id: Optional[str] = None,
             limit: Optional[int] = None,
             since: Optional[int] = None) -> list[dict]:
        """Finished spans (oldest first), optionally filtered to one
        trace, to spans recorded after the ``since`` cursor (a span
        ``seq``, exclusive), and/or truncated to the NEWEST ``limit`` —
        never the oldest, so a small limit still reports current work."""
        with self._lock:
            spans = [
                s.as_dict() if isinstance(s, Span) else s
                for s in self._ring
            ]
        if since is not None:
            spans = [s for s in spans if s["seq"] > since]
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        if limit is not None:
            spans = spans[-limit:]
        return spans

    def last_seq(self) -> int:
        """The newest span's ``seq`` — the ``since`` cursor a caller
        passes next time to receive only spans recorded after now."""
        with self._lock:
            return self._seq

    def ingest(self, span_dicts: list[dict]) -> None:
        """Load pre-finished span dicts (the :meth:`dump` shape) into the
        ring, assigning fresh local ``seq`` cursors. This is how a
        collector process re-serves merged spans — and how tests build a
        multi-node topology inside one process."""
        with self._lock:
            for d in span_dicts:
                d = dict(d)
                self._seq += 1
                d["seq"] = self._seq
                self._ring.append(d)

    def traces(self) -> dict[str, list[dict]]:
        """Spans grouped by trace id (insertion-ordered)."""
        out: dict[str, list[dict]] = {}
        for d in self.dump():
            out.setdefault(d["trace_id"], []).append(d)
        return out

    def stages(self, trace_id: str) -> set[str]:
        """Distinct stage names recorded for one trace."""
        return {d["name"] for d in self.dump(trace_id)}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._held.clear()
            self._held_bytes.clear()
            self._held_total = 0


_default = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer the instrumented layers record into."""
    return _default


def span(name: str, key: Optional[str] = None, **attrs):
    """``default_tracer().span(...)`` — the call sites' one-liner."""
    return _default.span(name, key, **attrs)


def request(op: str, trace_id: Optional[str] = None, **attrs):
    """``default_tracer().request(...)`` — the object-service layers'
    one-liner for opening (or joining) a request-scoped trace."""
    return _default.request(op, trace_id=trace_id, **attrs)


def current_trace_id() -> Optional[str]:
    """The active request trace id on this thread, or None — what the
    ``X-NoiseEC-Trace`` header and ``SHARD_BATCH`` trace attr carry."""
    return _default.current_trace_id()


def node_attrs() -> dict:
    """``{"node": <short id>}`` when the default tracer carries a node
    identity, else ``{}`` — for background-work spans (scrub/repair)
    whose traces are often anonymous: the attr keeps per-node
    attribution visible even after a fleet-wide merge."""
    label = _default.node_label()
    return {"node": label} if label else {}
