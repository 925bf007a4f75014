"""Distributed trace collection: pull `/spans` from peers, align clocks,
merge spans sharing a signature prefix into fleet-wide traces.

Dapper-style collection (Sigelman et al., 2010) with no agent on the
nodes beyond what they already run: every node's ``StatsServer`` serves
its tracer ring as a dump document (``{"node", "clock", "next_since",
"spans"}``); the collector polls those endpoints with a ``?since=``
cursor (so a poll moves only new spans, never the whole ring), estimates
each peer's wall-clock offset, and stamps every span with its node
identity and a clock-corrected start time. Spans from every node that
share a trace id — the message-signature prefix both sender and
receivers already key their spans by — then line up on one timeline.

Clock model: one NTP-style sample per poll. The peer reports its wall
clock (``clock.now``) at render time; the collector brackets the request
with its own wall-clock reads and assumes the render happened at the RTT
midpoint, so ``offset = peer_now - (t0 + t1) / 2`` with uncertainty
±RTT/2. The estimate with the smallest RTT across polls wins (least
queue-delayed sample), and the *applied* correction is the raw estimate
soft-thresholded by its own uncertainty: an offset the sample cannot
distinguish from zero is measurement noise, and applying it would skew
peers whose clocks actually agree (same host, NTP-disciplined fleet) by
up to RTT/2 — enough to break span nesting across nodes. Where the transport measured a HELLO handshake
RTT to the same peer (``TCPNetwork.handshake_rtts()``), that tighter
bound refines the *uncertainty* — the TCP-level handshake skips the
HTTP/json overhead, so it is the truer floor on one-way delay.

The collector is transport-agnostic on purpose: it correlates an HTTP
endpoint to a transport address through the dump's own ``node.address``
field, not through configuration.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Optional, Union

from noise_ec_tpu_torch.obs.trace import Tracer, default_tracer

__all__ = ["PeerClock", "TraceCollector", "estimate_offset"]

log = logging.getLogger("noise_ec_tpu_torch.obs")


class PeerClock:
    """Best clock-offset estimate for one peer.

    ``offset`` is peer_wall − local_wall (seconds): subtract it from a
    peer span's ``start`` to place it on the collector's timeline.
    """

    __slots__ = ("offset", "rtt", "uncertainty")

    def __init__(self, offset: float, rtt: float, uncertainty: float):
        self.offset = offset
        self.rtt = rtt
        self.uncertainty = uncertainty

    def applied_offset(self) -> float:
        """The correction actually applied to this peer's spans: the raw
        estimate shrunk toward zero by its own uncertainty (soft
        threshold). A sample cannot testify to any offset smaller than
        its error bound, so the sub-uncertainty part is noise — and on
        clock-agreeing peers applying it is what *introduces* skew."""
        mag = abs(self.offset) - self.uncertainty
        if mag <= 0.0:
            return 0.0
        return mag if self.offset > 0.0 else -mag

    def as_dict(self) -> dict:
        return {
            "offset": self.offset,
            "rtt": self.rtt,
            "uncertainty": self.uncertainty,
        }


def estimate_offset(
    t0: float, t1: float, peer_now: float,
    handshake_rtt: Optional[float] = None,
) -> PeerClock:
    """One NTP-style offset sample: the peer read ``peer_now`` somewhere
    inside our [t0, t1] request bracket; assume the midpoint. A measured
    transport handshake RTT (when smaller than the HTTP RTT) tightens
    the uncertainty bound without moving the midpoint estimate."""
    rtt = max(0.0, t1 - t0)
    offset = peer_now - (t0 + t1) / 2.0
    bound = rtt
    if handshake_rtt is not None and 0.0 < handshake_rtt < bound:
        bound = handshake_rtt
    return PeerClock(offset, rtt, bound / 2.0)


class TraceCollector:
    """Pull, align and merge spans from a set of peer `/spans` endpoints.

    ``peers`` are base URLs (``http://host:port``). ``tracer`` (default:
    the process tracer) contributes the local node's spans at zero
    offset. ``rtt_hints`` supplies transport-level handshake RTTs keyed
    by *transport address* — pass ``net.handshake_rtts`` (the bound
    method: hints are re-read every poll, so late handshakes count).
    """

    def __init__(
        self,
        peers: list[str],
        *,
        tracer: Optional[Tracer] = None,
        timeout: float = 5.0,
        rtt_hints: Union[
            Callable[[], dict[str, float]], dict[str, float], None
        ] = None,
        max_spans_per_node: int = 65536,
    ):
        self.peers = [p.rstrip("/") for p in peers]
        self.tracer = tracer if tracer is not None else default_tracer()
        self.timeout = timeout
        self._rtt_hints = rtt_hints
        self.max_spans_per_node = max_spans_per_node
        # Per-peer poll state: since cursor, clock estimate, node id,
        # tracer epoch (incarnation — detects a peer restart).
        self._cursors: dict[str, int] = {}
        self._epochs: dict[str, int] = {}
        self._clocks: dict[str, PeerClock] = {}
        self._nodes: dict[str, dict] = {}  # peer url -> node metadata
        # node id -> {(epoch, seq) -> stamped span dict}. seq dedups
        # re-sent spans (next_since is read before the dump on the
        # server, so overlap is possible by design); the epoch half
        # keeps a restarted peer's re-used seqs distinct from the old
        # incarnation's instead of silently dropping them.
        self._spans: dict[str, dict[tuple[int, int], dict]] = {}
        self._offsets: dict[str, float] = {}  # node id -> best wall offset
        self._local_cursor = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- polling

    def _hints(self) -> dict[str, float]:
        h = self._rtt_hints
        if h is None:
            return {}
        try:
            return dict(h() if callable(h) else h)
        except Exception:  # noqa: BLE001 — hints are best-effort
            return {}

    def _fetch(self, url: str) -> tuple[dict, float, float]:
        t0 = time.time()
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            doc = json.loads(resp.read())
        return doc, t0, time.time()

    def poll(self) -> int:
        """One collection pass over every peer plus the local tracer.
        Returns the number of newly ingested spans; a peer that fails to
        answer is skipped (logged), never fatal — collection is
        telemetry, not control."""
        new = 0
        hints = self._hints()
        for peer in self.peers:
            since = self._cursors.get(peer, 0)
            url = f"{peer}/spans?since={since}"
            try:
                doc, t0, t1 = self._fetch(url)
            except Exception as exc:  # noqa: BLE001 — peer down ≠ fatal
                log.debug("trace poll of %s failed: %s", peer, exc)
                continue
            epoch = int(doc.get("epoch", 0))
            known = self._epochs.get(peer)
            if since and known is not None and epoch != known:
                # The peer restarted: its seq counter reset, so our
                # cursor would skip every span the new incarnation
                # recorded before this poll (their seqs sit below it).
                # Re-fetch the full ring of the new incarnation now —
                # the (epoch, seq) dedup keeps the old incarnation's
                # spans without collisions.
                log.debug("peer %s restarted (epoch %s -> %s); "
                          "restarting cursor", peer, known, epoch)
                try:
                    doc, t0, t1 = self._fetch(f"{peer}/spans?since=0")
                except Exception as exc:  # noqa: BLE001 — same contract
                    log.debug("trace re-poll of %s failed: %s", peer, exc)
                    continue
                epoch = int(doc.get("epoch", 0))
            new += self._ingest_doc(peer, doc, t0, t1, hints, epoch)
        new += self._ingest_local()
        return new

    def _ingest_doc(
        self, peer: str, doc: dict, t0: float, t1: float,
        hints: dict[str, float], epoch: int = 0,
    ) -> int:
        node_meta = doc.get("node") or {}
        node_id = node_meta.get("id") or peer
        clock = doc.get("clock") or {}
        sample = estimate_offset(
            t0, t1, float(clock.get("now", (t0 + t1) / 2.0)),
            handshake_rtt=hints.get(node_meta.get("address", "")),
        )
        with self._lock:
            best = self._clocks.get(peer)
            if best is None or sample.rtt < best.rtt:
                # Spans store RAW peer timestamps; the offset is applied
                # at read time, so a later, lower-RTT (better) estimate
                # retroactively re-aligns everything already collected.
                self._clocks[peer] = sample
                self._offsets[node_id] = sample.applied_offset()
            self._nodes[peer] = node_meta
            self._epochs[peer] = epoch
            self._cursors[peer] = int(doc.get("next_since", 0))
            return self._store_locked(
                node_id, doc.get("spans", ()), epoch
            )

    def _ingest_local(self) -> int:
        spans = self.tracer.dump(since=self._local_cursor)
        node_id = self.tracer.node_label() or "local"
        with self._lock:
            if spans:
                self._local_cursor = max(s["seq"] for s in spans)
            return self._store_locked(
                node_id, spans, getattr(self.tracer, "epoch", 0)
            )

    def _store_locked(self, node_id: str, spans, epoch: int = 0) -> int:
        bucket = self._spans.setdefault(node_id, {})
        new = 0
        for s in spans:
            key = (epoch, int(s.get("seq", 0)))
            if key in bucket:
                continue  # overlap re-send (see server next_since note)
            d = dict(s)
            d["node"] = node_id
            bucket[key] = d
            new += 1
        # Bound memory per node: oldest spans age out like a ring.
        while len(bucket) > self.max_spans_per_node:
            bucket.pop(min(bucket))
        return new

    # ------------------------------------------------------------ accessors

    def clock(self, peer: str) -> Optional[PeerClock]:
        with self._lock:
            return self._clocks.get(peer)

    def nodes(self) -> dict[str, dict]:
        """peer url -> node metadata from the last successful poll."""
        with self._lock:
            return dict(self._nodes)

    def merged_spans(self) -> list[dict]:
        """Every collected span (all nodes), node-stamped and
        clock-corrected onto the collector's timeline, ordered by
        start time."""
        with self._lock:
            out = []
            for node_id, bucket in self._spans.items():
                offset = self._offsets.get(node_id, 0.0)
                for s in bucket.values():
                    d = dict(s)
                    d["start"] = float(d.get("start", 0.0)) - offset
                    out.append(d)
        out.sort(key=lambda s: s["start"])
        return out

    def traces(self) -> dict[str, list[dict]]:
        """Merged spans grouped by trace id — each value is one
        *distributed* trace (spans from every contributing node, on one
        corrected timeline, ordered by start).

        A span carrying a ``request_trace`` attribute groups under THAT
        id instead of its own ``trace_id``: pipeline spans keyed by
        message signature (encode/broadcast/deliver/decode legs) stamp
        the request id of the user GET/PUT that caused them, so the
        merged view shows one request-rooted trace spanning every node
        the request touched, not a signature trace disjoint from it."""
        out: dict[str, list[dict]] = {}
        for s in self.merged_spans():
            attrs = s.get("attrs") or {}
            tid = attrs.get("request_trace") or s["trace_id"]
            out.setdefault(tid, []).append(s)
        return out

    # ----------------------------------------------------------- lifecycle

    def start(self, interval: float = 10.0) -> None:
        """Poll every ``interval`` seconds on a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(interval):
                try:
                    self.poll()
                except Exception as exc:  # noqa: BLE001 — keep collecting
                    log.warning("trace collection pass failed: %s", exc)

        self._thread = threading.Thread(
            target=_run, name="noise-ec-trace-collector", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
