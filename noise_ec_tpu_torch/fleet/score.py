"""Fleet scoring: ground-truth delivery accounting and the run report.

The lab does not trust counters alone — every admitted submission
records its EXPECTED recipient set (the sender's up-neighbors at send
time), every verified delivery is matched back to its submission, and
the report classifies each expected (message, receiver) pair exactly
once:

- **delivered** — the receiver's plugin verified and delivered it (for
  objects: the receiver's object service serves the bytes back
  byte-identical);
- **shed** — never expected at all: admission refused the submission
  with a Retry-After hint BEFORE any encode (the node protecting
  itself is not data loss; scored as its own bucket);
- **churned** — the expected receiver was killed by the churn schedule
  between send and scoring (the schedule, not the stack, removed it;
  excluded from the delivery-rate denominator);
- **lost** — everything else: the stack actually dropped it.

``delivery.rate`` is therefore ``delivered / (expected - churned)`` —
the honest number the acceptance bars gate on (docs/fleet.md, scoring
semantics).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from noise_ec_tpu_torch.obs.registry import default_registry

__all__ = ["FleetScorer"]


def _pct(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(q * len(vals)))]


class FleetScorer:
    """Thread-safe run ledger (module docstring). One per lab run."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        # msg_id -> {kind, sender, expected, t, delivered: {recv: lat}}
        self.sent: dict[int, dict] = {}
        self.shed_events: list[dict] = []
        # msg_id -> {tenant, name, digest} for post-run GET verification
        self.objects: dict[int, dict] = {}
        # tenant -> wall-clock GET samples: the scorer's own timing of
        # the reads the service-side noise_ec_object_op_seconds
        # histogram also times — the independent check the federation
        # acceptance compares fleet-merged bucket p99s against.
        self.tenant_gets: dict[str, list[float]] = {}
        self.repairs = {"ok": 0, "failed": 0}
        # Placement/rebalance roll-up (fleet runs with a domains@ ring):
        # the lab folds its census + rebalance cycle stats in here so the
        # report carries the convergence story (docs/placement.md).
        self.placement: dict = {}
        reg = default_registry()
        self._m_msgs = reg.counter("noise_ec_fleet_messages_total")
        self._m_msgs_children: dict[str, object] = {}
        self._m_delivered = reg.counter(
            "noise_ec_fleet_deliveries_total"
        ).labels()
        self._m_shed = reg.counter("noise_ec_fleet_shed_total")
        self._m_lost = reg.counter("noise_ec_fleet_lost_total").labels()

    # ------------------------------------------------------------ recording

    def begin(self, kind: str, sender: int, expected: tuple,
              now: Optional[float] = None) -> int:
        """Admit one submission; returns its msg_id (embedded in chat
        payload headers / object names so deliveries match back)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            msg_id = self._next_id
            self._next_id += 1
            self.sent[msg_id] = {
                "kind": kind,
                "sender": sender,
                "expected": tuple(expected),
                "t": t,
                "delivered": {},
            }
        child = self._m_msgs_children.get(kind)
        if child is None:
            child = self._m_msgs_children[kind] = self._m_msgs.labels(
                kind=kind
            )
        child.add(1)
        return msg_id

    def add_object(self, msg_id: int, tenant: str, name: str,
                   digest: bytes) -> None:
        with self._lock:
            self.objects[msg_id] = {
                "tenant": tenant, "name": name, "digest": digest,
            }

    def deliver(self, msg_id: int, receiver: int,
                now: Optional[float] = None) -> None:
        """One verified delivery. ``now=None`` stamps latency from the
        submission time; objects verified post-run pass an explicit
        ``now`` equal to the send time (latency 0 → excluded from the
        latency stats by the report)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            rec = self.sent.get(msg_id)
            if rec is None or receiver in rec["delivered"]:
                return
            rec["delivered"][receiver] = max(0.0, t - rec["t"])
        self._m_delivered.add(1)

    def shed(self, kind: str, sender: int, reason: str,
             retry_after: float) -> None:
        with self._lock:
            self.shed_events.append({
                "kind": kind, "sender": sender, "reason": reason,
                "retry_after": retry_after, "t": time.monotonic(),
            })
        self._m_shed.labels(reason=reason).add(1)

    def tenant_get(self, tenant: str, seconds: float) -> None:
        """One timed GET through a peer's service layer (run-mix reads
        and post-run verification reads both count — the same calls the
        tenant-labeled histogram observes)."""
        with self._lock:
            self.tenant_gets.setdefault(tenant, []).append(seconds)

    def repair_result(self, ok: bool) -> None:
        with self._lock:
            self.repairs["ok" if ok else "failed"] += 1

    def note_placement(self, stats: dict) -> None:
        """Merge placement/rebalance stats into the report's
        ``placement`` block (last write per key wins)."""
        with self._lock:
            self.placement.update(stats)

    # ------------------------------------------------------------- reporting

    def snapshot(self) -> dict:
        """Cheap live totals (the /fleet route and healthz block)."""
        with self._lock:
            expected = sum(len(r["expected"]) for r in self.sent.values())
            delivered = sum(len(r["delivered"]) for r in self.sent.values())
            return {
                "sent": len(self.sent),
                "expected_deliveries": expected,
                "delivered": delivered,
                "shed": len(self.shed_events),
            }

    def report(self, churn_kills: dict[int, list],
               duration: float) -> dict:
        """The scored run report (module docstring for the pair
        classification). ``churn_kills`` maps peer index -> kill times
        (lab epoch = ``time.monotonic`` values)."""
        with self._lock:
            sent = {m: dict(r) for m, r in self.sent.items()}
            shed_events = list(self.shed_events)
            objects = dict(self.objects)
            tenant_gets = {t: list(v) for t, v in self.tenant_gets.items()}
            repairs = dict(self.repairs)
            placement = dict(self.placement)
        expected = delivered = lost = churned = 0
        latencies: list[float] = []
        per_sender: dict[int, list[float]] = {}
        by_kind: dict[str, dict] = {}
        for rec in sent.values():
            kind_stats = by_kind.setdefault(
                rec["kind"], {"sent": 0, "expected": 0, "delivered": 0}
            )
            kind_stats["sent"] += 1
            for receiver in rec["expected"]:
                expected += 1
                kind_stats["expected"] += 1
                lat = rec["delivered"].get(receiver)
                if lat is not None:
                    delivered += 1
                    kind_stats["delivered"] += 1
                    if lat > 0:
                        latencies.append(lat)
                        per_sender.setdefault(rec["sender"], []).append(lat)
                elif any(
                    k >= rec["t"] for k in churn_kills.get(receiver, ())
                ):
                    churned += 1
                else:
                    lost += 1
        if lost:
            self._m_lost.add(lost)
        shed_by_reason: dict[str, int] = {}
        for ev in shed_events:
            shed_by_reason[ev["reason"]] = (
                shed_by_reason.get(ev["reason"], 0) + 1
            )
        denominator = max(1, expected - churned)
        report = {
            "duration_s": round(duration, 3),
            "sent": len(sent),
            "msgs_per_s": round(len(sent) / max(duration, 1e-9), 1),
            "delivery": {
                "expected": expected,
                "delivered": delivered,
                "lost": lost,
                "churned": churned,
                "rate": round(delivered / denominator, 6),
            },
            "shed": {
                "total": len(shed_events),
                "by_reason": shed_by_reason,
                "retry_after_s": (
                    max(ev["retry_after"] for ev in shed_events)
                    if shed_events else None
                ),
            },
            "by_kind": by_kind,
            "objects": {"puts": len(objects)},
            "placement": placement,
            "repair": repairs,
            "latency_ms": {
                "count": len(latencies),
                "p50": _ms(_pct(latencies, 0.50)),
                "p99": _ms(_pct(latencies, 0.99)),
            },
            "per_sender_p99_ms": {
                s: _ms(_pct(lats, 0.99))
                for s, lats in sorted(per_sender.items())
            },
            "tenant_get_p99_ms": {
                t: _ms(_pct(samples, 0.99))
                for t, samples in sorted(tenant_gets.items())
            },
        }
        return report


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)
