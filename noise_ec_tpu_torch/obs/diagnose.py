"""Automated incident diagnosis: from "the SLO flipped" to "peer X is
slow" with evidence.

Port of ``noise_ec_tpu.obs.diagnose``. Its one difference is the
``codec-demotion`` rule: the port's breaker refuses a device product
instead of serving it from the host, so the rule reads the refusals and
names the culprit ``{"route": "device-refused"}``.

The rest of the obs stack answers *that* a node degraded (SLO verdict,
flight-recorder bundle) and *what one request did* (tail-sampled
traces). This module answers *why*: a rule table over three joined
sources — the registry's metric state (windowed deltas when a
:class:`~noise_ec_tpu_torch.obs.recorder.FlightRecorder` timeline is wired,
absolute values otherwise), the wide-event window (obs/events.py) and
the sampler-kept traces — each rule hunting one known failure shape and
returning a scored verdict with evidence pointers:

==================== ==============================================
verdict              signal joined
==================== ==============================================
``slow-peer``        per-peer fetch p95 outlier vs the fleet median
                     + ``hedge.late`` / ``hedge.win`` events naming
                     the same peer
``noisy-tenant``     one tenant's share of op-seconds + ``object.shed``
                     events carrying that tenant
``domain-loss``      a burst of ``peer.down`` / ``peer.drop`` events
                     + churn kill deltas (placement census shrink)
``codec-demotion``   ``codec.refused`` events + breaker state /
                     refusal counter deltas (the device route refused)
``hbm-pressure``     live/limit HBM ratio + ``cache.shrink`` events
                     + hbm-reason sheds
``churn-storm``      ``rebalance.diff`` / ``rebalance.defer`` churn
                     + placement move deltas
``verify-failure-spike`` bad-outcome share of e2e completions +
                     ``scrub.corrupt`` events
==================== ==============================================

Every verdict carries ``evidence``: event seqs that resolve on
``GET /events?since=``, trace ids that resolve on ``GET /spans?trace=``,
and the metric readings the rule compared. Scores are calibrated
cross-rule (a saturated primary signal with corroborating events
approaches 1.0) so the ranked list's head is the probable cause, not
an artifact of which rule happens to be noisiest.

Wiring: ``attach(server)`` mounts ``GET /diagnose`` and folds the most
recent run's top verdicts into ``/healthz`` details; construction with
an ``slo`` subscribes ``add_flip_listener`` so a healthy→degraded flip
diagnoses automatically; construction with a ``recorder`` hands the
flight recorder the event log and a diagnoser hook, so incident
bundles embed the event window and a verdict. ``tools/diagnose.py``
renders either surface as a human report. See docs/observability.md
"Diagnosis".
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from noise_ec_tpu_torch.obs.events import EventLog, default_event_log
from noise_ec_tpu_torch.obs.metrics import percentile_from
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.trace import Tracer, default_tracer

__all__ = ["DIAGNOSE_DOC_FIELDS", "VERDICTS", "DiagnosisEngine"]

log = logging.getLogger("noise_ec_tpu_torch.obs")

# The bounded verdict vocabulary (the ``verdict`` field of every ranked
# entry; docs/observability.md "Diagnosis" documents each shape).
VERDICTS: tuple[str, ...] = (
    "slow-peer",
    "noisy-tenant",
    "domain-loss",
    "codec-demotion",
    "hbm-pressure",
    "churn-storm",
    "verify-failure-spike",
)

# Top-level keys of the GET /diagnose JSON document.
DIAGNOSE_DOC_FIELDS: tuple[str, ...] = (
    "at", "node", "trigger", "window_seconds", "healthy", "verdicts",
)

_EVIDENCE_CAP = 8  # event/trace ids per verdict — pointers, not a dump


class DiagnosisEngine:
    """Rule-table diagnosis over registry + events + kept traces.

    ``window_seconds`` bounds the event window and the recorder-delta
    window a run considers. ``slo`` (optional) subscribes the engine to
    healthy→degraded flips; ``recorder`` (optional) is handed the event
    log and a diagnoser hook so its bundles embed both.
    """

    def __init__(
        self,
        *,
        registry: Optional[Registry] = None,
        events: Optional[EventLog] = None,
        tracer: Optional[Tracer] = None,
        slo=None,
        recorder=None,
        window_seconds: float = 60.0,
    ) -> None:
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.events = events if events is not None else default_event_log()
        self.tracer = tracer if tracer is not None else default_tracer()
        self.slo = slo
        self.recorder = recorder
        self.window_seconds = float(window_seconds)
        self.last: Optional[dict] = None
        self._runs = self.registry.counter("noise_ec_diagnose_runs_total")
        self._seconds = self.registry.histogram("noise_ec_diagnose_seconds")
        if slo is not None:
            slo.add_flip_listener(self._on_flip)
        if recorder is not None:
            # Duck-typed hooks (recorder never imports this module):
            # capture() embeds the event window and a fresh verdict.
            recorder.events = self.events
            recorder.diagnoser = lambda: self.diagnose("bundle")

    # ------------------------------------------------------------ running

    def _on_flip(self, verdict: dict) -> None:
        try:
            self.diagnose("flip")
        # noise-ec: allow(event-on-swallow) — a diagnosis failure must not break the health probe that flipped
        except Exception:  # noqa: BLE001 — a diagnosis failure must not
            # break the health probe that fired the flip listener
            pass

    def diagnose(self, trigger: str = "request") -> dict:
        """Run every rule; return the ranked document (and remember it
        as :attr:`last` for the ``/healthz`` fold)."""
        t0 = time.perf_counter()
        now = time.time()
        window = self.events.dump()
        cutoff = now - self.window_seconds
        window = [e for e in window if e["ts"] >= cutoff]
        spans = self.tracer.dump()
        verdicts = []
        for rule in (
            self._rule_slow_peer,
            self._rule_noisy_tenant,
            self._rule_domain_loss,
            self._rule_codec_demotion,
            self._rule_hbm_pressure,
            self._rule_churn_storm,
            self._rule_verify_failure_spike,
        ):
            try:
                v = rule(window, spans)
            except Exception as exc:  # noqa: BLE001 — one broken rule
                # must not take down the run; the others still rank
                log.debug("diagnosis rule %s failed: %s",
                          rule.__name__, exc)
                v = None
            if v is not None:
                verdicts.append(v)
        verdicts.sort(key=lambda v: -v["score"])
        healthy = None
        if self.slo is not None:
            healthy = bool(self.slo.verdict()["healthy"])
        doc = {
            "at": now,
            "node": self.tracer.node_label(),
            "trigger": trigger,
            "window_seconds": self.window_seconds,
            "healthy": healthy,
            "verdicts": verdicts,
        }
        self.last = doc
        self._runs.labels(trigger=trigger).add(1)
        self._seconds.labels().observe(time.perf_counter() - t0)
        return doc

    # ------------------------------------------------------------- rules

    def _events_named(self, window: list[dict], *names: str) -> list[dict]:
        return [e for e in window if e["name"] in names]

    @staticmethod
    def _evidence(events: list[dict], trace_ids=(), metrics=None) -> dict:
        tids = []
        for e in events:
            tid = e.get("trace_id")
            if tid and tid not in tids:
                tids.append(tid)
        for tid in trace_ids:
            if tid and tid not in tids:
                tids.append(tid)
        return {
            "event_ids": [e["seq"] for e in events[-_EVIDENCE_CAP:]],
            "trace_ids": tids[:_EVIDENCE_CAP],
            "metrics": dict(metrics or {}),
        }

    def _window_delta(self, prefix: str) -> dict[str, float]:
        """Summed per-series recorder deltas over the window for keys
        starting with ``prefix`` — how much each series MOVED recently.
        Falls back to absolute current values when no recorder timeline
        is wired (a standalone node still diagnoses, just without the
        recent/historic split)."""
        out: dict[str, float] = {}
        timeline = []
        if self.recorder is not None:
            with self.recorder._lock:
                timeline = [entry for entry, _ in self.recorder._ring]
            cutoff = time.time() - self.window_seconds
            timeline = [t for t in timeline if t["t"] >= cutoff]
        if timeline:
            for entry in timeline:
                for key, delta in entry["deltas"].items():
                    if key.startswith(prefix):
                        out[key] = out.get(key, 0.0) + delta
            return out
        from noise_ec_tpu_torch.obs.recorder import flatten_registry

        for key, value in flatten_registry(self.registry).items():
            if key.startswith(prefix) and value:
                out[key] = value
        return out

    def _hist_children(self, name: str):
        """(label values tuple, snapshot) per child of one histogram."""
        fam = self.registry.histogram(name)
        return [(values, child.snapshot()) for values, child in
                fam.children()]

    def _rule_slow_peer(self, window, spans) -> Optional[dict]:
        per_peer = {}
        for values, snap in self._hist_children("noise_ec_peer_fetch_seconds"):
            if snap["count"] >= 4:
                per_peer[values[0]] = (
                    percentile_from(snap["bounds"], snap["counts"], 0.95),
                    snap["count"],
                )
        if len(per_peer) < 2:
            return None
        p95s = sorted(p for p, _ in per_peer.values())
        median = p95s[len(p95s) // 2]
        peer, (worst, count) = max(per_peer.items(), key=lambda kv: kv[1][0])
        if median <= 0 or worst < 4.0 * median:
            return None
        late = [
            e for e in self._events_named(window, "hedge.late", "hedge.win")
            if e["attrs"].get("peer") == peer
        ]
        # Kept traces corroborate: peer_fetch spans naming the culprit.
        tids = [
            s.get("attrs", {}).get("request_trace") or s.get("trace_id")
            for s in spans
            if s.get("name") in ("peer_fetch", "gather_fetch")
            and s.get("attrs", {}).get("peer") == peer
        ]
        score = min(0.8, 0.2 + worst / median / 25.0)
        if late:
            score = min(1.0, score + 0.2)
        return {
            "verdict": "slow-peer",
            "score": round(score, 3),
            "culprit": {"peer": peer},
            "summary": (
                f"peer {peer} fetch p95 {worst * 1e3:.1f}ms is "
                f"{worst / median:.1f}x the fleet median "
                f"{median * 1e3:.1f}ms over {count} fetches"
                + (f"; {len(late)} hedge events name it" if late else "")
            ),
            "evidence": self._evidence(late, tids, {
                f"noise_ec_peer_fetch_seconds{{peer={peer}}}#p95": worst,
                "fleet_median_p95": median,
            }),
        }

    def _rule_noisy_tenant(self, window, spans) -> Optional[dict]:
        per_tenant: dict[str, float] = {}
        for values, snap in self._hist_children("noise_ec_object_op_seconds"):
            per_tenant[values[0]] = per_tenant.get(values[0], 0.0) \
                + snap["sum"]
        total = sum(per_tenant.values())
        if total <= 0 or len(per_tenant) < 2:
            return None
        tenant, seconds = max(per_tenant.items(), key=lambda kv: kv[1])
        share = seconds / total
        if share < 0.6:
            return None
        sheds = [
            e for e in self._events_named(window, "object.shed")
        ]
        tids = [
            s.get("attrs", {}).get("request_trace") or s.get("trace_id")
            for s in spans
            if s.get("name") == "request"
            and s.get("attrs", {}).get("tenant") == tenant
        ]
        score = min(0.85, share)
        if sheds:
            score = min(1.0, score + 0.1)
        return {
            "verdict": "noisy-tenant",
            "score": round(score, 3),
            "culprit": {"tenant": tenant},
            "summary": (
                f"tenant {tenant} holds {share * 100:.0f}% of object "
                f"op-seconds ({seconds:.2f}s of {total:.2f}s)"
                + (f"; {len(sheds)} shed events in window" if sheds else "")
            ),
            "evidence": self._evidence(sheds, tids, {
                f"noise_ec_object_op_seconds{{tenant={tenant}}}#sum":
                    seconds,
                "op_seconds_total": total,
            }),
        }

    def _rule_domain_loss(self, window, spans) -> Optional[dict]:
        downs = self._events_named(window, "peer.down", "peer.drop")
        kills = self._window_delta(
            "noise_ec_fleet_churn_events_total{event=kill"
        )
        killed = sum(kills.values())
        if len(downs) < 2 and killed < 2:
            return None
        domains = {}
        for e in downs:
            dom = e["attrs"].get("domain")
            if dom:
                domains[dom] = domains.get(dom, 0) + 1
        culprit: dict = {}
        label = f"{len(downs)} peer-down events"
        if domains:
            dom, n = max(domains.items(), key=lambda kv: kv[1])
            culprit["domain"] = dom
            label = f"domain {dom} lost {n} peers"
        score = 0.3 + min(0.3, (len(downs) + killed) / 20.0)
        if domains:
            score += 0.2
        return {
            "verdict": "domain-loss",
            "score": round(min(0.85, score), 3),
            "culprit": culprit,
            "summary": (
                f"{label}; {killed:.0f} churn kills in window"
            ),
            "evidence": self._evidence(downs, (), kills),
        }

    def _rule_codec_demotion(self, window, spans) -> Optional[dict]:
        # The port's device route never demotes to the host: its breaker
        # refuses (ops/dispatch.py record_codec_refusal), so the signal
        # is ``codec.refused`` events and noise_ec_codec_refused_total
        # deltas, where the JAX package reads ``codec.fallback`` and
        # noise_ec_codec_fallback_total.
        refusals = self._events_named(window, "codec.refused")
        deltas = self._window_delta("noise_ec_codec_refused_total")
        moved = sum(deltas.values())
        state = float(
            self.registry.gauge("noise_ec_codec_circuit_state")
            .labels().read()
        )
        if not refusals and moved < 1 and state == 0.0:
            return None
        restored = self._events_named(window, "codec.restore")
        if restored and not refusals and state == 0.0:
            return None  # refused and already back: not the live cause
        score = 0.4 + min(0.3, (len(refusals) + moved) / 30.0)
        if state != 0.0:
            score += 0.1
        return {
            "verdict": "codec-demotion",
            "score": round(min(0.8, score), 3),
            "culprit": {"route": "device-refused"},
            "summary": (
                f"{moved:.0f} codec refusals in window, breaker "
                f"state {state:.0f} ({len(refusals)} refusal events)"
            ),
            "evidence": self._evidence(refusals, (), {
                **deltas, "noise_ec_codec_circuit_state": state,
            }),
        }

    def _rule_hbm_pressure(self, window, spans) -> Optional[dict]:
        live = float(
            self.registry.gauge("noise_ec_hbm_live_bytes").labels().read()
        )
        limit = float(
            self.registry.gauge("noise_ec_hbm_limit_bytes").labels().read()
        )
        shrinks = self._events_named(window, "cache.shrink")
        hbm_sheds = [
            e for e in self._events_named(window, "object.shed")
            if e["attrs"].get("reason") == "hbm"
        ]
        ratio = live / limit if limit > 0 else 0.0
        if ratio < 0.85 and not shrinks and not hbm_sheds:
            return None
        score = 0.3 + min(0.3, (len(shrinks) + len(hbm_sheds)) / 10.0)
        if ratio >= 0.85:
            score += 0.2
        return {
            "verdict": "hbm-pressure",
            "score": round(min(0.8, score), 3),
            "culprit": {},
            "summary": (
                f"HBM at {ratio * 100:.0f}% of limit; "
                f"{len(shrinks)} cache shrinks, {len(hbm_sheds)} "
                "hbm sheds in window"
            ),
            "evidence": self._evidence(shrinks + hbm_sheds, (), {
                "noise_ec_hbm_live_bytes": live,
                "noise_ec_hbm_limit_bytes": limit,
            }),
        }

    def _rule_churn_storm(self, window, spans) -> Optional[dict]:
        moves = self._events_named(
            window, "rebalance.diff", "rebalance.defer"
        )
        deltas = self._window_delta("noise_ec_placement_moves_total")
        moved = sum(deltas.values())
        churn = sum(self._window_delta(
            "noise_ec_fleet_churn_events_total"
        ).values())
        if len(moves) < 3 and churn < 4:
            return None
        score = 0.25 + min(0.45, (len(moves) + churn) / 30.0)
        return {
            "verdict": "churn-storm",
            "score": round(min(0.75, score), 3),
            "culprit": {},
            "summary": (
                f"{len(moves)} rebalance events, {churn:.0f} churn "
                f"transitions, {moved:.0f} shard moves in window"
            ),
            "evidence": self._evidence(moves, (), deltas),
        }

    def _rule_verify_failure_spike(self, window, spans) -> Optional[dict]:
        bad = good = 0.0
        for values, snap in self._hist_children(
            "noise_ec_e2e_latency_seconds"
        ):
            if values[0] in ("verify_failed", "corrupt"):
                bad += snap["count"]
            else:
                good += snap["count"]
        corrupt = self._events_named(window, "scrub.corrupt")
        total = bad + good
        if bad < 2 and not corrupt:
            return None
        share = bad / total if total else 0.0
        score = 0.3 + min(0.3, share * 3.0) + min(0.2, len(corrupt) / 10.0)
        return {
            "verdict": "verify-failure-spike",
            "score": round(min(0.85, score), 3),
            "culprit": {},
            "summary": (
                f"{bad:.0f} verify-failed/corrupt completions "
                f"({share * 100:.1f}% of {total:.0f}); "
                f"{len(corrupt)} scrub-corrupt events"
            ),
            "evidence": self._evidence(corrupt, (), {
                "e2e_bad_outcomes": bad, "e2e_outcomes": total,
            }),
        }

    # ------------------------------------------------------------ serving

    def attach(self, server) -> None:
        """Mount ``GET /diagnose`` and fold the latest run's top
        verdicts into ``/healthz`` details (the FleetLab chain
        pattern: previously wired detail providers keep running)."""
        server.mount("GET", "/diagnose", self._route_diagnose)
        prev = server.health_details

        def details() -> dict:
            out: dict = {}
            if prev is not None:
                try:
                    out.update(prev())
                # noise-ec: allow(event-on-swallow) — the error is folded into the details doc — the probe surfaces it
                except Exception as exc:  # noqa: BLE001 — same contract
                    # as StatsServer: details must never break the probe
                    out["error"] = str(exc)
            if self.last is not None and self.last["verdicts"]:
                out["diagnosis"] = {
                    "at": self.last["at"],
                    "trigger": self.last["trigger"],
                    "verdicts": [
                        {k: v[k] for k in
                         ("verdict", "score", "culprit", "summary")}
                        for v in self.last["verdicts"][:3]
                    ],
                }
            return out

        server.health_details = details

    def _route_diagnose(self, req: dict) -> tuple:
        doc = self.diagnose("request")
        return 200, "application/json", json.dumps(doc, indent=1).encode()
