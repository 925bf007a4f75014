"""Metrics federation: node-local expositions merged into one fleet view.

Monarch-style hierarchical aggregation over the exact surface the nodes
already serve: a :class:`MetricsFederator` scrapes each target's
``GET /metrics`` (the obs/export.py exposition), parses it with the
shared codec (:func:`~noise_ec_tpu_torch.obs.export.parse_prometheus` — the
byte-exact inverse of the renderer, so escaping and ``+Inf`` semantics
cannot drift between the two ends), merges the series across nodes, and
serves the merged document at ``GET /fleet/metrics`` through the stats
server's route table.

Merge semantics per family type:

- **counters** sum across nodes (each node's counter is monotone, the
  fleet total is too);
- **gauges** follow a per-family policy (:data:`GAUGE_POLICIES`):
  ``sum`` by default (queue depths, resident bytes — fleet capacity
  questions), ``max`` for worst-state families like circuit-state
  enums where the fleet answer is "the sickest node";
- **histograms** merge bucket-wise: cumulative ``le`` counts, ``_sum``
  and ``_count`` all add, so fleet p50/p99 are computable from the
  merged buckets exactly as from a single node's.

Every merged sample carries a ``node="fleet"`` label (before ``le`` on
bucket lines, so ``le`` stays last as the exposition convention wants)
marking it as an aggregate; per-node drill-down is each peer's own
``/metrics`` — the federation serves the fleet-level question, not a
copy of every node's series.

Scrape failures ride a per-target :class:`~noise_ec_tpu_torch.resilience.
breakers.CircuitBreaker` (a dead peer costs one timeout per reset
window, not one per cycle) and the last good document is served stale
until the peer recovers. The federator's own health is a
``noise_ec_federate_*`` family set in the local registry — scrapes by
result, per-peer error counters (cardinality-capped), up/down target
gauges, merged-series count, and cycle duration.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from typing import Callable, Optional

from noise_ec_tpu_torch.obs.export import (
    parse_prometheus,
    render_parsed,
    split_exemplar,
)
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker

__all__ = ["GAUGE_POLICIES", "MetricsFederator", "merge_documents"]

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Per-family gauge merge policy; families not listed sum. "max" fits
# enum/worst-state gauges where adding node states is meaningless.
GAUGE_POLICIES: dict[str, str] = {
    "noise_ec_peer_circuit_state": "max",
    "noise_ec_codec_circuit_state": "max",
    "noise_ec_build_info": "max",
    # Every node's rebalancer publishes its own view of the SAME
    # per-domain shard census; summing across nodes counts each
    # shard once per reporter. "max" keeps the most complete view.
    "noise_ec_placement_shards": "max",
}

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _fmt_value(v: float) -> str:
    # Match obs/export.py _fmt: integral values as integers, floats as
    # shortest-roundtrip repr.
    if float(v).is_integer() and abs(v) < 2**63:
        return str(int(v))
    return repr(float(v))


def _merge_key(labels: tuple[tuple[str, str], ...]) -> tuple:
    return tuple(labels)


def merge_documents(docs: dict[str, str]) -> list[dict]:
    """Merge node-id -> exposition-text into one parsed-family list
    (the :func:`~noise_ec_tpu_torch.obs.export.render_parsed` input shape),
    aggregated with a ``node="fleet"`` label. Families keep first-seen
    order; children are sorted; buckets sorted numerically with
    ``+Inf`` last."""
    # family name -> {"type", "help", kind-specific accumulator}
    order: list[str] = []
    merged: dict[str, dict] = {}
    for _node, text in docs.items():
        for fam in parse_prometheus(text):
            name = fam["name"]
            acc = merged.get(name)
            if acc is None:
                acc = merged[name] = {
                    "type": fam["type"],
                    "help": fam["help"],
                    "scalars": {},     # labels -> float (counter/gauge)
                    "hists": {},       # labels -> {"buckets", "sum", "count"}
                }
                order.append(name)
            if acc["help"] is None:
                acc["help"] = fam["help"]
            if fam["type"] == "histogram":
                _fold_histogram(acc, name, fam["samples"])
            else:
                policy = (
                    GAUGE_POLICIES.get(name, "sum")
                    if fam["type"] == "gauge" else "sum"
                )
                for _sname, labels, raw in fam["samples"]:
                    value = float(raw.split()[0])
                    key = _merge_key(labels)
                    prev = acc["scalars"].get(key)
                    if prev is None:
                        acc["scalars"][key] = value
                    elif policy == "max":
                        acc["scalars"][key] = max(prev, value)
                    else:
                        acc["scalars"][key] = prev + value
    return [_emit_family(name, merged[name]) for name in order]


def _fold_histogram(acc: dict, name: str, samples) -> None:
    for sname, labels, raw in samples:
        num, exemplar = split_exemplar(raw)
        value = float(num.split()[0])
        if sname == f"{name}_bucket":
            le = None
            base = []
            for k, v in labels:
                if k == "le":
                    le = v
                else:
                    base.append((k, v))
            if le is None:
                raise ValueError(f"histogram bucket without le: {sname}")
            h = acc["hists"].setdefault(
                tuple(base), {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            h["buckets"][le] = h["buckets"].get(le, 0.0) + value
            if exemplar is not None:
                # Forward exemplars through the merge: last writer per
                # (labels, le) wins — any kept trace id answers "show me
                # a request behind this bucket".
                h.setdefault("exemplars", {})[le] = exemplar
        else:
            h = acc["hists"].setdefault(
                tuple(labels), {"buckets": {}, "sum": 0.0, "count": 0.0}
            )
            if sname == f"{name}_sum":
                h["sum"] += value
            elif sname == f"{name}_count":
                h["count"] += value
            else:
                raise ValueError(
                    f"unexpected histogram sample {sname} in {name}"
                )


def _le_sort_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def _emit_family(name: str, acc: dict) -> dict:
    """One merged accumulator -> a parsed-family dict with the
    ``node="fleet"`` label stitched in."""
    samples: list[tuple] = []
    if acc["hists"]:
        for base in sorted(acc["hists"]):
            h = acc["hists"][base]
            labeled = tuple(base) + (("node", "fleet"),)
            exemplars = h.get("exemplars") or {}
            for le in sorted(h["buckets"], key=_le_sort_key):
                value = _fmt_value(h["buckets"][le])
                ex = exemplars.get(le)
                if ex is not None:
                    value = f"{value} # {ex}"
                samples.append((
                    f"{name}_bucket",
                    labeled + (("le", le),),
                    value,
                ))
            samples.append((f"{name}_sum", labeled, repr(float(h["sum"]))))
            samples.append((f"{name}_count", labeled, _fmt_value(h["count"])))
    for key in sorted(acc["scalars"]):
        samples.append((
            name,
            tuple(key) + (("node", "fleet"),),
            _fmt_value(acc["scalars"][key]),
        ))
    return {
        "name": name,
        "type": acc["type"],
        "help": acc["help"],
        "samples": samples,
    }


class MetricsFederator:
    """Scrape peer ``/metrics`` endpoints and serve the merged view.

    ``peers`` are base URLs (``http://host:port`` — ``/metrics`` is
    appended); ``sources`` maps node ids to zero-arg callables returning
    exposition text directly (the in-process fleet lab's targets —
    same merge path, no sockets). Each target gets its own circuit
    breaker; while a breaker is open the target is skipped (counted as
    ``skipped``) and its last good document, if any, is served stale.

    ``attach(server)`` mounts ``GET /fleet/metrics`` on a
    :class:`~noise_ec_tpu_torch.obs.server.StatsServer`; with no background
    ``start()`` thread running, each request scrapes inline so the
    served view is current.
    """

    # Distinct peer label values recorded before collapsing to "other"
    # (mirrors the transport's per-peer cardinality bound).
    PEER_LABEL_CAP = 256

    def __init__(
        self,
        peers: tuple[str, ...] | list[str] = (),
        *,
        sources: Optional[dict[str, Callable[[], str]]] = None,
        registry: Optional[Registry] = None,
        timeout: float = 2.0,
        failure_threshold: int = 3,
        reset_timeout: float = 2.0,
    ):
        self.peers = list(peers)
        self.sources = dict(sources or {})
        self.timeout = timeout
        self._registry = (
            registry if registry is not None else default_registry()
        )
        self._lock = threading.Lock()
        self._last_good: dict[str, str] = {}   # target id -> exposition
        self._up: dict[str, bool] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_kwargs = {
            "failure_threshold": failure_threshold,
            "reset_timeout": reset_timeout,
        }
        self._peer_labels: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = self._registry
        self._scrapes = reg.counter("noise_ec_federate_scrapes_total")
        self._errors = reg.counter("noise_ec_federate_scrape_errors_total")
        self._cycle_hist = reg.histogram(
            "noise_ec_federate_scrape_seconds"
        ).labels()
        self._series_gauge = reg.gauge("noise_ec_federate_series").labels()
        peers_gauge = reg.gauge("noise_ec_federate_peers")
        peers_gauge.set_callback(
            lambda: sum(1 for up in self._up.values() if up), state="up"
        )
        peers_gauge.set_callback(
            lambda: sum(1 for up in self._up.values() if not up),
            state="down",
        )

    # ------------------------------------------------------------ scraping

    def _targets(self) -> list[tuple[str, Callable[[], str]]]:
        out: list[tuple[str, Callable[[], str]]] = []
        for url in self.peers:
            out.append((url, self._http_fetcher(url)))
        for node_id, fn in self.sources.items():
            out.append((node_id, fn))
        return out

    def _http_fetcher(self, url: str) -> Callable[[], str]:
        def fetch() -> str:
            with urllib.request.urlopen(
                f"{url}/metrics", timeout=self.timeout
            ) as resp:
                return resp.read().decode("utf-8")
        return fetch

    def _breaker(self, target: str) -> CircuitBreaker:
        br = self._breakers.get(target)
        if br is None:
            br = self._breakers[target] = CircuitBreaker(
                **self._breaker_kwargs
            )
        return br

    def _peer_label(self, target: str) -> str:
        if target in self._peer_labels:
            return target
        if len(self._peer_labels) >= self.PEER_LABEL_CAP:
            return "other"
        self._peer_labels.add(target)
        return target

    def scrape(self) -> int:
        """One scrape cycle over every target; returns how many targets
        currently have a usable (possibly stale) document."""
        t0 = time.monotonic()
        for target, fetch in self._targets():
            breaker = self._breaker(target)
            if not breaker.allow():
                self._scrapes.labels(result="skipped").add(1)
                with self._lock:
                    self._up[target] = False
                continue
            try:
                text = fetch()
                # Validate before accepting: a half-written or corrupt
                # document must not poison the merged view.
                parse_prometheus(text)
            except Exception:  # noqa: BLE001 — any scrape/parse failure
                # is a peer failure; the breaker bounds the retry rate
                breaker.record_failure()
                self._scrapes.labels(result="error").add(1)
                self._errors.labels(peer=self._peer_label(target)).add(1)
                with self._lock:
                    self._up[target] = False
                continue
            breaker.record_success()
            self._scrapes.labels(result="ok").add(1)
            with self._lock:
                self._last_good[target] = text
                self._up[target] = True
        self._cycle_hist.observe(time.monotonic() - t0)
        with self._lock:
            return len(self._last_good)

    # ------------------------------------------------------------- merging

    def merged_families(self) -> list[dict]:
        """The fleet-merged families from every target's last good
        document (see :func:`merge_documents`)."""
        with self._lock:
            docs = dict(self._last_good)
        families = merge_documents(docs)
        self._series_gauge.set(
            sum(len(f["samples"]) for f in families)
        )
        return families

    def render(self) -> str:
        """The merged fleet exposition document."""
        return render_parsed(self.merged_families())

    # ------------------------------------------------------------- serving

    def attach(self, server) -> None:
        """Mount ``GET /fleet/metrics`` on a stats server."""
        server.mount("GET", "/fleet/metrics", self._route_fleet_metrics)

    def _route_fleet_metrics(self, req: dict) -> tuple:
        if self._thread is None:
            # No background scraper: serve a current view.
            self.scrape()
        return 200, _PROM_CONTENT_TYPE, self.render().encode()

    # ----------------------------------------------------------- lifecycle

    def start(self, interval: float = 10.0) -> None:
        """Scrape every ``interval`` seconds on a daemon thread."""
        if self._thread is not None:
            return

        def run() -> None:
            while not self._stop.wait(interval):
                try:
                    self.scrape()
                except Exception:  # noqa: BLE001 — a cycle failure must
                    # not kill the scrape loop
                    pass

        self._thread = threading.Thread(
            target=run, name="noise-ec-federate", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5)
