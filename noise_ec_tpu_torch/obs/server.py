"""The stats endpoint and periodic reporter — the node's scrape surface.

Port of ``noise_ec_tpu.obs.server``. ``/xprof`` captures through the
port's ``device_trace`` (``torch.profiler``, a Chrome trace), and the
``hbm`` details and gauges come from the card (obs/device.py). The event
log mounts ``GET /events`` on it (``EventLog.attach``, obs/events.py); the
node's CLI attaches the process log.

``StatsServer`` is a stdlib ``http.server`` on a daemon thread serving:

- ``GET /metrics`` — Prometheus text exposition (obs/export.py): the
  registry's labeled families plus any attached plain counter bags;
- ``GET /spans`` — the tracer ring buffer as a JSON *dump document*
  ``{"node", "clock", "next_since", "spans"}`` (``?trace=<id>`` /
  ``?limit=<n>`` newest-N / ``?since=<seq>`` cursor) — the unit the
  distributed-trace collector (obs/collector.py) pulls and merges;
- ``GET /healthz`` — SLO-aware health: 200 ``ok`` while the wired
  :class:`~noise_ec_tpu_torch.obs.health.SLOEvaluator` (if any) judges the
  rolling window healthy, 503 with the JSON verdict once the error
  budget is burned. With no evaluator wired it is plain liveness. The
  verbose/503 JSON folds the device HBM snapshot (obs/device.py) into
  ``details.hbm`` alongside any wired ``health_details``;
- ``GET /profile?seconds=N`` — the always-on sampling profiler's last
  N seconds as flamegraph-ready collapsed-stack text (obs/sampler.py;
  the sampler starts on first request if the CLI ``-profile`` flag did
  not start it eagerly);
- ``GET /xprof?seconds=N`` — capture a ``torch.profiler`` trace (host
  and, on a card, CUDA activity) of the next N seconds into the
  configured ``xprof_dir`` (404 until the CLI ``-xprof-dir`` flag or
  constructor wires a directory; 409 while a capture is already running).

Dispatch is a **registration table**, not an if/elif chain: every
endpoint above is a route registered through :meth:`StatsServer.mount`,
and other subsystems mount theirs the same way (the erasure-coded object
service, service/http.py, adds its ``/objects`` tree onto this server —
docs/object-service.md). A handler receives one request dict and returns
``(status, content_type, body[, extra_headers])``; ``body`` may be an
iterator of byte chunks for streamed responses (the handler then sets
``Content-Length`` itself via ``extra_headers``).

``PeriodicReporter`` logs a structured stats snapshot every N seconds so
a node without a scraper still surfaces its counters during the run, not
only at shutdown. Both are wired to CLI flags (``-metrics-port`` /
``-stats-interval``) in host/cli.py.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from noise_ec_tpu_torch.obs.device import hbm_snapshot, install_hbm_gauges
from noise_ec_tpu_torch.obs.export import render_prometheus
from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.metrics import Counters
from noise_ec_tpu_torch.obs.registry import Registry
from noise_ec_tpu_torch.obs.trace import Tracer, clock_anchor, default_tracer

__all__ = ["PeriodicReporter", "SPANS_DOC_FIELDS", "StatsServer"]

# Top-level keys of the /spans dump document (docs/observability.md).
SPANS_DOC_FIELDS: tuple[str, ...] = (
    "node", "clock", "epoch", "next_since", "spans",
)

log = logging.getLogger("noise_ec_tpu_torch.obs")

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class StatsServer:
    """Serve /metrics, /spans and /healthz on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port`` after construction. ``extra_counters`` maps exposition
    prefixes to plain :class:`Counters` bags (see obs/export.py).
    ``slo`` wires a :class:`SLOEvaluator` verdict into ``/healthz``
    (None keeps the plain always-200 liveness probe).
    ``health_details`` is an optional zero-arg callable whose dict is
    folded into the ``/healthz`` JSON body (e.g. the peer supervisor's
    circuit-breaker summary, resilience/peers.py) — served alongside the
    verdict on 503, and on 200 via ``/healthz?verbose=1``; the device
    HBM snapshot rides the same ``details`` dict under ``hbm``.
    ``sampler`` attaches a started :class:`~noise_ec_tpu_torch.obs.sampler.
    StackSampler` for ``/profile`` (one starts lazily on first request
    otherwise). ``xprof_dir`` enables ``/xprof`` captures into that
    directory.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        extra_counters: Optional[dict[str, Counters]] = None,
        slo: Optional[SLOEvaluator] = None,
        health_details: Optional[Callable[[], dict]] = None,
        sampler=None,
        xprof_dir: Optional[str] = None,
    ):
        self.registry = registry
        self.tracer = tracer if tracer is not None else default_tracer()
        self.extra_counters = dict(extra_counters or {})
        self.slo = slo
        self.health_details = health_details
        self.sampler = sampler
        self.xprof_dir = xprof_dir
        self._xprof_busy = threading.Lock()
        self._xprof_thread: Optional[threading.Thread] = None
        # The route registration table (see module docstring): exact
        # paths first, then the longest matching prefix route. Built-in
        # endpoints register through the same mount() other subsystems
        # use, so adding a route never grows a dispatch chain here.
        self._routes: list[tuple[str, str, bool, dict]] = []
        self._mount_builtins()
        install_hbm_gauges(registry)
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                self._dispatch("GET")

            def do_PUT(self):  # noqa: N802
                self._dispatch("PUT")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def do_DELETE(self):  # noqa: N802
                self._dispatch("DELETE")

            def _dispatch(self, method: str) -> None:
                url = urlparse(self.path)
                spec = outer._match(method, url.path)
                if spec is None:
                    self._reply(404, "text/plain", b"not found\n")
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    self._reply(400, "text/plain", b"bad content length\n")
                    return
                body = b""
                if spec["stream"]:
                    # Streaming route: the handler consumes rfile itself
                    # (bounded by "length") — PUTs of large objects must
                    # not buffer whole bodies here.
                    pass
                elif length:
                    if length > spec["max_body"]:
                        self._reply(413, "text/plain", b"body too large\n")
                        return
                    body = self.rfile.read(length)
                req = {
                    "method": method,
                    "path": url.path,
                    "query": parse_qs(url.query),
                    "headers": self.headers,
                    "body": body,
                    "length": length,
                    "rfile": self.rfile if spec["stream"] else None,
                }
                try:
                    result = spec["handler"](req)
                except Exception as exc:  # noqa: BLE001 — one bad handler
                    # must not kill the serving thread's connection loop
                    log.error("handler for %s %s failed: %s",
                              method, url.path, exc)
                    self._reply(500, "text/plain", b"internal error\n")
                    return
                extra = result[3] if len(result) > 3 else None
                self._reply(result[0], result[1], result[2], extra)

            def _reply(self, code: int, ctype: str, body,
                       extra_headers: Optional[dict] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                if isinstance(body, (bytes, bytearray)):
                    self.send_header("Content-Length", str(len(body)))
                for key, value in (extra_headers or {}).items():
                    self.send_header(key, str(value))
                self.end_headers()
                if isinstance(body, (bytes, bytearray)):
                    self.wfile.write(body)
                else:
                    # Streamed body: an iterator of byte chunks; the
                    # handler supplied Content-Length via extra_headers.
                    # A mid-stream failure can only abort the connection
                    # (the status line is gone) — the client sees a
                    # short read against the declared length.
                    for chunk in body:
                        self.wfile.write(chunk)

            def log_message(self, fmt, *args):  # scrapes are not log news
                log.debug("stats endpoint: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="noise-ec-stats",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------- routing

    def mount(
        self,
        method: str,
        path: str,
        handler: Callable[[dict], tuple],
        *,
        prefix: bool = False,
        max_body: int = 1 << 20,
        stream: bool = False,
    ) -> None:
        """Register one route. ``handler(request) -> (status, ctype,
        body[, headers])`` where ``request`` carries ``method`` /
        ``path`` / ``query`` (parse_qs dict) / ``headers`` / ``body``
        (bytes, capped at ``max_body``) / ``length``. ``prefix=True``
        matches every path under ``path`` (longest prefix wins);
        ``stream=True`` skips body buffering and hands the handler
        ``request["rfile"]`` + ``request["length"]`` instead (uploads of
        arbitrary size stay O(chunk) in memory). ``body`` in the reply
        may be bytes or an iterator of byte chunks (then the handler
        must set ``Content-Length`` in its headers dict)."""
        self._routes.append((
            method.upper(), path, prefix,
            {"handler": handler, "max_body": max_body, "stream": stream},
        ))

    def _match(self, method: str, path: str) -> Optional[dict]:
        best: Optional[tuple[int, dict]] = None
        for m, route_path, prefix, spec in list(self._routes):
            if m != method:
                continue
            if not prefix:
                if path == route_path:
                    return spec  # exact match always wins
            elif path.startswith(route_path):
                if best is None or len(route_path) > best[0]:
                    best = (len(route_path), spec)
        return best[1] if best is not None else None

    def _mount_builtins(self) -> None:
        self.mount("GET", "/metrics", self._route_metrics)
        self.mount("GET", "/spans", self._route_spans)
        self.mount("GET", "/healthz", self._route_healthz)
        self.mount("GET", "/profile", self._route_profile)
        self.mount("GET", "/xprof", self._route_xprof)

    def _route_metrics(self, req: dict) -> tuple:
        body = render_prometheus(self.registry, self.extra_counters).encode()
        return 200, _PROM_CONTENT_TYPE, body

    def _route_spans(self, req: dict) -> tuple:
        q = req["query"]
        limit = since = None
        try:
            if "limit" in q:
                limit = int(q["limit"][0])
            if "since" in q:
                since = int(q["since"][0])
        except ValueError:
            return 400, "text/plain", b"bad cursor\n"
        trace = q.get("trace", [None])[0]
        # next_since is read BEFORE the dump: a span landing between the
        # two reads is then re-sent next poll rather than skipped forever.
        doc = {
            "node": self.tracer.node or {},
            "clock": clock_anchor(),
            # Tracer incarnation: lets the collector detect a peer
            # restart (seq counter reset) and restart its cursor
            # instead of silently dropping the new incarnation's spans.
            "epoch": self.tracer.epoch,
            "next_since": self.tracer.last_seq(),
            "spans": self.tracer.dump(
                trace_id=trace, limit=limit, since=since
            ),
        }
        return 200, "application/json", json.dumps(doc, indent=1).encode()

    def _route_healthz(self, req: dict) -> tuple:
        verbose = "verbose" in req["query"]
        verdict = (
            self.slo.verdict() if self.slo is not None
            else {"healthy": True, "reason": None}
        )
        details: dict = {}
        if self.health_details is not None:
            try:
                details.update(self.health_details())
            except Exception as exc:  # noqa: BLE001 — health detail must
                # never break the probe itself
                details["error"] = str(exc)
        try:
            hbm = hbm_snapshot()
            if hbm:
                details["hbm"] = hbm
        except Exception:  # noqa: BLE001 — same contract
            pass
        if details:
            verdict["details"] = details
        if verdict["healthy"]:
            if verbose:
                return (200, "application/json",
                        json.dumps(verdict, indent=1).encode())
            return 200, "text/plain", b"ok\n"
        return (503, "application/json",
                json.dumps(verdict, indent=1).encode())

    def _route_profile(self, req: dict) -> tuple:
        try:
            seconds = float(req["query"].get("seconds", ["5"])[0])
        except ValueError:
            return 400, "text/plain", b"bad seconds\n"
        seconds = max(0.1, min(seconds, 60.0))
        return (200, "text/plain; charset=utf-8",
                self._profile(seconds).encode())

    def _route_xprof(self, req: dict) -> tuple:
        if not self.xprof_dir:
            return (404, "text/plain",
                    b"no xprof dir configured (-xprof-dir)\n")
        try:
            seconds = float(req["query"].get("seconds", ["5"])[0])
        except ValueError:
            return 400, "text/plain", b"bad seconds\n"
        seconds = max(0.1, min(seconds, 300.0))
        ok, msg = self._xprof(seconds)
        return (200 if ok else 409, "application/json",
                json.dumps(msg, indent=1).encode())

    def _profile(self, seconds: float) -> str:
        """Collapsed stacks for the last ``seconds``. Starts the shared
        sampler on first request; a cold window blocks (bounded by
        ``seconds``) until it holds at least one sample, so the first
        scrape after startup still returns stacks instead of ''."""
        if self.sampler is None:
            from noise_ec_tpu_torch.obs.sampler import default_sampler

            self.sampler = default_sampler()
        sampler = self.sampler
        sampler.start()
        deadline = time.time() + seconds
        text = sampler.collapsed(seconds)
        while not text and time.time() < deadline:
            time.sleep(0.02)
            text = sampler.collapsed(seconds)
        return text

    def _xprof(self, seconds: float) -> tuple[bool, dict]:
        """One bounded ``device_trace`` capture into ``xprof_dir`` on a
        background thread; refuses to overlap captures."""
        if not self._xprof_busy.acquire(blocking=False):
            return False, {"error": "capture already running"}

        def run():
            try:
                from noise_ec_tpu_torch.obs.profiling import device_trace

                with device_trace(self.xprof_dir):
                    time.sleep(seconds)
                log.info("xprof capture (%.1fs) written to %s",
                         seconds, self.xprof_dir)
            except Exception as exc:  # noqa: BLE001 — telemetry capture
                log.error("xprof capture failed: %s", exc)
            finally:
                self._xprof_busy.release()

        self._xprof_thread = threading.Thread(
            target=run, name="noise-ec-xprof", daemon=True
        )
        self._xprof_thread.start()
        return True, {
            "capturing": True, "seconds": seconds, "logdir": self.xprof_dir,
        }

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        # An in-flight xprof capture must finish before the process can
        # exit, so its trace is written whole. Bounded wait — the
        # capture window is capped at 300 s plus start/stop overhead.
        t = self._xprof_thread
        if t is not None and t.is_alive():
            log.info("waiting for the in-flight xprof capture to finish")
            t.join(timeout=330)


class PeriodicReporter:
    """Log a stats snapshot every ``interval`` seconds on a daemon thread.

    ``snapshot_fn`` returns the dict to log (e.g. merged plugin + kernel
    counters); errors in it are logged, never raised — a reporting bug
    must not take the node down.
    """

    def __init__(self, interval: float, snapshot_fn: Callable[[], dict],
                 logger: Optional[logging.Logger] = None):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.interval = interval
        self.snapshot_fn = snapshot_fn
        self.log = logger if logger is not None else log
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="noise-ec-reporter", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.log.info("stats: %s", self.snapshot_fn())
            except Exception as exc:  # noqa: BLE001 — keep reporting
                self.log.warning("stats snapshot failed: %s", exc)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
