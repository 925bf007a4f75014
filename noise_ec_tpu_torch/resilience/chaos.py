"""Chaos proxy: deterministic, seeded fault injection for the REAL
transport.

The loopback hub has had a first-class fault model since the seed
(:class:`~noise_ec_tpu_torch.host.transport.FaultInjector`); the TCP transport
had none (SURVEY.md §5 failure row). This module puts the same model —
plus link-level faults only a real byte stream can express — between two
live :class:`~noise_ec_tpu_torch.host.transport.TCPNetwork` peers:

    dialer ──tcp──▶ ChaosProxy ──tcp──▶ target

The proxy parses the transport's length-prefixed frames (u32le length +
body) off each connection and applies, per direction, per frame:

- the message faults: drop / duplicate / corrupt / reorder (the
  ``FaultInjector`` model; a corrupted frame fails the receiver's
  Ed25519 frame signature and is counted + dropped there, never
  delivered);
- fixed + jittered **delay** and a **bandwidth cap** (serialization
  delay accumulated per link, so a burst queues like a narrow pipe);
- **directional partitions** with scheduled heal times (frames one way
  silently vanish for a window — the failure shape TCP cannot see);
- **connection resets** (every live connection torn down at a scheduled
  instant) and **peer kill/restart** (the proxy refuses new connections
  for a window, so the dialer experiences a dead-then-revived peer).

Everything is driven by a declarative :class:`ChaosProfile` plus one
seed. Per-frame decisions come from per-link seeded generators keyed by
(seed, connection index, direction), so a run is reproducible frame-for
-frame given the same frame order — which is guaranteed per link (TCP
preserves order within a connection). :class:`ChaosLink` is the pure
per-link pipeline against an injectable clock; the reproducibility test
drives it with a virtual clock and asserts identical fault stats AND an
identical delivery trace across two runs.

CLI: ``-chaos-profile`` / ``-chaos-seed`` (host/cli.py) interpose one
proxy per ``-peers`` address and dial through it.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from noise_ec_tpu_torch.host.transport import FaultInjector, format_address

__all__ = ["ChaosLink", "ChaosProfile", "ChaosProxy"]

log = logging.getLogger("noise_ec_tpu_torch.resilience")

_MAX_FRAME = 64 << 20  # the transport's own frame cap
_DIRECTIONS = ("a2b", "b2a", "both")


@dataclass(frozen=True)
class ChaosProfile:
    """Declarative fault schedule for one proxy (all times are seconds
    relative to proxy start; probabilities are per frame).

    ``partitions`` entries are ``(start, duration, direction)`` with
    direction ``a2b`` (dialer→target), ``b2a`` or ``both``; the heal time
    is ``start + duration``. ``resets`` lists instants at which every
    live connection is torn down. ``kills`` are ``(start, duration)``
    windows during which the proxy also refuses new connections (the
    peer looks dead, then restarts).
    """

    drop: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    jitter: float = 0.0
    bandwidth: float = 0.0  # bytes/second; 0 = unlimited
    partitions: tuple = ()
    resets: tuple = ()
    kills: tuple = ()
    # Recurring kill/restart cycles: (start, interval, down, jitter)
    # tuples. Unlike ``kills`` (explicit one-shot windows), a churn
    # primitive DESCRIBES a schedule; the concrete seeded windows come
    # from :meth:`churn_windows` so the fleet lab and the proxy share
    # one expansion (and one reproducibility contract).
    churns: tuple = ()

    @classmethod
    def parse(cls, text: str) -> "ChaosProfile":
        """Parse the CLI grammar: comma-separated tokens.

        ``drop=0.05``  ``duplicate=0.01``  ``corrupt=0.01``
        ``reorder=0.02``  ``delay=0.005``  ``jitter=0.002``
        ``bandwidth=1048576`` (bytes/s)
        ``partition@START:DURATION[:DIRECTION]`` (direction defaults both)
        ``reset@TIME``  ``kill@START:DURATION``
        ``churn@START:INTERVAL:DOWN[:JITTER]`` (recurring kill/restart:
        from START, roughly every INTERVAL seconds the peer dies for
        DOWN seconds, each cycle's onset jittered by up to ±JITTER —
        the concrete windows are seeded, see :meth:`churn_windows`)

        Example: ``drop=0.05,corrupt=0.01,partition@2:2:a2b,reset@5``.
        """
        kwargs: dict = {}
        partitions, resets, kills, churns = [], [], [], []
        for raw in text.split(","):
            tok = raw.strip()
            if not tok:
                continue
            if tok.startswith("partition@"):
                parts = tok[len("partition@"):].split(":")
                if len(parts) not in (2, 3):
                    raise ValueError(f"bad partition token {tok!r}")
                direction = parts[2] if len(parts) == 3 else "both"
                if direction not in _DIRECTIONS:
                    raise ValueError(
                        f"partition direction must be one of {_DIRECTIONS}, "
                        f"got {direction!r}"
                    )
                partitions.append((float(parts[0]), float(parts[1]), direction))
            elif tok.startswith("reset@"):
                resets.append(float(tok[len("reset@"):]))
            elif tok.startswith("kill@"):
                parts = tok[len("kill@"):].split(":")
                if len(parts) != 2:
                    raise ValueError(f"bad kill token {tok!r}")
                kills.append((float(parts[0]), float(parts[1])))
            elif tok.startswith("churn@"):
                parts = tok[len("churn@"):].split(":")
                if len(parts) not in (3, 4):
                    raise ValueError(f"bad churn token {tok!r}")
                start, interval, down = (float(p) for p in parts[:3])
                jit = float(parts[3]) if len(parts) == 4 else 0.0
                if interval <= 0 or down <= 0 or jit < 0:
                    raise ValueError(
                        f"churn needs interval > 0, down > 0, jitter >= 0 "
                        f"({tok!r})"
                    )
                churns.append((start, interval, down, jit))
            elif "=" in tok:
                key, _, val = tok.partition("=")
                key = key.strip()
                if key not in (
                    "drop", "duplicate", "corrupt", "reorder",
                    "delay", "jitter", "bandwidth",
                ):
                    raise ValueError(f"unknown chaos knob {key!r}")
                kwargs[key] = float(val)
            else:
                raise ValueError(f"unparseable chaos token {tok!r}")
        return cls(
            partitions=tuple(partitions), resets=tuple(resets),
            kills=tuple(kills), churns=tuple(churns), **kwargs,
        )

    def partitioned(self, direction: str, now: float) -> bool:
        """Is ``direction`` severed at relative time ``now``? ``kills``
        sever both directions for their window. (``churns`` are NOT
        consulted here — they expand to seeded windows via
        :meth:`churn_windows`, which the proxy and the fleet lab fold
        in at their own level.)"""
        for start, duration, pdir in self.partitions:
            if pdir in (direction, "both") and start <= now < start + duration:
                return True
        return self.killed(now)

    def killed(self, now: float) -> bool:
        return any(s <= now < s + d for s, d in self.kills)

    def churn_windows(
        self, seed: int, horizon: float, stream: int = 0
    ) -> tuple[tuple[float, float], ...]:
        """Expand the ``churns`` schedule into concrete, sorted
        ``(start, duration)`` kill windows up to ``horizon`` seconds.

        Deterministic in (seed, stream, profile): the fleet lab passes
        one stream per peer so a thousand peers churn on STAGGERED,
        individually-jittered schedules from one seed — and the same
        seed reproduces every window exactly (the reproducibility test
        covers this alongside the frame-level faults)."""
        out: list[tuple[float, float]] = []
        for ci, (start, interval, down, jit) in enumerate(self.churns):
            rng = np.random.default_rng(
                np.random.SeedSequence([seed & 0xFFFFFFFF, stream, ci, 0xC4])
            )
            t = start
            while t < horizon:
                onset = t
                if jit > 0:
                    onset = max(0.0, t + float(rng.uniform(-jit, jit)))
                if onset < horizon:
                    out.append((onset, down))
                t += max(interval, 1e-3)
        return tuple(sorted(out))


class ChaosLink:
    """The deterministic per-(connection, direction) frame pipeline.

    Pure against an injectable relative clock: ``admit(frame, now)``
    returns the faulted forwarding plan ``[(bytes, delay_seconds), ...]``
    (empty = dropped) and mutates only this link's seeded state — which
    is what makes a run reproducible: same seed + profile + frame
    sequence ⇒ identical decisions, stats and delivery trace.
    """

    def __init__(self, profile: ChaosProfile, seed: int, conn_id: int,
                 direction: str):
        if direction not in ("a2b", "b2a"):
            raise ValueError(f"direction must be a2b or b2a, got {direction!r}")
        self.profile = profile
        self.direction = direction
        self.link_id = f"{conn_id}:{direction}"
        dir_code = 0 if direction == "a2b" else 1
        self.injector = FaultInjector(
            seed=np.random.SeedSequence([seed, conn_id, dir_code]),
            drop=profile.drop,
            duplicate=profile.duplicate,
            corrupt=profile.corrupt,
            reorder=profile.reorder,
        )
        self._jitter_rng = np.random.default_rng(
            np.random.SeedSequence([seed, conn_id, dir_code, 1])
        )
        self._bw_ready = 0.0  # relative time the simulated pipe frees up
        self.partitioned_frames = 0

    def admit(self, frame: bytes, now: float) -> list[tuple[bytes, float]]:
        """Fault one arriving frame at relative time ``now``; returns the
        ordered forwarding plan (possibly empty, possibly >1 entries for
        duplicates / released reorder holds)."""
        if self.profile.partitioned(self.direction, now):
            self.partitioned_frames += 1
            return []
        out = []
        for buf in self.injector.apply([frame], link=self.link_id):
            delay = self.profile.delay
            if self.profile.jitter > 0:
                delay += float(
                    self._jitter_rng.uniform(0.0, self.profile.jitter)
                )
            if self.profile.bandwidth > 0:
                self._bw_ready = (
                    max(self._bw_ready, now)
                    + (len(buf) + 4) / self.profile.bandwidth
                )
                delay += self._bw_ready - now
            out.append((buf, delay))
        return out

    def flush(self) -> Optional[bytes]:
        """Release a reorder-held frame at stream end (a held frame must
        not silently vanish when the connection closes — that would be a
        drop the drop probability never accounted for)."""
        return self.injector.flush(self.link_id)

    def stats(self) -> dict:
        s = dict(self.injector.stats)
        s["partitioned"] = self.partitioned_frames
        return s


@dataclass
class _ProxyConn:
    conn_id: int
    writers: list = field(default_factory=list)
    links: dict = field(default_factory=dict)


class ChaosProxy:
    """Seeded in-process TCP proxy applying a :class:`ChaosProfile`
    between a dialer and ``target_host:target_port`` (module docstring).

    Lifecycle mirrors the transport: own asyncio loop on a daemon
    thread; ``start()`` binds (port 0 = ephemeral, then ``self.port``),
    ``close()`` tears everything down. ``address`` is what the dialer
    bootstraps against instead of the real peer.
    """

    def __init__(
        self,
        target_host: str,
        target_port: int,
        *,
        profile: ChaosProfile,
        seed: int = 0,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
    ):
        self.target_host = target_host
        self.target_port = target_port
        self.profile = profile
        self.seed = seed
        # Churn primitives expand once, at construction, into concrete
        # seeded kill windows (same semantics as kill@: refuse new
        # connections + abort live ones for the window's duration).
        self._churn_kills: tuple = profile.churn_windows(
            seed, horizon=self.CHURN_HORIZON
        )
        self.host = listen_host
        self.port = listen_port
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever,
            name="noise-ec-chaos", daemon=True,
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self._lock = threading.Lock()
        self._conns: dict[int, _ProxyConn] = {}
        self._links: list[ChaosLink] = []  # every link ever opened (stats)
        self._conn_seq = 0
        self._epoch = 0.0
        self._fired_resets: set[float] = set()
        self.reset_count = 0
        self.refused_conns = 0
        self._watchdog: Optional[asyncio.Task] = None
        self._closed = False

    # ----------------------------------------------------------- lifecycle

    @property
    def address(self) -> str:
        return format_address("tcp", self.host, self.port)

    def start(self) -> "ChaosProxy":
        self._thread.start()

        async def _start():
            server = await asyncio.start_server(
                self._handle_conn, self.host, self.port
            )
            self._epoch = self._loop.time()
            self._watchdog = self._loop.create_task(self._watch())
            return server

        fut = asyncio.run_coroutine_threadsafe(_start(), self._loop)
        self._server = fut.result(timeout=10)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def close(self) -> None:
        if self._closed or not self._thread.is_alive():
            return
        self._closed = True

        async def _shutdown():
            if self._watchdog is not None:
                self._watchdog.cancel()
            if self._server is not None:
                self._server.close()
            self._abort_all()

        asyncio.run_coroutine_threadsafe(_shutdown(), self._loop).result(
            timeout=5
        )
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    # Churn schedules are unbounded; expand this far ahead (a proxy
    # living longer than this simply stops churning — soaks are minutes).
    CHURN_HORIZON = 3600.0

    def now(self) -> float:
        """Relative (schedule) time."""
        return self._loop.time() - self._epoch

    def rebase_clock(self) -> None:
        """Re-anchor the schedule clock at NOW: ``reset@T`` /
        ``partition@T`` fire T seconds from this call instead of from
        :meth:`start`. Harnesses call it once their peers have
        REGISTERED, so scheduled chaos always hits a live connection —
        on a loaded box, registration (dial + handshake + gossip) can
        take longer than the first scheduled event, which then aborts
        zero connections and the run never exercises the fault it was
        scored on (the chaos-soak transport-timing flake). Already-fired
        resets are re-armed; ``loop.time()`` is thread-safe, so no loop
        hop is needed."""
        self._epoch = self._loop.time()
        self._fired_resets.clear()

    def _killed(self, now: float) -> bool:
        """One-shot kill windows plus expanded churn windows."""
        return self.profile.killed(now) or any(
            s <= now < s + d for s, d in self._churn_kills
        )

    # ------------------------------------------------------------ schedule

    async def _watch(self) -> None:
        """Fire scheduled resets and kill-window onsets (25 ms tick —
        schedule granularity, not fault granularity)."""
        killed_fired: set[float] = set()
        while True:
            await asyncio.sleep(0.025)
            now = self.now()
            for t in self.profile.resets:
                if t <= now and t not in self._fired_resets:
                    self._fired_resets.add(t)
                    self.reset_count += 1
                    self._abort_all()
                    log.info("chaos: reset all connections at t=%.3fs", now)
            for start, _duration in (
                tuple(self.profile.kills) + self._churn_kills
            ):
                if start <= now and start not in killed_fired:
                    killed_fired.add(start)
                    self._abort_all()
                    log.info("chaos: peer killed at t=%.3fs", now)

    def _abort_all(self) -> None:
        with self._lock:
            writers = [w for c in self._conns.values() for w in c.writers]
        for w in writers:
            try:
                w.transport.abort()
            except Exception:  # noqa: BLE001 — already-dead transport
                pass

    # ------------------------------------------------------------ dataflow

    async def _handle_conn(
        self, c_reader: asyncio.StreamReader, c_writer: asyncio.StreamWriter
    ) -> None:
        if self._killed(self.now()) or self._closed:
            # The "peer" is dead for this window: refuse service.
            self.refused_conns += 1
            c_writer.close()
            return
        try:
            t_reader, t_writer = await asyncio.open_connection(
                self.target_host, self.target_port
            )
        except OSError:
            c_writer.close()
            return
        with self._lock:
            conn_id = self._conn_seq
            self._conn_seq += 1
            conn = _ProxyConn(conn_id, writers=[c_writer, t_writer])
            for direction in ("a2b", "b2a"):
                link = ChaosLink(self.profile, self.seed, conn_id, direction)
                conn.links[direction] = link
                self._links.append(link)
            self._conns[conn_id] = conn
        pumps = [
            self._loop.create_task(
                self._pump(c_reader, t_writer, conn.links["a2b"])
            ),
            self._loop.create_task(
                self._pump(t_reader, c_writer, conn.links["b2a"])
            ),
        ]
        try:
            await asyncio.wait(pumps, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for p in pumps:
                p.cancel()
            for w in (c_writer, t_writer):
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass
            with self._lock:
                self._conns.pop(conn_id, None)

    async def _pump(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        link: ChaosLink,
    ) -> None:
        try:
            while True:
                hdr = await reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                if ln > _MAX_FRAME:
                    return  # hostile/garbage stream: sever it
                body = await reader.readexactly(ln)
                for buf, delay in link.admit(body, self.now()):
                    if delay > 0:
                        await asyncio.sleep(delay)
                    writer.write(struct.pack("<I", len(buf)) + buf)
                    await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            held = link.flush()
            if held is not None:
                try:
                    writer.write(struct.pack("<I", len(held)) + held)
                except Exception:  # noqa: BLE001 — peer already gone
                    pass

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Aggregate fault stats across every link this proxy ever
        opened, plus connection-level events."""
        agg: dict[str, int] = {
            "delivered": 0, "dropped": 0, "duplicated": 0, "corrupted": 0,
            "reordered": 0, "partitioned": 0,
        }
        with self._lock:
            links = list(self._links)
            connections = self._conn_seq
        for link in links:
            for key, val in link.stats().items():
                agg[key] = agg.get(key, 0) + val
        agg["connections"] = connections
        agg["resets"] = self.reset_count
        agg["refused_conns"] = self.refused_conns
        return agg
