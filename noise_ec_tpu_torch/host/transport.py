"""Transports: the L0 layer (SURVEY.md §1) — peer registry, broadcast
fan-out, and plugin dispatch.

The reference delegates this layer to perlin-network/noise (SURVEY.md §2.3
D2): a builder-configured network with ordered plugin registration, a
blocking accept loop, ``Bootstrap(peers...)`` dial-out, per-message
signatures, and ``Broadcast`` fan-out to every connected peer. Two
implementations here share that contract:

- :class:`LoopbackHub` / :class:`LoopbackNetwork` — the in-process fake the
  reference lacks (SURVEY.md §4 "multi-node story"): N peers in one
  process, deterministic fault injection (drop / duplicate / corrupt /
  reorder) on every link, driving the full Receive state machine.
- :class:`TCPNetwork` — a real asyncio TCP transport with length-prefixed,
  identity-carrying, Ed25519-signed frames, serving the reference's
  multi-process deployment shape (main.go:137-173).

Both deliver messages to plugins through :class:`Ctx`, the slice of
noise's ``PluginContext`` the reference uses (main.go:53-87).

The TCP wire hot loop (docs/design.md §15) is built for six-figure
msgs/s on the same three rules as the device data path (§12): re-use
every buffer, move fewer bytes, amortize every dispatch —

- **recv**: each connection is an :class:`asyncio.BufferedProtocol`
  whose ``recv_into`` target is a per-connection :class:`_FrameRing`;
  frames parse IN PLACE as memoryview slices (the ``_to_sym`` no-copy
  discipline extended to the wire marshal) and the payload is copied
  exactly once, into the ``Shard`` fields;
- **verify**: frame signatures are not checked on the loop thread; the
  digest is streamed from the ring views and the (key, digest, sig)
  triple rides a per-sender verify queue whose drain batches cohorts
  through ``crypto.verify_batch`` (per-item fan-back on batch failure)
  on the dispatch pool;
- **send**: a broadcast's shards coalesce into one ``SHARD_BATCH``
  frame (one signature per cohort), frames queue as scatter-gather
  buffer lists, and a peer flush is one ``sendmsg`` iovec syscall;
- **scale**: ``recv_shards`` > 1 opens SO_REUSEPORT acceptor shards
  (one event loop thread each, kernel-balanced) all feeding the ONE
  shared :class:`_SerialDispatcher`, so per-peer DRR fairness and
  per-sender ordering hold no matter which shard owns the socket.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket as _socket
import struct
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from noise_ec_tpu_torch.host.crypto import (
    Blake2bPolicy,
    Ed25519Policy,
    KeyPair,
    PeerID,
)
from noise_ec_tpu_torch.host.wire import Shard, WireError
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.metrics import Timer
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import current_trace_id, span, trace_key

__all__ = [
    "Ctx",
    "FaultInjector",
    "LoopbackHub",
    "LoopbackNetwork",
    "TCPNetwork",
    "format_address",
]

log = logging.getLogger("noise_ec_tpu_torch.host.transport")


def format_address(protocol: str, host: str, port: int) -> str:
    """network.FormatAddress(protocol, host, port) — main.go:148."""
    return f"{protocol}://{host}:{port}"


class _TransportMetrics:
    """Cached children of the per-peer transport metric families.

    ``Family.labels()`` is a lock + dict get; the frame hot path pays one
    plain dict get here instead. Peer label cardinality is bounded: the
    address inside a frame is self-claimed, so past ``MAX_PEERS`` distinct
    labels new peers collapse into ``peer="other"`` rather than letting a
    hostile churner grow the registry without bound.
    """

    MAX_PEERS = 256

    def __init__(self):
        reg = default_registry()
        self._shards_in = reg.counter("noise_ec_transport_shards_in_total")
        self._shards_out = reg.counter("noise_ec_transport_shards_out_total")
        self._bytes_in = reg.counter("noise_ec_transport_bytes_in_total")
        self._bytes_out = reg.counter("noise_ec_transport_bytes_out_total")
        self._errors = reg.counter("noise_ec_transport_frame_errors_total")
        self._in: dict[str, tuple] = {}
        self._out: dict[str, tuple] = {}
        self._err: dict[str, object] = {}

    def _pair(self, cache: dict, shards, bytes_, peer: str) -> tuple:
        pair = cache.get(peer)
        if pair is None:
            if len(cache) >= self.MAX_PEERS:
                peer = "other"
                pair = cache.get(peer)
                if pair is not None:
                    return pair
            pair = cache[peer] = (
                shards.labels(peer=peer), bytes_.labels(peer=peer)
            )
        return pair

    def record_in(self, peer: str, nbytes: int, count: int = 1) -> None:
        c, b = self._pair(self._in, self._shards_in, self._bytes_in, peer)
        c.add(count)
        b.add(nbytes)

    def record_out(self, peer: str, nbytes: int, count: int = 1) -> None:
        c, b = self._pair(self._out, self._shards_out, self._bytes_out, peer)
        c.add(count)
        b.add(nbytes)

    def error(self, kind: str) -> None:
        c = self._err.get(kind)
        if c is None:
            c = self._err[kind] = self._errors.labels(kind=kind)
        c.add(1)


_transport_metrics: Optional[_TransportMetrics] = None


def transport_metrics() -> _TransportMetrics:
    """Process-wide transport metrics (lazy: first transport constructs)."""
    global _transport_metrics
    if _transport_metrics is None:
        _transport_metrics = _TransportMetrics()
    return _transport_metrics


class _WireMetrics:
    """Cached children of the ``noise_ec_wire_*`` hot-loop families
    (docs/design.md §15): batch-verify amortization, ring occupancy,
    send-side syscall coalescing."""

    def __init__(self):
        reg = default_registry()
        self._batch_size = reg.histogram(
            "noise_ec_wire_verify_batch_size"
        ).labels()
        self._ok = reg.counter(
            "noise_ec_wire_verified_frames_total"
        ).labels(outcome="ok")
        self._bad = reg.counter(
            "noise_ec_wire_verified_frames_total"
        ).labels(outcome="bad")
        self._fallbacks = reg.counter(
            "noise_ec_wire_verify_fallbacks_total"
        ).labels()
        self._per_syscall = reg.histogram(
            "noise_ec_wire_frames_per_syscall"
        ).labels()
        self._saved = reg.counter(
            "noise_ec_wire_syscalls_saved_total"
        ).labels()
        self._per_fill = reg.histogram(
            "noise_ec_wire_frames_per_fill"
        ).labels()
        self._ring = reg.histogram("noise_ec_wire_ring_bytes").labels()
        self._shards_per_frame = reg.histogram(
            "noise_ec_wire_shards_per_frame"
        ).labels()
        self._recv_shards = reg.gauge("noise_ec_wire_recv_shards").labels()

    def verify_batch(self, size: int, ok: int, fell_back: bool) -> None:
        self._batch_size.observe(size)
        if ok:
            self._ok.add(ok)
        if size - ok:
            self._bad.add(size - ok)
        if fell_back:
            self._fallbacks.add(1)

    def flush(self, frames: int, syscalls: int = 1) -> None:
        self._per_syscall.observe(frames)
        if frames > syscalls:
            self._saved.add(frames - syscalls)

    def fill(self, frames: int, ring_pending: int) -> None:
        self._per_fill.observe(frames)
        self._ring.observe(ring_pending)

    def batch_out(self, shards: int) -> None:
        self._shards_per_frame.observe(shards)

    def set_recv_shards(self, n: int) -> None:
        self._recv_shards.set(n)


_wire_metrics: Optional[_WireMetrics] = None


def wire_metrics() -> _WireMetrics:
    global _wire_metrics
    if _wire_metrics is None:
        _wire_metrics = _WireMetrics()
    return _wire_metrics


class _FrameRing:
    """Per-connection receive ring: ``recv_into`` lands bytes in the
    tail, complete length-prefixed frames parse IN PLACE as memoryview
    slices of the ring. The views are only valid until the next
    :meth:`writable` call (compaction may slide the unread region), so
    the frame consumer materializes what it keeps — which on the shard
    path is exactly one copy, into the ``Shard`` fields.
    """

    __slots__ = ("buf", "rpos", "wpos")

    MIN_RECV = 64 << 10  # smallest recv_into window we offer the kernel

    def __init__(self, capacity: int = 256 << 10):
        self.buf = bytearray(capacity)
        self.rpos = 0
        self.wpos = 0

    def pending(self) -> int:
        """Bytes received but not yet parsed (a straddling frame)."""
        return self.wpos - self.rpos

    def writable(self, sizehint: int = 0) -> memoryview:
        """The writable tail as a memoryview ≥ max(sizehint, MIN_RECV)
        bytes, compacting (or re-allocating, for an over-ring frame)
        first when the tail ran out. Never called with live frame
        views — the parse loop consumes them before the next fill."""
        need = max(self.MIN_RECV, sizehint)
        if len(self.buf) - self.wpos < need:
            pend = self.wpos - self.rpos
            if len(self.buf) - pend >= need and self.rpos:
                # Slide the unread tail to the front (amortized: each
                # byte moves at most once per ring traversal).
                self.buf[:pend] = self.buf[self.rpos : self.wpos]
            else:
                # A single frame larger than the ring: move to a fresh,
                # bigger buffer (a plain resize would fault on any
                # still-exported view of the old one).
                cap = max(len(self.buf) * 2, pend + need)
                new = bytearray(cap)
                new[:pend] = self.buf[self.rpos : self.wpos]
                self.buf = new
            self.rpos, self.wpos = 0, pend
        return memoryview(self.buf)[self.wpos :]

    def feed(self, nbytes: int) -> None:
        self.wpos += nbytes

    def feed_bytes(self, data: bytes) -> None:
        """Copy-in fill for transports without a recv_into surface
        (the KCP reader)."""
        view = self.writable(len(data))
        view[: len(data)] = data
        view.release()
        self.wpos += len(data)

    def frames(self, max_frame: int):
        """Yield every complete frame body as a memoryview; leaves a
        partial frame (straddling the next fill) in place. Raises
        WireError on an over-cap length prefix."""
        mv = memoryview(self.buf)
        try:
            while self.wpos - self.rpos >= 4:
                (ln,) = struct.unpack_from("<I", self.buf, self.rpos)
                if ln > max_frame:
                    raise WireError(f"frame length {ln} exceeds cap")
                end = self.rpos + 4 + ln
                if end > self.wpos:
                    return
                frame = mv[self.rpos + 4 : end]
                self.rpos = end
                yield frame
            if self.rpos == self.wpos:
                self.rpos = self.wpos = 0
        finally:
            mv.release()


class _WireConn(asyncio.BufferedProtocol):
    """One TCP connection of the wire hot loop.

    Reader half: an ``asyncio.BufferedProtocol`` — the event loop
    ``recv_into``s straight into this connection's :class:`_FrameRing`
    (no intermediate bytes objects) and every complete frame is handed
    to ``TCPNetwork._on_frame`` as an in-place memoryview.

    Writer half: the StreamWriter-shaped facade the rest of the
    transport already speaks (the ``KcpWriter`` duck type): ``write`` /
    ``drain`` / ``close`` / ``transport.get_write_buffer_size``, plus
    ``vectored_socket`` — the raw socket the flush path hands scatter-
    gather frame lists to ``sendmsg`` when the transport buffer is
    empty (one syscall per peer flush).
    """

    def __init__(self, net: "TCPNetwork", conn: "_Conn"):
        self.net = net
        self.conn = conn
        self.ring = _FrameRing()
        self.transport = None
        self._wire_loop: Optional[asyncio.AbstractEventLoop] = None
        self._sock = None
        self._paused = False
        self._drain_waiters: list[asyncio.Future] = []

    # -- protocol callbacks (owning loop thread only) --

    def connection_made(self, transport) -> None:
        self.transport = transport
        self._wire_loop = asyncio.get_running_loop()
        sock = transport.get_extra_info("socket")
        # asyncio hands out a TransportSocket facade that deprecates
        # sendmsg; the flush path needs the real socket underneath.
        self._sock = getattr(sock, "_sock", sock)

    def get_buffer(self, sizehint: int) -> memoryview:
        return self.ring.writable(sizehint if sizehint > 0 else 0)

    def buffer_updated(self, nbytes: int) -> None:
        self.ring.feed(nbytes)
        try:
            count = 0
            for frame in self.ring.frames(_MAX_FRAME):
                count += 1
                self.net._on_frame(frame, self, self.conn)
            if count:
                wire_metrics().fill(count, self.ring.pending())
        except WireError as exc:
            transport_metrics().error("wire")
            self.net._record_error(exc)
            self.transport.close()
        except Exception as exc:  # noqa: BLE001 — isolate the loop
            self.net._record_error(exc)
            self.transport.close()

    def eof_received(self) -> bool:
        return False  # close on peer FIN, like the stream read loop

    def connection_lost(self, exc) -> None:
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_result(None)
        self._drain_waiters.clear()
        self.net._drop_writer(self)

    def pause_writing(self) -> None:
        self._paused = True

    def resume_writing(self) -> None:
        self._paused = False
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_result(None)
        self._drain_waiters.clear()

    # -- StreamWriter facade --

    @property
    def vectored_socket(self):
        """Raw socket for scatter-gather sendmsg flushes, or None when
        the transport buffer is non-empty / paused / closing (then the
        flush must ride the ordered transport buffer instead)."""
        if (
            self._sock is None
            or self._paused
            or self.transport is None
            or self.transport.is_closing()
            or self.transport.get_write_buffer_size() > 0
        ):
            return None
        return self._sock

    def write(self, data) -> None:
        self.transport.write(data)

    def writelines(self, bufs) -> None:
        self.transport.writelines(bufs)

    async def drain(self) -> None:
        if self.transport is None or self.transport.is_closing():
            raise ConnectionResetError("connection lost")
        if not self._paused:
            return
        fut = self._wire_loop.create_future()
        self._drain_waiters.append(fut)
        await fut

    def close(self) -> None:
        t = self.transport
        if t is None:
            return
        loop = self._wire_loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is None or running is loop:
            t.close()
        else:
            # transports are not thread-safe; route cross-thread closes
            # (network.close(), _drop_writer from a dispatch worker)
            # through the owning loop.
            loop.call_soon_threadsafe(t.close)

    def half_close(self) -> None:
        """FIN our send side but keep draining inbound frames until the
        peer's own FIN answers (mutual-dial loser demotion): a hard
        ``close()`` discards inbound data still unread in the kernel
        buffer, losing frames the peer wrote before it learned the
        tie-break verdict. A backstop timer full-closes if the peer
        never FINs back (``eof_received`` returning False makes a
        well-behaved peer close promptly)."""
        loop = self._wire_loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is None or running is loop:
            self._half_close_here()
        else:
            loop.call_soon_threadsafe(self._half_close_here)

    # noise-ec: loop-affine
    def _half_close_here(self) -> None:
        t = self.transport
        if t is None or t.is_closing():
            return
        try:
            if not t.can_write_eof():
                t.close()
                return
            t.write_eof()
        # noise-ec: allow(event-on-swallow) — teardown fallback — the hard close below is the only remaining action
        except Exception:  # noqa: BLE001 — fall back to the hard close
            t.close()
            return
        if self._wire_loop is not None:
            self._wire_loop.call_later(
                self.net.connection_timeout, self.close
            )

    def is_closing(self) -> bool:
        return self.transport is None or self.transport.is_closing()

    def get_extra_info(self, name, default=None):
        if self.transport is None:
            return default
        return self.transport.get_extra_info(name, default)


class Ctx:
    """Plugin context handed to ``plugin.receive`` on every delivery.

    ``trace`` is the originating request's trace id when the delivery
    arrived inside a traced user request (the SHARD_BATCH trailing
    trace block, or the loopback's same-thread request scope) — the
    receive path stamps it as a ``request_trace`` span attr so a
    collector can merge receive-side pipeline spans into the
    originator's request trace. None for untraced traffic."""

    def __init__(self, msg: object, sender: PeerID,
                 trace: Optional[str] = None):
        self._msg = msg
        self._sender = sender
        self.trace = trace

    def message(self) -> object:
        return self._msg

    def sender(self) -> PeerID:
        return self._sender

    def client_public_key(self) -> bytes:
        return self._sender.public_key


# --------------------------------------------------------------- loopback


class FaultInjector:
    """Deterministic link-fault model shared by the loopback transport and
    the TCP chaos proxy (resilience/chaos.py).

    The reference has no fault-injection story at all (SURVEY.md §5 failure
    row); this is the first-class harness it calls for. Faults apply
    per-delivery, driven by a seeded generator (``seed`` may be an int or
    a ``numpy.random.SeedSequence``) so every run reproduces:

    - ``drop``: probability a delivery is discarded;
    - ``duplicate``: probability a delivery is made twice;
    - ``corrupt``: probability one byte of the wire bytes is flipped;
    - ``reorder``: probability a delivery is held in a one-slot delay line
      and released right after the next delivery on the same link (a
      pairwise swap; the slot is per-link, so a held message can neither
      migrate to another receiver nor be attributed to a later sender). At
      most one delivery per link is pending at stream end — within any
      k-of-n parity budget.
    """

    def __init__(
        self,
        seed=0,
        drop: float = 0.0,
        duplicate: float = 0.0,
        corrupt: float = 0.0,
        reorder: float = 0.0,
    ):
        self.rng = np.random.default_rng(seed)
        self.drop = drop
        self.duplicate = duplicate
        self.corrupt = corrupt
        self.reorder = reorder
        self._slots: dict[str, bytes] = {}  # per-link delay line for reorder
        self.stats = {"delivered": 0, "dropped": 0, "duplicated": 0,
                      "corrupted": 0, "reordered": 0}

    def apply(self, deliveries: list[bytes], link: str = "") -> list[bytes]:
        """Map a list of wire-byte deliveries on ``link`` to the faulted
        list. Stateful across calls: a reordered delivery from an earlier
        call is released behind a later one on the same link."""
        out: list[bytes] = []
        for buf in deliveries:
            if self.rng.random() < self.drop:
                self.stats["dropped"] += 1
                continue
            copies = 1
            if self.rng.random() < self.duplicate:
                copies = 2
                self.stats["duplicated"] += 1
            for _ in range(copies):
                b = buf
                if self.rng.random() < self.corrupt:
                    b = bytearray(b)
                    if b:
                        b[int(self.rng.integers(0, len(b)))] ^= 1 << int(
                            self.rng.integers(0, 8)
                        )
                    b = bytes(b)
                    self.stats["corrupted"] += 1
                if link not in self._slots and self.rng.random() < self.reorder:
                    self._slots[link] = b  # held; rides behind the next delivery
                    self.stats["reordered"] += 1
                    continue
                out.append(b)
                self.stats["delivered"] += 1
                held = self._slots.pop(link, None)
                if held is not None:
                    out.append(held)
                    self.stats["delivered"] += 1
        return out

    @property
    def pending(self) -> int:
        """Reorder-held deliveries not yet released (at most one per
        link). The accounting identity every caller can rely on:
        ``delivered + dropped + pending == inputs + duplicated``."""
        return len(self._slots)

    def flush(self, link: str = "") -> Optional[bytes]:
        """Release ``link``'s reorder-held delivery, if any. Stream-end
        hook (the chaos proxy calls it when a connection closes): a held
        frame must be forwarded, not silently become an unaccounted
        drop. Counts as delivered."""
        held = self._slots.pop(link, None)
        if held is not None:
            self.stats["delivered"] += 1
        return held


class LoopbackHub:
    """An in-process peer set: every registered network sees every other."""

    def __init__(self, fault_injector: Optional[FaultInjector] = None):
        self.nodes: dict[str, "LoopbackNetwork"] = {}
        self.faults = fault_injector

    def register(self, node: "LoopbackNetwork") -> None:
        self.nodes[node.id.address] = node

    def fan_out(self, sender: "LoopbackNetwork", wire_bytes: bytes) -> None:
        """Deliver one message to every peer except the sender
        (net.Broadcast semantics, main.go:206-208)."""
        metrics = transport_metrics()
        for addr, node in self.nodes.items():
            if addr == sender.id.address:
                continue
            metrics.record_out(addr, len(wire_bytes))
            bufs = [wire_bytes]
            if self.faults is not None:
                bufs = self.faults.apply(bufs, link=f"{sender.id.address}->{addr}")
            for buf in bufs:
                node.deliver(buf, sender.id)


class LoopbackNetwork:
    """One fake peer. API mirrors what the plugin needs from noise's
    ``*network.Network``: ``.id``, ``.keys``, ``.broadcast``, plugin
    registration and dispatch."""

    def __init__(self, hub: LoopbackHub, address: str, keys: Optional[KeyPair] = None):
        self.keys = keys or KeyPair.random()
        self.id = PeerID.create(address, self.keys.public_key)
        self.hub = hub
        self.plugins: list = []
        # bounded: hostile traffic appends one entry per bad frame
        self.errors: deque[Exception] = deque(maxlen=256)
        self.error_count = 0
        hub.register(self)

    def add_plugin(self, plugin) -> None:
        self.plugins.append(plugin)
        attach = getattr(plugin, "attach_network", None)
        if attach is not None:
            attach(self)

    def _record_error(self, exc: Exception) -> None:
        self.errors.append(exc)
        self.error_count += 1

    def broadcast(self, msg: Shard) -> None:
        with span("wire_encode", key=trace_key(msg.file_signature)):
            wire = msg.marshal()
        self.hub.fan_out(self, wire)

    def broadcast_many(self, msgs) -> None:
        """Cohort broadcast, one delivery per shard: the loopback keeps
        per-shard fan-out so the fault injector's per-delivery model
        (drop/duplicate/corrupt/reorder one SHARD at a time) is
        unchanged; only the TCP transport coalesces cohorts into
        SHARD_BATCH frames."""
        for msg in msgs:
            self.broadcast(msg)

    def deliver(self, wire_bytes: bytes, sender: PeerID) -> None:
        """Hub-side delivery: decode and dispatch to every plugin in
        registration order. Decode/dispatch errors are recorded, not
        raised — one bad message must not kill the receive loop."""
        metrics = transport_metrics()
        try:
            msg = Shard.unmarshal(wire_bytes)
        except WireError as exc:
            metrics.error("wire")
            self._record_error(exc)
            return
        metrics.record_in(sender.address, len(wire_bytes))
        # Synchronous fan-out: delivery runs on the SENDER's thread, so
        # the originating request scope is still active here — adopt its
        # id, the loopback equivalent of the SHARD_BATCH trace block.
        rt = current_trace_id()
        ctx = Ctx(msg, sender, trace=rt)
        with span("deliver", key=trace_key(msg.file_signature),
                  **({"request_trace": rt} if rt else {})):
            for plugin in self.plugins:
                try:
                    plugin.receive(ctx)
                except Exception as exc:  # noqa: BLE001 — isolate the loop
                    metrics.error("handler")
                    self._record_error(exc)


# -------------------------------------------------------------------- TCP

# Frame layout (all little-endian):
#   u32 frame_len | u8 opcode | u32 addr_len | addr utf-8 | 32B pubkey |
#   u32 payload_len | payload | 64B ed25519 signature over
#   blake2b256(opcode ‖ u32le(addr_len) ‖ addr ‖ u32le(payload_len) ‖ payload)
# The preimage is length-delimited, so no byte can migrate between the addr
# and payload fields without invalidating the signature (frame malleability).
# HELLO carries the dialer's nonce and introduces the peer (the discovery
# handshake); SHARD carries a marshaled Shard; PEERS carries a list of peer
# addresses (gossip). Every frame is signed, the transport-level integrity
# the reference gets from noise's signed messages (SURVEY.md §2.3 D2).
_OP_HELLO = 1        # dialer -> acceptor: payload = dialer 32B nonce
_OP_HELLO_REPLY = 3  # acceptor -> dialer: payload = dialer_nonce ‖ acceptor_nonce
_OP_HELLO_ACK = 4    # dialer -> acceptor: payload = acceptor_nonce
_OP_SHARD = 2        # payload = marshaled Shard
_OP_PEERS = 5        # payload = u32 count | count x (u32 len | addr utf-8)
# One broadcast's shard cohort in ONE signed frame (docs/design.md §15):
# payload = u32 count | count x (u32 len | marshaled Shard). One Ed25519
# sign on the send side and one (batched) verify on the receive side
# cover the whole cohort, where _OP_SHARD paid one of each per shard.
_OP_SHARD_BATCH = 6
_MAX_FRAME = 64 << 20
_NONCE_LEN = 32
# Keep one SHARD_BATCH frame's coalescing win without queueing a
# multi-second head-of-line blob behind it: cohorts above this split.
_MAX_BATCH_FRAME = 8 << 20


def _sign_preimage(opcode: int, addr: bytes, payload: bytes) -> bytes:
    return b"".join(
        [
            bytes([opcode]),
            struct.pack("<I", len(addr)),
            addr,
            struct.pack("<I", len(payload)),
            payload,
        ]
    )


# Request-trace ids are ``req-<16 hex>`` (20 chars); the cap keeps a
# hostile frame from smuggling bulk data through the trace block.
_MAX_TRACE_LEN = 64


def _encode_shard_batch_parts(msgs, trace: Optional[str] = None) -> list:
    """SHARD_BATCH payload as scatter-gather parts: each shard's
    ``marshal_parts`` buffers ride through unjoined, so the dominant
    ``shard_data`` is never copied on the send path.

    ``trace`` (the originating request's trace id, when the cohort is
    sent inside a traced user request) rides as an OPTIONAL trailing
    ``u32 len | utf-8`` block after the shards — absent entirely for
    untraced traffic, so the frame stays byte-identical to the pre-
    trace wire format in that case and old decoders never see it."""
    parts = [struct.pack("<I", len(msgs))]
    for m in msgs:
        head, data, tail = m.marshal_parts()
        parts.append(
            struct.pack("<I", len(head) + len(data) + len(tail))
        )
        if head:
            parts.append(head)
        if data:
            parts.append(data)
        if tail:
            parts.append(tail)
    if trace:
        raw = trace.encode()[:_MAX_TRACE_LEN]
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return parts


def _decode_shard_batch(payload) -> tuple[list[Shard], Optional[str]]:
    """Parse a SHARD_BATCH payload (bytes or an in-place ring view) to
    ``(shards, trace_id)``. The trace block is optional (see
    ``_encode_shard_batch_parts``); any OTHER trailing bytes — or a
    trace block whose length does not close the payload exactly —
    still reject the frame."""
    if len(payload) < 4:
        raise WireError("truncated shard batch")
    (count,) = struct.unpack_from("<I", payload, 0)
    if count > 4096:
        raise WireError(f"shard batch count {count} exceeds cap")
    pos = 4
    out = []
    for _ in range(count):
        if pos + 4 > len(payload):
            raise WireError("truncated shard batch")
        (ln,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        if pos + ln > len(payload):
            raise WireError("truncated shard batch")
        out.append(Shard.unmarshal(payload[pos : pos + ln]))
        pos += ln
    trace: Optional[str] = None
    if pos != len(payload):
        if pos + 4 > len(payload):
            raise WireError("trailing bytes in shard batch")
        (tlen,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        if tlen > _MAX_TRACE_LEN or pos + tlen != len(payload):
            raise WireError("trailing bytes in shard batch")
        try:
            trace = bytes(payload[pos : pos + tlen]).decode()
        except UnicodeDecodeError as exc:
            raise WireError(f"bad trace block in shard batch: {exc}")
    return out, trace


def _encode_peer_list(addresses: list[str]) -> bytes:
    parts = [struct.pack("<I", len(addresses))]
    for a in addresses:
        raw = a.encode()
        parts.append(struct.pack("<I", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _decode_peer_list(payload: bytes) -> list[str]:
    pos = 0
    (count,) = struct.unpack_from("<I", payload, pos); pos += 4
    if count > 4096:
        raise WireError(f"peer list count {count} exceeds cap")
    out = []
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", payload, pos); pos += 4
        if pos + ln > len(payload):
            raise WireError("truncated peer list")
        out.append(payload[pos : pos + ln].decode()); pos += ln
    if pos != len(payload):
        raise WireError("trailing bytes in peer list")
    return out


class _SerialDispatcher:
    """Per-key ordered dispatch on a shared worker pool.

    Deliveries from one sender run strictly in order (the reference's
    per-connection dispatch semantics), but a slow handler on one sender's
    stream — e.g. a first-geometry FEC plan taking milliseconds to
    seconds — never blocks delivery from other senders (no single-worker
    head-of-line blocking). Each key holds a bounded FIFO; one drain task per
    key runs on the pool at a time.
    """

    # Live dispatchers for the aggregate queue-depth gauge (weak: a
    # closed network's dispatcher must not pin itself via the callback).
    _instances: "weakref.WeakSet[_SerialDispatcher]" = weakref.WeakSet()
    _gauge_registered = False

    def __init__(self, max_workers: int = 4, max_queue: int = 4096,
                 on_error=None):
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="noise-ec-dispatch"
        )
        # A Condition, not a bare Lock: submit_wait blocks on it until a
        # drain frees window space (``with self._lock`` still takes the
        # underlying lock everywhere else).
        self._lock = threading.Condition(threading.Lock())
        self._queues: dict[bytes, deque] = {}
        self._active: set[bytes] = set()
        self.max_queue = max_queue
        self.overflows = 0
        self._waiters = 0  # submit_wait callers currently blocked
        reg = default_registry()
        self._overflow_counter = reg.counter(
            "noise_ec_dispatch_overflows_total"
        ).labels()
        self._latency_hist = reg.histogram("noise_ec_dispatch_seconds").labels()
        self._bp_waits = reg.counter(
            "noise_ec_backpressure_waits_total"
        ).labels(layer="dispatch")
        self._bp_hist = reg.histogram(
            "noise_ec_backpressure_wait_seconds"
        ).labels(layer="dispatch")
        cls = type(self)
        cls._instances.add(self)
        if not cls._gauge_registered:
            cls._gauge_registered = True
            reg.gauge("noise_ec_dispatch_queue_depth").set_callback(
                lambda: sum(d.queue_depth() for d in list(cls._instances))
            )
            reg.gauge("noise_ec_backpressure_queue_depth").set_callback(
                lambda: sum(d._waiters for d in list(cls._instances)),
                layer="dispatch",
            )
        # Error contract: a handler that raises is reported to ``on_error``
        # (an ``(exc) -> None`` recorder) and counted — never silently
        # swallowed. The TCP dispatch wrapper records into Network.errors;
        # a bare function submitted by a future caller still gets counted
        # and logged rather than vanishing.
        self.dropped_errors = 0
        self._on_error = on_error

    def submit(self, key: bytes, fn, *args) -> bool:
        """Enqueue ``fn(*args)`` on ``key``'s ordered stream. Returns False
        (and counts an overflow) if the key's window is full."""
        with self._lock:
            q = self._queues.setdefault(key, deque())
            if len(q) >= self.max_queue:
                self.overflows += 1
                self._overflow_counter.add(1)
                return False
            q.append((fn, args))
            if key not in self._active:
                self._active.add(key)
                self._pool.submit(self._drain, key)
        return True

    def submit_wait(self, key: bytes, fn, *args,
                    timeout: float = 30.0) -> bool:
        """Blocking submit: when ``key``'s window is full, BLOCK the
        producer until a drain frees space instead of dropping — the
        backpressure shape for in-process producers (the fleet hub),
        who would rather slow than lose deliveries. Never call from the
        drain pool or an event-loop thread (the drain this waits for may
        be behind the caller). Returns False only when ``timeout``
        expires with the window still full (counted as an overflow)."""
        t0 = None
        deadline = 0.0
        try:
            with self._lock:
                while True:
                    q = self._queues.setdefault(key, deque())
                    if len(q) < self.max_queue:
                        q.append((fn, args))
                        if key not in self._active:
                            self._active.add(key)
                            self._pool.submit(self._drain, key)
                        return True
                    if t0 is None:
                        t0 = time.monotonic()
                        deadline = t0 + timeout
                        self._bp_waits.add(1)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.overflows += 1
                        self._overflow_counter.add(1)
                        return False
                    self._waiters += 1
                    try:
                        self._lock.wait(min(remaining, 0.5))
                    finally:
                        self._waiters -= 1
        finally:
            if t0 is not None:
                self._bp_hist.observe(time.monotonic() - t0)

    # Items drained per pool turn when ONE sender is active: a
    # continuously-busy sender yields the worker back to the pool every
    # batch, so max_workers concurrent hot senders cannot starve
    # everyone else's delivery. With several senders active the quantum
    # shrinks (deficit round-robin, _drain) so a spammy peer's deep
    # queue cannot hold a worker for a full batch while a quiet peer's
    # single delivery waits.
    DRAIN_BATCH = 16

    def _drain(self, key: bytes) -> None:
        # Per-peer fairness: the per-turn quantum divides the batch
        # budget across the senders currently active, floored at 1 —
        # one 10x talker gets the same per-rotation slice as everyone
        # else, so quiet peers' deliveries interleave within ~one
        # rotation instead of waiting out full DRAIN_BATCH turns
        # (pinned by tests/test_fleet.py).
        with self._lock:
            active = len(self._active) or 1
        quantum = max(1, self.DRAIN_BATCH // active)
        for _ in range(quantum):
            with self._lock:
                q = self._queues.get(key)
                if not q:
                    self._active.discard(key)
                    self._queues.pop(key, None)
                    return
                fn, args = q.popleft()
                if self._waiters:
                    self._lock.notify_all()
            try:
                with Timer(histogram=self._latency_hist):
                    fn(*args)
            except Exception as exc:  # noqa: BLE001 — isolate the stream
                self.dropped_errors += 1
                if self._on_error is not None:
                    try:
                        self._on_error(exc)
                    # noise-ec: allow(event-on-swallow) — recorder tap must not kill the drain loop; nothing actionable
                    except Exception:  # noqa: BLE001 — recorder must not kill drain
                        pass
                else:
                    log.warning("dispatch handler error on %r: %r", key, exc)
        # Batch exhausted with work remaining: requeue behind other senders.
        self._pool.submit(self._drain, key)

    def queue_depth(self) -> int:
        """Entries enqueued across all senders (the export gauge)."""
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


@dataclass
class _Peer:
    pid: PeerID
    writer: asyncio.StreamWriter
    is_dialer: bool = False  # we initiated the registered connection
    # The address WE dialed to reach this peer (None on accepted
    # connections). Distinct from pid.address — the peer's self-claimed
    # address — and the one the supervisor must re-dial on loss: with a
    # chaos proxy (or NAT) in between, the dialable address and the
    # claimed address differ.
    dial_address: Optional[str] = None


class _Conn:
    """Per-connection handshake state.

    A peer is registered only after a fresh-nonce proof: every frame is
    signed (over opcode ‖ address ‖ payload), and registration requires the
    counterparty to echo OUR nonce for THIS connection inside one of those
    signed frames — so a captured HELLO/REPLY/ACK replayed on a new
    connection verifies as a signature but never matches the new nonce and
    never binds the victim's identity to the attacker's socket."""

    def __init__(self, is_dialer: bool = False,
                 dial_address: Optional[str] = None):
        self.nonce = os.urandom(_NONCE_LEN)
        self.peer: Optional[PeerID] = None
        self.registered = asyncio.Event()
        self.is_dialer = is_dialer  # we initiated this connection
        self.dial_address = dial_address  # the address we dialed (dialer side)


class TCPNetwork:
    """Asyncio TCP transport with the noise-style lifecycle:
    ``listen()`` (background accept loop), ``bootstrap(peers)`` (dial out),
    ``broadcast(msg)`` (signed fan-out to all connected peers).

    Runs its event loop on a daemon thread so callers keep the reference's
    synchronous REPL shape (``go net.Listen()``, main.go:169).

    Security model (vs the reference's noise transport, SURVEY.md §2.3 D2):
    every frame is Ed25519-signed over (opcode ‖ sender address ‖ payload),
    and peers register through a three-way nonce handshake
    (HELLO → HELLO_REPLY → HELLO_ACK) so neither the address nor a replayed
    handshake can bind a foreign identity to an attacker's socket. Shards
    are accepted only from registered connections whose key matches.
    """

    # Disconnect a peer whose kernel+asyncio write buffer exceeds this —
    # a stalled reader must not grow sender memory without bound.
    MAX_PEER_WRITE_BUFFER = 32 << 20

    def __init__(
        self,
        host: str = "localhost",
        port: int = 3000,
        keys: Optional[KeyPair] = None,
        protocol: str = "tcp",
        *,
        connection_timeout: float = 60.0,
        recv_window: int = 4096,
        send_window: int = 4096,
        write_buffer_size: int = 4096,
        write_flush_latency: float = 0.050,
        write_timeout: float = 3.0,
        discovery: bool = True,
        max_discovered_peers: int = 64,
        discovery_interval: float = 2.0,
        reconnect: bool = True,
        recv_shards: int = 1,
    ):
        """Tuning knobs default to the reference's builder options
        (main.go:27-33): connection timeout 60s, recv/send
        window 4096 messages, write buffer 4096 bytes, write-flush latency
        50ms, write timeout 3s. Semantics here:

        - ``connection_timeout`` bounds dial + nonce handshake;
        - ``recv_window`` caps each sender's ordered dispatch queue;
        - ``send_window`` caps coalesced-but-unflushed frames per peer
          (overflow forces an immediate flush);
        - ``write_buffer_size`` is the coalesce buffer: a pending batch at
          or above this many bytes flushes without waiting for the timer;
        - ``write_flush_latency`` is the coalescing timer for small writes;
        - ``write_timeout`` bounds the post-flush drain; a peer that cannot
          accept bytes for this long is disconnected.

        ``discovery`` enables the peer-exchange gossip the reference gets
        from noise's discovery plugin (main.go:151): on every registration
        the node sends the newcomer its known peer addresses and announces
        the newcomer to existing peers; learned addresses are dialed
        (deduped, capped at ``max_discovered_peers``). Every
        ``discovery_interval`` seconds the full peer list is re-gossiped to
        every registered peer — registration-time gossip alone cannot heal
        a lost introduction (a failed discovered dial, or simultaneous
        mutual dials where each side keeps a different connection and
        closes the other's survivor, leaves a pair partitioned with no new
        registration event to retry on).

        ``reconnect`` enables the self-healing peer lifecycle
        (resilience/peers.py): loss of an ESTABLISHED connection we
        dialed triggers supervised re-dial with exponential backoff +
        full jitter, gated by a per-peer circuit breaker fed by dial
        failures and write-timeout disconnects.

        ``recv_shards`` > 1 opens that many SO_REUSEPORT acceptor shards
        on the listen port — one extra event-loop thread per shard, the
        kernel balancing inbound connections across them — all feeding
        the ONE shared dispatcher, so a single Python loop thread stops
        being the receive ceiling while per-sender ordering and DRR
        fairness are untouched (docs/design.md §15). TCP only; clamped
        to 1 where SO_REUSEPORT is unavailable.
        """
        if protocol not in ("tcp", "kcp"):
            raise ValueError(
                f"protocol {protocol!r} not supported (tcp or kcp, the "
                "reference's option set — main.go:123)"
            )
        self.protocol = protocol
        self.keys = keys or KeyPair.random()
        self.host = host
        self.port = port
        self.id = PeerID.create(format_address(protocol, host, port), self.keys.public_key)
        self.plugins: list = []
        self.connection_timeout = connection_timeout
        self.recv_window = recv_window
        self.send_window = send_window
        self.write_buffer_size = write_buffer_size
        self.write_flush_latency = write_flush_latency
        self.write_timeout = write_timeout
        self.discovery = discovery
        self.max_discovered_peers = max_discovered_peers
        self.discovery_interval = discovery_interval
        # Keyed by PUBLIC KEY, not the self-claimed address: an address is
        # just a claim inside a signed frame, so keying by it would let any
        # handshake-completing attacker evict a legitimate peer by claiming
        # the same address. One entry per identity; addresses may collide.
        self.peers: dict[bytes, _Peer] = {}  # public key -> peer
        # bounded: hostile traffic appends one entry per bad frame
        self.errors: deque[Exception] = deque(maxlen=256)
        self.error_count = 0
        self._sig = Ed25519Policy()
        self._hash = Blake2bPolicy()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._server: Optional[asyncio.AbstractServer] = None
        self._lock = threading.Lock()
        self._tasks: set[asyncio.Task] = set()
        # Plugin dispatch (FEC decode; a first-geometry plan on the device
        # backend) must not run on the event-loop
        # thread, or every connection's read loop and handshake stalls
        # behind it. Per-sender ordered queues on a shared pool: order is
        # preserved within a sender, and one sender's slow decode cannot
        # stall delivery from other peers.
        self._dispatch = _SerialDispatcher(
            max_workers=4, max_queue=recv_window,
            on_error=self._record_error,
        )
        # Deferred frame verification (docs/design.md §15): the loop
        # thread parses and digests; cohorts drain through verify_batch
        # on the dispatch pool, keyed (and ordered) per sender.
        self._verify_q: dict[bytes, deque] = {}
        self._verify_scheduled: set[bytes] = set()
        self._verify_lock = threading.Lock()
        # SO_REUSEPORT acceptor shards (extra loops started by listen()).
        if recv_shards > 1 and (
            protocol != "tcp" or not hasattr(_socket, "SO_REUSEPORT")
        ):
            recv_shards = 1
        self.recv_shards = max(1, int(recv_shards))
        self._shard_loops: list[tuple[asyncio.AbstractEventLoop,
                                      threading.Thread]] = []
        self._shard_servers: list[asyncio.AbstractServer] = []
        # Write coalescing state. Each writer's entries are only touched
        # on that writer's OWNING loop thread (per-connection with
        # recv_shards > 1); distinct keys make the dicts safe to share.
        self._pending: dict[asyncio.StreamWriter, list[bytes]] = {}
        self._pending_frames: dict[asyncio.StreamWriter, int] = {}
        self._pending_bytes: dict[asyncio.StreamWriter, int] = {}
        # Bytes posted cross-thread (broadcast -> call_soon queue) but not
        # yet seen by _enqueue_frame; guarded by self._lock. Part of the
        # wait_writable backpressure measurement.
        self._posted_bytes: dict[asyncio.StreamWriter, int] = {}
        self._flush_handles: dict[asyncio.StreamWriter, asyncio.TimerHandle] = {}
        self._draining: set[asyncio.StreamWriter] = set()
        # Frames addressed to a connection that died mid-swap (mutual-dial
        # tie-break demotion, or the remote's demotion FIN) are re-routed
        # to the peer's surviving connection — or parked here, keyed by
        # peer public key, until its registration lands. Guarded by
        # self._lock; entries are (parked-at monotonic, bytes, batches)
        # and expire after connection_timeout (checked lazily on insert
        # and flush — no timer), so a peer that never comes back costs at
        # most MAX_PEER_WRITE_BUFFER bytes until close().
        self._limbo: dict[bytes, tuple[float, int, list]] = {}
        # Discovery state: addresses we are responsible for dialing (dedup +
        # budget). Entries are removed on dial failure and on disconnect of
        # the dialed peer, so churned peers can be re-learned from gossip.
        self._dialing: set[str] = set()
        # Failed-dial cooldown: addr -> (next-allowed monotonic time, delay).
        # Without it, periodic re-gossip would re-dial an unreachable
        # claimed address every interval forever, flooding self.errors.
        self._dial_backoff: dict[str, tuple[float, float]] = {}
        self._gossip_task: Optional[asyncio.Task] = None
        # Handshake timing: dialed address -> seconds between sending
        # HELLO and the peer registering (≈ one network round trip plus
        # two Ed25519 verifies). The distributed-trace collector uses it
        # to tighten per-peer clock-offset uncertainty (obs/collector.py)
        # — the TCP-level handshake is a truer delay floor than an HTTP
        # poll of /spans.
        self._handshake_rtt: dict[str, float] = {}
        # Set at the top of close(): the supervisor must not re-dial peers
        # whose connections we are tearing down ourselves.
        self._closing = False
        self.supervisor = None
        if reconnect:
            from noise_ec_tpu_torch.resilience.peers import PeerSupervisor

            self.supervisor = PeerSupervisor(self)

    # ------------------------------------------------------------ lifecycle

    def listen(self) -> None:
        """Start the accept loop in the background (go net.Listen())."""
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start_server(), self._loop)
        self._server = fut.result(timeout=10)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        self.id = PeerID.create(
            format_address(self.protocol, self.host, self.port),
            self.keys.public_key,
        )
        # SO_REUSEPORT acceptor shards: the main server bound the
        # (possibly ephemeral) port with the flag set, so shard sockets
        # can join it and the kernel hashes inbound connections across
        # the whole group. Each shard is one extra daemon loop thread
        # accepting + parsing + digesting; everything downstream (verify
        # drains, plugin dispatch) already runs on the shared pool.
        wire_metrics().set_recv_shards(self.recv_shards)
        for i in range(1, self.recv_shards):
            loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=loop.run_forever, daemon=True,
                name=f"noise-ec-recv-{i}",
            )
            t.start()
            self._shard_loops.append((loop, t))
            fut = asyncio.run_coroutine_threadsafe(
                self._start_shard_server(), loop
            )
            self._shard_servers.append(fut.result(timeout=10))
        if self.discovery and self.discovery_interval > 0:
            def _start_gossip():
                self._gossip_task = self._loop.create_task(self._gossip_loop())
            self._loop.call_soon_threadsafe(_start_gossip)

    async def _start_shard_server(self):
        loop = asyncio.get_running_loop()
        return await loop.create_server(
            lambda: _WireConn(self, _Conn()), self.host, self.port,
            reuse_port=True,
        )

    def _writer_loop(self, writer) -> asyncio.AbstractEventLoop:
        """The event loop that owns ``writer``'s transport (shard conns
        live on their acceptor shard's loop; everything else on the
        main loop)."""
        return getattr(writer, "_wire_loop", None) or self._loop

    async def _gossip_loop(self) -> None:
        """Periodic full-peer-list re-gossip (see ``discovery_interval``).

        One shared frame per tick: receivers already skip their own
        address (and known peers), so per-recipient exclusion would only
        multiply the Ed25519 signing work by the peer count.
        """
        while True:
            await asyncio.sleep(self.discovery_interval)
            try:
                with self._lock:
                    peers = list(self.peers.values())
                if len(peers) < 2:
                    continue
                frame = self._frame(
                    _OP_PEERS, _encode_peer_list([p.pid.address for p in peers])
                )
                for p in peers:
                    self._write_safe(p.writer, frame)
            except Exception as exc:  # noqa: BLE001 — a bad tick must not
                # kill the loop: losing it silently re-creates the very
                # unhealable-partition state this mechanism exists to fix.
                self._record_error(exc)

    async def _start_server(self):
        if self.protocol == "kcp":
            from noise_ec_tpu_torch.host.kcp import start_kcp_server

            return await start_kcp_server(self._handle_conn, self.host, self.port)
        # TCP accepts ride the BufferedProtocol recv_into path, not
        # StreamReader (docs/design.md §15).
        return await self._loop.create_server(
            lambda: _WireConn(self, _Conn()), self.host, self.port,
            reuse_port=True if self.recv_shards > 1 else None,
        )

    def bootstrap(self, peer_addresses: list[str]) -> None:
        """Dial out to peers (net.Bootstrap, main.go:171-173). Blocks until
        each handshake completes (or fails), so a broadcast immediately
        after bootstrap reaches every successfully dialed peer."""
        for addr in peer_addresses:
            if not addr:
                continue
            fut = asyncio.run_coroutine_threadsafe(self._dial(addr), self._loop)
            try:
                fut.result(timeout=self.connection_timeout + 5)
            except Exception as exc:  # noqa: BLE001
                self._record_error(exc)
                log.error("bootstrap %s failed: %s", addr, exc)

    def close(self) -> None:
        self._closing = True
        if self.supervisor is not None:
            self.supervisor.close()
        with self._lock:
            self._limbo.clear()

        async def _shutdown():
            if self._server is not None:
                self._server.close()
            if self._gossip_task is not None:
                self._gossip_task.cancel()
                self._gossip_task = None
            for w in list(self._pending):
                # Best-effort final flush, on each writer's owning loop
                # (flush touches per-writer coalesce state, which is
                # loop-affine under recv_shards > 1).
                loop = self._writer_loop(w)
                if loop is self._loop:
                    self._flush_writer(w)
                else:
                    loop.call_soon_threadsafe(self._flush_writer, w)
            for peer in list(self.peers.values()):
                peer.writer.close()  # _WireConn.close is thread-safe

        if self._thread.is_alive():
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop).result(timeout=5)
            for (loop, _), server in zip(self._shard_loops,
                                         self._shard_servers):
                loop.call_soon_threadsafe(server.close)
            for loop, thread in self._shard_loops:
                loop.call_soon_threadsafe(loop.stop)
                thread.join(timeout=5)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
        self._dispatch.shutdown(wait=True)

    # ------------------------------------------------------------- plugins

    def add_plugin(self, plugin) -> None:
        self.plugins.append(plugin)
        # Plugins that can talk back on the receive path (the NACK shard
        # repair in host/plugin.py) get a transport handle.
        attach = getattr(plugin, "attach_network", None)
        if attach is not None:
            attach(self)

    def _record_error(self, exc: Exception) -> None:
        self.errors.append(exc)
        self.error_count += 1

    def handshake_rtts(self) -> dict[str, float]:
        """HELLO round-trip seconds per dialed peer address (the
        clock-sync hint consumed by ``obs.collector.TraceCollector``)."""
        return dict(self._handshake_rtt)

    # --------------------------------------------------------------- wire

    def _frame_parts(self, opcode: int, payload_parts) -> tuple[list, int]:
        """One signed frame as scatter-gather buffer parts.

        ``b"".join(parts)`` is byte-identical to ``_frame(opcode,
        join(payload_parts))`` (Ed25519 is deterministic and the
        signing hash streams the parts), but the payload buffers —
        shard_data above all — are never copied into a joined frame:
        they travel as iovecs down to the ``sendmsg`` flush. Returns
        (parts, total frame bytes)."""
        addr = self.id.address.encode()
        plen = sum(len(p) for p in payload_parts)
        pre_head = (
            bytes([opcode]) + struct.pack("<I", len(addr)) + addr
        )
        plen_b = struct.pack("<I", plen)
        sig = self.keys.sign_parts(
            self._sig, self._hash, (pre_head, plen_b, *payload_parts)
        )
        body_len = len(pre_head) + 32 + 4 + plen + 64
        head = (
            struct.pack("<I", body_len)
            + pre_head
            + self.keys.public_key
            + plen_b
        )
        parts = [head]
        parts.extend(p for p in payload_parts if len(p))
        parts.append(sig)
        return parts, 4 + body_len

    def _frame(self, opcode: int, payload: bytes) -> bytes:
        parts, _ = self._frame_parts(opcode, (payload,))
        return b"".join(parts)

    @staticmethod
    def _parse_frame_fields(body) -> tuple[int, bytes, bytes, object, bytes]:
        """Parse a frame body (bytes or an in-place ring memoryview) to
        (opcode, addr utf-8 bytes, pubkey, payload, signature). The
        payload keeps the caller's buffer type — a view stays a view —
        so the shard path can digest + unmarshal without a whole-frame
        copy; everything else is materialized (it is tiny)."""
        pos = 0
        if len(body) < 5:
            raise WireError("truncated frame")
        opcode = body[pos]; pos += 1
        (alen,) = struct.unpack_from("<I", body, pos); pos += 4
        addr = bytes(body[pos : pos + alen]); pos += alen
        pubkey = bytes(body[pos : pos + 32]); pos += 32
        if pos + 4 > len(body):
            raise WireError("truncated frame")
        (plen,) = struct.unpack_from("<I", body, pos); pos += 4
        payload = body[pos : pos + plen]; pos += plen
        sig = bytes(body[pos : pos + 64])
        if len(addr) != alen or len(pubkey) != 32 or len(payload) != plen \
                or len(sig) != 64:
            raise WireError("truncated frame")
        if pos + 64 != len(body):
            # No unauthenticated trailing bytes: the signature must be the
            # last 64 bytes of the body, exactly.
            raise WireError("trailing bytes after frame signature")
        return opcode, addr, pubkey, payload, sig

    @staticmethod
    def _parse_frame(body: bytes) -> tuple[int, PeerID, bytes, bytes]:
        """Returns (opcode, sender_pid, payload, signature)."""
        opcode, addr, pubkey, payload, sig = TCPNetwork._parse_frame_fields(
            body
        )
        return opcode, PeerID.create(addr.decode(), pubkey), bytes(payload), sig

    # ------------------------------------------------------------ dataflow

    def broadcast(self, msg: Shard) -> None:
        """Signed fan-out to every connected peer (main.go:206-208).

        Frames ride the per-peer coalescing buffer: consecutive broadcasts
        within ``write_flush_latency`` batch into one socket write (noise's
        WriteFlushLatency semantics)."""
        with span("wire_encode", key=trace_key(msg.file_signature)):
            parts, nbytes = self._frame_parts(
                _OP_SHARD, msg.marshal_parts()
            )
        self._post_frame(parts, nbytes, shards=1)

    def broadcast_many(self, msgs) -> None:
        """Broadcast a cohort of shards — one encode call's output, a
        stream chunk's shares — as SHARD_BATCH frames: the whole cohort
        costs ONE Ed25519 sign here and one (batched) verify per
        receiver, and its buffers ride one sendmsg flush per peer
        (docs/design.md §15). Order within the cohort is preserved;
        semantics per shard are exactly ``broadcast``'s."""
        msgs = list(msgs)
        if not msgs:
            return
        if len(msgs) == 1:
            self.broadcast(msgs[0])
            return
        # Captured HERE, inside the caller's request scope (thread-local),
        # so network implementations keep their signatures: the cohort
        # frame carries the request trace id and every receiver's
        # pipeline spans can merge into the originating request's trace.
        rt = current_trace_id()
        # Split oversized cohorts so one frame never exceeds the batch
        # cap (the receive ring handles them either way, but a multi-
        # tens-of-MiB frame is a head-of-line blob for the peer).
        start = 0
        while start < len(msgs):
            group = []
            group_bytes = 0
            while start < len(msgs) and (
                not group or group_bytes + msgs[start].size() <= _MAX_BATCH_FRAME
            ):
                group_bytes += msgs[start].size() + 4
                group.append(msgs[start])
                start += 1
            if len(group) == 1:
                self.broadcast(group[0])
                continue
            with span("wire_encode", key=trace_key(group[0].file_signature),
                      **({"request_trace": rt} if rt else {})):
                parts, nbytes = self._frame_parts(
                    _OP_SHARD_BATCH,
                    _encode_shard_batch_parts(group, trace=rt),
                )
            wire_metrics().batch_out(len(group))
            self._post_frame(parts, nbytes, shards=len(group))

    def _post_frame(self, parts: list, nbytes: int, shards: int) -> None:
        """Hand one built frame (scatter-gather parts) to every peer's
        owning loop for coalescing + flush."""
        metrics = transport_metrics()
        with self._lock:
            writers = [p.writer for p in self.peers.values()]
            for p in self.peers.values():
                metrics.record_out(p.pid.address, nbytes, count=shards)
            # Count the bytes as posted BEFORE handing them to the loop
            # thread: a frame sitting in call_soon_threadsafe's queue is
            # visible to neither the kernel buffer nor the coalesce
            # batch, so without this the backpressure waiter reads
            # "empty" while a starved loop thread holds an unbounded
            # backlog (observed: cap disconnects despite per-share
            # waiting on a loaded single-core host).
            for w in writers:
                self._posted_bytes[w] = (
                    self._posted_bytes.get(w, 0) + nbytes
                )
        for w in writers:
            self._writer_loop(w).call_soon_threadsafe(
                self._enqueue_frames, w, parts, 1, nbytes
            )

    def send_to(self, public_key: bytes, msg: Shard) -> bool:
        """Send one signed shard frame to a single registered peer
        (directed NACK repair — host/plugin.py; broadcast semantics are
        otherwise unchanged). Returns False when no registered peer holds
        ``public_key``."""
        with self._lock:
            peer = self.peers.get(bytes(public_key))
            if peer is None:
                return False
            writer = peer.writer
            address = peer.pid.address
        parts, nbytes = self._frame_parts(_OP_SHARD, msg.marshal_parts())
        transport_metrics().record_out(address, nbytes)
        with self._lock:
            self._posted_bytes[writer] = (
                self._posted_bytes.get(writer, 0) + nbytes
            )
        self._writer_loop(writer).call_soon_threadsafe(
            self._enqueue_frames, writer, parts, 1, nbytes
        )
        return True

    def send_many_to(self, public_key: bytes, msgs) -> bool:
        """Send a shard cohort to ONE registered peer as SHARD_BATCH
        frames — the placement layer's targeted-delivery surface
        (docs/placement.md): same cohort splitting, signing and batch
        accounting as ``broadcast_many``, but one destination instead
        of the whole peer table. Returns False when no registered peer
        holds ``public_key``."""
        msgs = list(msgs)
        if not msgs:
            return True
        with self._lock:
            peer = self.peers.get(bytes(public_key))
            if peer is None:
                return False
            writer = peer.writer
            address = peer.pid.address
        metrics = transport_metrics()
        # Thread-local request-scope read — same contract as
        # broadcast_many: the cohort frame carries the trace id so the
        # owner's receive-side spans merge into the PUT's trace.
        rt = current_trace_id()
        start = 0
        while start < len(msgs):
            group = []
            group_bytes = 0
            while start < len(msgs) and (
                not group
                or group_bytes + msgs[start].size() <= _MAX_BATCH_FRAME
            ):
                group_bytes += msgs[start].size() + 4
                group.append(msgs[start])
                start += 1
            with span(
                "wire_encode", key=trace_key(group[0].file_signature),
                **({"request_trace": rt} if rt else {}),
            ):
                if len(group) == 1:
                    parts, nbytes = self._frame_parts(
                        _OP_SHARD, group[0].marshal_parts()
                    )
                else:
                    parts, nbytes = self._frame_parts(
                        _OP_SHARD_BATCH,
                        _encode_shard_batch_parts(group, trace=rt),
                    )
            if len(group) > 1:
                wire_metrics().batch_out(len(group))
            metrics.record_out(address, nbytes, count=len(group))
            with self._lock:
                self._posted_bytes[writer] = (
                    self._posted_bytes.get(writer, 0) + nbytes
                )
            self._writer_loop(writer).call_soon_threadsafe(
                self._enqueue_frames, writer, parts, 1, nbytes
            )
        return True

    def placement_directory(self) -> dict:
        """``{address token: public key}`` for every registered peer —
        how the placement ring's topology tokens (peer addresses) map to
        ``send_many_to`` handles. Snapshot semantics: membership may
        change after return, and a send to a departed peer just returns
        False."""
        with self._lock:
            return {p.pid.address: pk for pk, p in self.peers.items()}

    def wait_writable(
        self,
        soft_cap: Optional[int] = None,
        timeout: float = 30.0,
        headroom: int = 0,
    ) -> None:
        """Producer-side backpressure for bulk streams: block the calling
        (non-loop) thread until every peer's outgoing buffer (kernel +
        asyncio + the coalesce batch + cross-thread posted frames) is
        below ``soft_cap`` (default: the hard cap minus the caller's
        ``headroom``, floored at 1/8 of the cap).

        Without this, a sender producing faster than its peers drain —
        e.g. streaming a multi-hundred-MiB object to a receiver that is
        busy decoding — walks the write buffer into the
        MAX_PEER_WRITE_BUFFER hard cap and DISCONNECTS its own peer
        mid-stream (found by a 256 MiB real-TCP soak): the hard cap is an
        anti-DoS bound against unresponsive READERS, not a send-rate
        governor. The stream emitter calls this between chunks. Reads
        are cross-thread snapshots (plain int reads under the GIL);
        staleness costs at most one extra 5 ms poll. On timeout the
        caller proceeds — a genuinely stalled peer is then the hard
        cap's and write_timeout's job to drop.
        """
        ident = threading.get_ident()
        if ident == self._thread.ident or any(
            ident == t.ident for _, t in self._shard_loops
        ):
            # Called on an event-loop thread: the drain this would wait
            # for runs ON this thread, so blocking here deadlocks until
            # the timeout with zero progress. No current caller does this
            # (the stream emitter runs on the producer's thread); the
            # guard keeps a future loop-side caller from wedging the
            # whole transport. No-op — the hard cap still protects memory.
            return
        if soft_cap is None:
            # Derive from the hard cap MINUS what the caller is about to
            # enqueue (``headroom``): waiting to "half full" is not
            # enough when the next burst alone exceeds the other half.
            # The floor keeps progress even for outsized bursts — a
            # single frame larger than the hard cap cannot be saved by
            # any waiting policy.
            soft_cap = max(
                self.MAX_PEER_WRITE_BUFFER - headroom,
                self.MAX_PEER_WRITE_BUFFER // 8,
            )
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with self._lock:
                    writers = [p.writer for p in self.peers.values()]
                    posted = [self._posted_bytes.get(w, 0) for w in writers]
                busy = any(
                    w.transport.get_write_buffer_size()
                    + self._pending_bytes.get(w, 0) + posted_w > soft_cap
                    for w, posted_w in zip(writers, posted)
                )
            # noise-ec: allow(event-on-swallow) — peer set mutating mid-scan — retried on the next sweep tick
            except Exception:  # noqa: BLE001 — peer set mutating mid-scan
                busy = True
            if not busy:
                return
            time.sleep(0.005)

    # -- write path (event-loop thread only) --

    # noise-ec: loop-affine
    @staticmethod
    def _writer_pubkey(writer) -> Optional[bytes]:
        """The registered peer public key a connection's frames are
        addressed to, or None for handshake-stage connections and
        writer fakes without a ``conn``."""
        conn = getattr(writer, "conn", None)
        peer = getattr(conn, "peer", None)
        return getattr(peer, "public_key", None)

    def _reroute_frames(
        self, pubkey: bytes, parts: list, nframes: int, nbytes: int,
        exclude=None,
    ) -> None:
        """Re-address coalesced frames whose connection is dying to the
        peer's CURRENT connection. Simultaneous mutual dials resolve by
        closing one of the two connections (the ``_register`` tie-break),
        and a broadcast can race that swap: its frames are posted to the
        connection that loses — on either side — and a hard teardown
        would drop them on the floor (observed: the three-process
        discovery e2e losing a one-shot broadcast sent the instant the
        gossip-built edge re-registered). If the survivor is not
        registered YET (the eviction→re-registration gap), the frames
        park in ``_limbo`` and flush when its registration lands."""
        target = None
        parked = expired = False
        with self._lock:
            if self._closing:
                return
            peer = self.peers.get(pubkey)
            if (
                peer is not None
                and peer.writer is not exclude
                and not getattr(peer.writer, "is_closing", lambda: False)()
            ):
                target = peer.writer
                self._posted_bytes[target] = (
                    self._posted_bytes.get(target, 0) + nbytes
                )
            else:
                now = time.monotonic()
                parked_at, parked_bytes, batches = self._limbo.get(
                    pubkey, (now, 0, [])
                )
                if now - parked_at > self.connection_timeout:
                    expired = bool(batches)
                    parked_at, parked_bytes, batches = now, 0, []
                if parked_bytes + nbytes <= self.MAX_PEER_WRITE_BUFFER:
                    batches.append((parts, nframes, nbytes))
                    self._limbo[pubkey] = (
                        parked_at, parked_bytes + nbytes, batches
                    )
                    parked = True
        if expired:
            event("conn.limbo_drop", "warn", peer=pubkey[:8].hex(),
                  reason="park expired before a connection registered")
        if parked:
            event("conn.limbo_park", peer=pubkey[:8].hex(),
                  frames=nframes, bytes=nbytes)
        if target is not None:
            event("conn.limbo_reroute", peer=pubkey[:8].hex(),
                  frames=nframes, bytes=nbytes)
            self._writer_loop(target).call_soon_threadsafe(
                self._enqueue_frames, target, parts, nframes, nbytes
            )

    def _flush_limbo(self, pubkey: bytes, writer) -> None:
        """Hand any parked frames for ``pubkey`` to its freshly
        registered connection (expired parks are dropped)."""
        with self._lock:
            parked = self._limbo.pop(pubkey, None)
            if parked is None:
                return
            parked_at, parked_bytes, batches = parked
            if time.monotonic() - parked_at > self.connection_timeout:
                expired = True
            else:
                expired = False
                self._posted_bytes[writer] = (
                    self._posted_bytes.get(writer, 0) + parked_bytes
                )
        if expired:
            event("conn.limbo_drop", "warn", peer=pubkey[:8].hex(),
                  bytes=parked_bytes,
                  reason="park expired before registration")
            return
        event("conn.limbo_reroute", peer=pubkey[:8].hex(),
              bytes=parked_bytes, batches=len(batches))
        loop = self._writer_loop(writer)
        for parts, nframes, nbytes in batches:
            loop.call_soon_threadsafe(
                self._enqueue_frames, writer, parts, nframes, nbytes
            )

    def _enqueue_frames(
        self, writer: asyncio.StreamWriter, parts: list, nframes: int,
        nbytes: int,
    ) -> None:
        """Coalesce one frame's scatter-gather ``parts`` into the peer's
        pending buffer list; flush when the batch reaches
        ``write_buffer_size`` bytes or ``send_window`` frames, otherwise
        after ``write_flush_latency``. Runs on the writer's owning
        loop."""
        if getattr(writer, "is_closing", lambda: False)():
            # The connection died between the broadcast's peer-table
            # snapshot and this loop callback (mutual-dial swap, remote
            # FIN): writing would vanish into a closed transport.
            with self._lock:
                left = self._posted_bytes.get(writer, 0) - nbytes
                if left > 0:
                    self._posted_bytes[writer] = left
                else:
                    self._posted_bytes.pop(writer, None)
            pubkey = self._writer_pubkey(writer)
            if pubkey is not None:
                self._reroute_frames(
                    pubkey, parts, nframes, nbytes, exclude=writer
                )
            return
        if writer.transport.get_write_buffer_size() > self.MAX_PEER_WRITE_BUFFER:
            self._drop_writer(writer)  # also clears _posted_bytes
            self._record_error(
                RuntimeError("peer write buffer exceeded cap; disconnected")
            )
            return
        pend = self._pending.setdefault(writer, [])
        pend.extend(parts)
        frames = self._pending_frames.get(writer, 0) + nframes
        self._pending_frames[writer] = frames
        total = self._pending_bytes.get(writer, 0) + nbytes
        self._pending_bytes[writer] = total
        with self._lock:
            # Decrement the cross-thread posted counter only AFTER the
            # bytes are visible in the coalesce batch: the backpressure
            # waiter must always see in-flight bytes counted SOMEWHERE
            # (posted -> pending -> transport buffer, in that order).
            left = self._posted_bytes.get(writer, 0) - nbytes
            if left > 0:
                self._posted_bytes[writer] = left
            else:
                self._posted_bytes.pop(writer, None)
        if total >= self.write_buffer_size or frames >= self.send_window:
            self._flush_writer(writer)
        elif writer not in self._flush_handles:
            self._flush_handles[writer] = self._writer_loop(
                writer
            ).call_later(self.write_flush_latency, self._flush_writer, writer)

    # sendmsg iovec budget per syscall: Linux UIO_MAXIOV is 1024; stay
    # under it and let oversized batches fall back to the joined write.
    _SENDMSG_MAX_BUFS = 512

    # noise-ec: loop-affine
    def _flush_writer(self, writer: asyncio.StreamWriter) -> None:
        handle = self._flush_handles.pop(writer, None)
        if handle is not None:
            handle.cancel()
        pend = self._pending.pop(writer, None)
        nframes = self._pending_frames.pop(writer, 0)
        if not pend:
            self._pending_bytes.pop(writer, None)
            return
        if getattr(writer, "is_closing", lambda: False)():
            # The connection died while this batch coalesced; re-address
            # it instead of writing into a closed transport.
            nbytes = self._pending_bytes.pop(writer, 0)
            pubkey = self._writer_pubkey(writer)
            if pubkey is not None:
                self._reroute_frames(
                    pubkey, pend, nframes, nbytes, exclude=writer
                )
            return
        try:
            # _pending_bytes is cleared only after the batch lands in the
            # socket or the transport buffer, so the backpressure waiter
            # never sees the bytes vanish from both counters at once.
            self._write_vectored(writer, pend, nframes)
        except Exception as exc:  # noqa: BLE001
            self._record_error(exc)
            return
        finally:
            self._pending_bytes.pop(writer, None)
        # Enforce write_timeout: a peer that cannot drain for that long is
        # disconnected. One drain task per writer at a time (asyncio allows
        # a single drain waiter).
        if writer not in self._draining:
            self._draining.add(writer)
            loop = self._writer_loop(writer)
            task = loop.create_task(self._drain_writer(writer))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    # noise-ec: loop-affine
    def _write_vectored(self, writer, bufs: list, nframes: int) -> None:
        """Flush a coalesced buffer list: ONE ``sendmsg`` iovec syscall
        when the transport buffer is empty (the steady state — the
        kernel buffer drains between flushes), the ordered transport
        buffer otherwise. Frames-per-syscall and syscalls-saved feed
        the ``noise_ec_wire_*`` families either way (a joined
        transport write is still one syscall's worth of coalescing)."""
        sock = getattr(writer, "vectored_socket", None)
        if sock is not None and len(bufs) > 1 and len(bufs) <= self._SENDMSG_MAX_BUFS:
            total = sum(len(b) for b in bufs)
            try:
                sent = sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                sent = 0
            except OSError as exc:
                self._record_error(exc)
                self._drop_writer(writer)
                return
            if sent < total:
                # Kernel buffer filled mid-iovec: hand the tail to the
                # transport buffer (which backpressures + drains).
                rest = []
                for b in bufs:
                    if sent >= len(b):
                        sent -= len(b)
                        continue
                    rest.append(b[sent:] if sent else b)
                    sent = 0
                writer.transport.writelines(rest)
            wire_metrics().flush(nframes, syscalls=1)
            return
        writer.write(b"".join(bufs))
        wire_metrics().flush(nframes, syscalls=1)

    async def _drain_writer(self, writer: asyncio.StreamWriter) -> None:
        try:
            await asyncio.wait_for(writer.drain(), timeout=self.write_timeout)
        except (asyncio.TimeoutError, TimeoutError):
            self._record_error(
                RuntimeError(f"write timeout ({self.write_timeout}s); disconnected")
            )
            # "write_timeout" feeds the peer's circuit breaker: a reader
            # that cannot drain is peer-health evidence, not just a
            # buffer-management event.
            self._drop_writer(writer, reason="write_timeout")
        except Exception as exc:  # noqa: BLE001
            self._record_error(exc)
            self._drop_writer(writer)
        finally:
            self._draining.discard(writer)

    def _write_safe(self, writer: asyncio.StreamWriter, frame: bytes) -> None:
        """Immediate (uncoalesced) write — handshake/control frames.

        Cross-loop callers (gossip / register announcing to a peer whose
        connection lives on another acceptor shard) are routed to the
        writer's owning loop; writers without one (the KCP facade, unit-
        test fakes) write inline, exactly as before."""
        loop = getattr(writer, "_wire_loop", None)
        if loop is not None:
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not loop:
                loop.call_soon_threadsafe(self._write_safe_here, writer, frame)
                return
        self._write_safe_here(writer, frame)

    # noise-ec: loop-affine
    def _write_safe_here(self, writer, frame: bytes) -> None:
        if writer.transport.get_write_buffer_size() > self.MAX_PEER_WRITE_BUFFER:
            # A stalled reader must not grow sender memory without bound.
            self._drop_writer(writer)
            self._record_error(
                RuntimeError("peer write buffer exceeded cap; disconnected")
            )
            return
        try:
            writer.write(frame)
        except Exception as exc:  # noqa: BLE001
            self._record_error(exc)

    def _drop_writer(self, writer: asyncio.StreamWriter,
                     reason: str = "") -> None:
        lost_dialed: list[str] = []
        lost_addrs: list[str] = []
        with self._lock:
            for key, p in list(self.peers.items()):
                if p.writer is writer:
                    del self.peers[key]
                    lost_addrs.append(p.pid.address)
                    # Allow gossip to re-establish a churned peer.
                    self._dialing.discard(p.pid.address)
                    if p.dial_address is not None:
                        self._dialing.discard(p.dial_address)
                        lost_dialed.append(p.dial_address)
        for address in lost_addrs:
            # INFO mirror of "registered peer": operators (and the e2e
            # tests) can pair every registration with its teardown
            # instead of inferring loss from silence.
            log.info("dropped peer %s%s", address,
                     f" ({reason})" if reason else "")
            event("peer.drop", "warn", peer=address,
                  reason=reason or "connection closed")
        handle = self._flush_handles.pop(writer, None)
        if handle is not None:
            handle.cancel()
        pend = self._pending.pop(writer, None)
        pend_frames = self._pending_frames.pop(writer, 0)
        pend_bytes = self._pending_bytes.pop(writer, 0)
        with self._lock:
            self._posted_bytes.pop(writer, None)
        if pend:
            # Shard frames already addressed to this peer must survive a
            # connection swap (mutual-dial demotion): hand them to the
            # surviving connection, or park them until it registers.
            # Handshake-stage writers have no peer identity; their
            # control frames drop with the connection, as before.
            pubkey = self._writer_pubkey(writer)
            if pubkey is not None:
                self._reroute_frames(
                    pubkey, pend, pend_frames, pend_bytes, exclude=writer
                )
        try:
            writer.close()
        # noise-ec: allow(event-on-swallow) — close() race on a dying writer; the loss is already accounted above
        except Exception:  # noqa: BLE001
            pass
        # Established-connection loss of a peer WE dialed: hand the dialed
        # address to the supervisor for backoff-gated re-dial. After the
        # peer-table cleanup above, so the supervisor's is-alive check
        # cannot race the stale entry.
        if self.supervisor is not None and not self._closing:
            for address in lost_dialed:
                self.supervisor.on_connection_lost(address, reason)

    async def _dial(self, address: str) -> None:
        # Idempotent: dialing an address we already hold a registered
        # connection to is a no-op (repeat bootstrap calls, gossip
        # re-learning a live peer) — no churn, no duplicate handshake.
        with self._lock:
            if any(p.pid.address == address for p in self.peers.values()):
                return
        self._dialing.add(address)
        host, port = self._split(address)
        conn = _Conn(is_dialer=True, dial_address=address)
        is_kcp = address.startswith("kcp://") or (
            "://" not in address and self.protocol == "kcp"
        )
        try:
            if is_kcp:
                from noise_ec_tpu_torch.host.kcp import open_kcp_connection

                # (The kcp opener returns without any network round trip;
                # the real unreachable-peer bound is conn.registered.wait
                # below.)
                reader, writer = await asyncio.wait_for(
                    open_kcp_connection(host, port),
                    timeout=self.connection_timeout,
                )
            else:
                # TCP dials ride the same BufferedProtocol recv_into
                # path as accepted connections; the protocol IS the
                # writer facade.
                loop = asyncio.get_running_loop()
                _transport, writer = await asyncio.wait_for(
                    loop.create_connection(
                        lambda: _WireConn(self, conn), host, port
                    ),
                    timeout=self.connection_timeout,
                )
                reader = None
        except Exception:
            # Refund the dedup slot: a failed dial (bootstrap races the
            # peer's startup, say) must not block discovery from ever
            # dialing this address again.
            self._dialing.discard(address)
            raise
        try:
            t_hello = time.perf_counter()
            writer.write(self._frame(_OP_HELLO, conn.nonce))
            if reader is not None:
                task = asyncio.create_task(
                    self._read_loop(reader, writer, conn)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
            # Block until the HELLO_REPLY echoes our nonce and the peer is
            # registered; tear the connection down on timeout so a silent
            # acceptor does not leak a socket per bootstrap attempt.
            await asyncio.wait_for(
                conn.registered.wait(), timeout=self.connection_timeout
            )
            self._handshake_rtt[address] = time.perf_counter() - t_hello
        except Exception:
            self._dialing.discard(address)
            self._drop_writer(writer)
            raise

    async def _dial_discovered(self, address: str) -> None:
        """Dial an address learned from peer gossip (best-effort). A failed
        dial refunds its budget and dedup slot so later gossip can retry
        (a crashed-and-restarted peer must not stay partitioned forever),
        but enters exponential backoff so periodic re-gossip does not
        hammer an unreachable claimed address every interval."""
        try:
            await self._dial(address)
        except Exception as exc:  # noqa: BLE001
            self._dialing.discard(address)
            loop_t = self._loop.time()
            delay = min(
                self._dial_backoff.get(address, (0.0, self.discovery_interval))[1] * 2,
                60.0,
            )
            self._dial_backoff[address] = (loop_t + delay, delay)
            self._record_error(exc)
            log.info("discovery dial %s failed: %s (retry in %.1fs)",
                     address, exc, delay)
        else:
            self._dial_backoff.pop(address, None)

    @staticmethod
    def _split(address: str) -> tuple[str, int]:
        hostport = address.split("://", 1)[-1]
        host, _, port = hostport.rpartition(":")
        return host, int(port)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # The dialer initiates; we answer its HELLO from the read loop.
        await self._read_loop(reader, writer, _Conn())

    # Bulk read size for transports without a recv_into surface (KCP):
    # one await + one ring fill per chunk instead of two per frame.
    READ_CHUNK = 256 << 10

    async def _read_loop(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        conn: _Conn,
    ) -> None:
        ring = _FrameRing()
        try:
            while True:
                data = await reader.read(self.READ_CHUNK)
                if not data:
                    break
                ring.feed_bytes(data)
                count = 0
                for frame in ring.frames(_MAX_FRAME):
                    count += 1
                    self._on_frame(frame, writer, conn)
                if count:
                    wire_metrics().fill(count, ring.pending())
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as exc:  # noqa: BLE001
            self._record_error(exc)
        finally:
            self._drop_writer(writer)

    def _register(self, pid: PeerID, writer: asyncio.StreamWriter, conn: _Conn) -> None:
        conn.peer = pid
        # Simultaneous mutual dials (common under gossip) produce two
        # connections per peer pair, and each side must close the SAME one:
        # "keep the newest" is not symmetric (registration order can differ
        # per side), and if A keeps conn1 while C keeps conn2, each closes
        # the other's survivor and the pair partitions until re-gossip.
        # Deterministic tie-break both sides agree on — applied only when
        # the two connections have OPPOSITE directions (the mutual-dial
        # shape): the connection DIALED by the lexicographically smaller
        # public key survives. Same-direction conflicts (a peer crashed
        # without FIN and reconnected the same way) keep the newest: the
        # old socket is dead and the remote only knows the new one.
        with self._lock:
            others = [
                p for key, p in self.peers.items() if key != pid.public_key
            ]
            prev = self.peers.get(pid.public_key)
            if prev is not None and prev.writer is writer:
                # Idempotent re-registration (a replayed-but-valid ACK on
                # the registered connection): nothing changed, so no
                # gossip re-announce and no close-the-loser dance.
                conn.registered.set()
                return
            keep_new = True
            if prev is not None:
                if prev.is_dialer != conn.is_dialer:
                    keep_new = conn.is_dialer == (
                        self.keys.public_key < pid.public_key
                    )
            if keep_new:
                self.peers[pid.public_key] = _Peer(
                    pid, writer, conn.is_dialer,
                    dial_address=conn.dial_address,
                )
        if prev is not None and prev.writer is not writer:
            # Demote the loser GRACEFULLY: the remote may have written
            # frames on it before learning the tie-break verdict (the
            # other side registers the loser first and can broadcast on
            # it immediately), and a hard close() discards whatever is
            # still unread in the kernel buffer — a one-shot message
            # vanishes with no teardown signal the sender can act on.
            # half_close() FINs our send side while the read loop keeps
            # draining; the loser's conn identity stays verified, so
            # those late frames still deliver, and the teardown
            # completes when the remote's own FIN answers. Its read-loop
            # teardown calls _drop_writer, which only removes entries
            # whose writer matches — the surviving entry is never
            # evicted by the teardown.
            loser = prev.writer if keep_new else writer
            log.info("demoting duplicate connection to %s (%s survives)",
                     pid.address, "new" if keep_new else "previous")
            event("conn.demote", peer=pid.address,
                  survivor="new" if keep_new else "previous")
            half = getattr(loser, "half_close", None)
            try:
                if half is not None:
                    half()
                else:
                    loser.close()
            # noise-ec: allow(event-on-swallow) — loser half-close race during connection-demote teardown
            except Exception:  # noqa: BLE001
                pass
            # Frames coalescing on the loser can no longer flush (its
            # send side just FINned); re-address them to the survivor.
            handle = self._flush_handles.pop(loser, None)
            if handle is not None:
                handle.cancel()
            pend = self._pending.pop(loser, None)
            lost_frames = self._pending_frames.pop(loser, 0)
            lost_bytes = self._pending_bytes.pop(loser, 0)
            if pend:
                self._reroute_frames(
                    pid.public_key, pend, lost_frames, lost_bytes,
                    exclude=loser,
                )
        conn.registered.set()
        if keep_new:
            # A registration that swapped the peer's connection releases
            # any frames that were parked while no live connection held
            # the entry (a broadcast racing the swap).
            self._flush_limbo(pid.public_key, writer)
            # INFO so operators (and the e2e tests) can observe exactly
            # when a peer becomes reachable instead of probing with
            # retried sends.
            log.info("registered peer %s", pid.address)
            if self.supervisor is not None and conn.dial_address is not None:
                # Any successful dial (bootstrap, discovery or supervised
                # re-dial) closes the address's breaker.
                self.supervisor.breaker(conn.dial_address).record_success()
        if self.discovery and others and keep_new:
            # Peer exchange (the reference's discovery.Plugin, main.go:151):
            # tell the newcomer who we know, and announce the newcomer to
            # everyone else, so broadcast reach is transitive rather than
            # limited to the bootstrap list. (A connection that lost the
            # mutual-dial tie-break is closing; its peer was already
            # gossiped when the surviving connection registered.)
            self._write_safe(
                writer,
                self._frame(
                    _OP_PEERS, _encode_peer_list([p.pid.address for p in others])
                ),
            )
            announce = self._frame(_OP_PEERS, _encode_peer_list([pid.address]))
            for p in others:
                self._write_safe(p.writer, announce)

    # noise-ec: loop-affine
    def _on_frame(
        self, body, writer: asyncio.StreamWriter, conn: _Conn
    ) -> None:
        """One parsed frame off the wire. ``body`` may be an in-place
        ring memoryview — anything kept past this call is materialized
        here. Runs on the connection's owning loop thread; the shard
        path defers its Ed25519 work to the batched verify stage so the
        loop thread never pays per-frame crypto (docs/design.md §15)."""
        metrics = transport_metrics()
        try:
            opcode, addr_b, pubkey, payload, sig = self._parse_frame_fields(
                body
            )
            addr = addr_b.decode()
        except (WireError, IndexError, struct.error, UnicodeDecodeError) as exc:
            metrics.error("wire")
            self._record_error(WireError(f"bad frame: {exc}"))
            return

        if opcode in (_OP_SHARD, _OP_SHARD_BATCH):
            # Only registered connections may deliver shards, and the
            # frame identity must match the handshake identity — checked
            # BEFORE any crypto, so an unregistered socket costs a dict
            # miss, not a verify.
            peer = conn.peer
            if peer is None or pubkey != peer.public_key:
                metrics.error("unregistered")
                self._record_error(
                    WireError(f"shard from unregistered connection ({addr})")
                )
                return
            # Reuse the handshake PeerID in the steady state (same key,
            # same claimed address) instead of re-hashing a node id per
            # frame; a frame claiming a different address still verifies
            # against its own claim.
            pid = peer if addr == peer.address else PeerID.create(addr, pubkey)
            # Digest on the loop thread while the ring view is alive:
            # the preimage streams through the hash in parts, so the
            # payload is never joined into a fresh buffer.
            digest = self._hash.hash_parts((
                bytes([opcode]),
                struct.pack("<I", len(addr_b)),
                addr_b,
                struct.pack("<I", len(payload)),
                payload,
            ))
            try:
                if opcode == _OP_SHARD:
                    msgs, rt = [Shard.unmarshal(payload)], None
                else:
                    msgs, rt = _decode_shard_batch(payload)
            except WireError as exc:
                metrics.error("wire")
                self._record_error(exc)
                return
            self._submit_verify(pid, digest, sig, msgs, len(body) + 4, rt)
            return

        # Control frames (handshake, gossip): rare and loop-affine —
        # verified inline, exactly as before.
        payload = bytes(payload)
        pid = PeerID.create(addr, pubkey)
        if not self._sig.verify(
            pubkey,
            self._hash.hash_bytes(_sign_preimage(opcode, addr_b, payload)),
            sig,
        ):
            metrics.error("signature")
            self._record_error(WireError(f"bad frame signature from {pid.address}"))
            return

        if opcode == _OP_HELLO:
            # Dialer's opening. Do NOT register yet — a replayed HELLO
            # carries a stale nonce and its sender cannot complete the ACK.
            if len(payload) != _NONCE_LEN:
                self._record_error(WireError("bad HELLO nonce length"))
                return
            self._write_safe(writer, self._frame(_OP_HELLO_REPLY, payload + conn.nonce))
            return
        if opcode == _OP_HELLO_REPLY:
            # Acceptor echoed our nonce inside a signed frame: fresh proof.
            if len(payload) != 2 * _NONCE_LEN or payload[:_NONCE_LEN] != conn.nonce:
                self._record_error(WireError(f"stale HELLO_REPLY from {pid.address}"))
                return
            # ACK before registering: _register may immediately gossip a
            # PEERS frame on this writer, and the acceptor must see our ACK
            # (and register us) first — TCP preserves per-connection order.
            self._write_safe(writer, self._frame(_OP_HELLO_ACK, payload[_NONCE_LEN:]))
            self._register(pid, writer, conn)
            return
        if opcode == _OP_HELLO_ACK:
            if payload != conn.nonce:
                self._record_error(WireError(f"stale HELLO_ACK from {pid.address}"))
                return
            self._register(pid, writer, conn)
            return
        if opcode == _OP_PEERS:
            # Gossip is accepted only from registered peers (same gate as
            # shards): an unauthenticated socket must not steer our dials.
            if conn.peer is None or pid.public_key != conn.peer.public_key:
                self._record_error(
                    WireError(f"peer list from unregistered connection ({pid.address})")
                )
                return
            if not self.discovery:
                return
            try:
                addresses = _decode_peer_list(payload)
            except (WireError, struct.error, UnicodeDecodeError) as exc:
                self._record_error(WireError(f"bad peer list: {exc}"))
                return
            with self._lock:
                known = {p.pid.address for p in self.peers.values()}
            now = self._loop.time()
            # Prune expired cooldowns so the dict stays bounded (gossiped
            # addresses are attacker-supplied; without pruning a hostile
            # peer grows it by a batch per tick forever). The cap below
            # bounds even the pathological all-unexpired case.
            self._dial_backoff = {
                a: v for a, v in self._dial_backoff.items()
                if now < v[0] + v[1]
            }
            while len(self._dial_backoff) > 4 * self.max_discovered_peers:
                self._dial_backoff.pop(next(iter(self._dial_backoff)))
            for addr in addresses:
                backoff = self._dial_backoff.get(addr)
                if (
                    addr == self.id.address
                    or addr in known
                    or addr in self._dialing
                    or (backoff is not None and now < backoff[0])
                    or len(self._dialing) >= self.max_discovered_peers
                ):
                    continue
                self._dialing.add(addr)
                task = self._loop.create_task(self._dial_discovered(addr))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
            return
    # Frames per verify cohort: matches the dispatcher's DRAIN_BATCH
    # scale so one drain's inline plugin work stays within the fairness
    # quantum; the batch-verify curve is flat past ~16 anyway.
    VERIFY_DRAIN_MAX = 16

    def _submit_verify(
        self, pid: PeerID, digest: bytes, sig: bytes, msgs: list,
        nbytes: int, trace: Optional[str] = None,
    ) -> None:
        """Queue parsed-but-unverified frames for the per-sender batched
        verify drain. Bounded by ``recv_window`` per sender (the same
        budget the dispatch queue enforces) — overflow drops the frame
        and counts it, never blocks the loop thread. ``trace`` is the
        cohort frame's request-trace id (rides to the plugin ``Ctx``
        only after the signature verifies)."""
        key = pid.public_key
        schedule = False
        overflow = False
        with self._verify_lock:
            q = self._verify_q.get(key)
            if q is None:
                q = self._verify_q[key] = deque()
            if len(q) >= self.recv_window:
                overflow = True
            else:
                q.append((pid, digest, sig, msgs, nbytes, trace))
                if key not in self._verify_scheduled:
                    self._verify_scheduled.add(key)
                    schedule = True
        if overflow:
            transport_metrics().error("overflow")
            self._record_error(
                RuntimeError(
                    f"recv window ({self.recv_window}) overflow from "
                    f"{pid.address}; shard dropped"
                )
            )
            return
        if schedule and not self._dispatch.submit(
            key, self._drain_verify, key
        ):
            with self._verify_lock:
                self._verify_scheduled.discard(key)
            transport_metrics().error("overflow")
            self._record_error(
                RuntimeError(
                    f"recv window ({self.recv_window}) overflow from "
                    f"{pid.address}; shard dropped"
                )
            )

    def _drain_verify(self, key: bytes) -> None:
        """One verify cohort for sender ``key``, on the dispatch pool:
        up to VERIFY_DRAIN_MAX queued frames verify as ONE batch
        (``crypto.verify_batch`` — per-item fan-back isolates a bad
        signature to its own frame), then the survivors' shards dispatch
        to the plugins in arrival order. Rides the per-sender serialized
        dispatcher, so ordering and DRR fairness hold unchanged."""
        with self._verify_lock:
            q = self._verify_q.get(key)
            batch = []
            while q and len(batch) < self.VERIFY_DRAIN_MAX:
                batch.append(q.popleft())
            if q:
                more = True
            else:
                more = False
                self._verify_scheduled.discard(key)
                self._verify_q.pop(key, None)
        if batch:
            metrics = transport_metrics()
            verdicts = self._sig.verify_batch(
                [(item[0].public_key, item[1], item[2]) for item in batch]
            )
            ok_count = sum(verdicts)
            wire_metrics().verify_batch(
                len(batch), ok_count,
                fell_back=len(batch) > 1 and ok_count < len(batch),
            )
            for (pid, _digest, _sig, msgs, nbytes, trace), ok in zip(
                batch, verdicts
            ):
                if not ok:
                    metrics.error("signature")
                    self._record_error(
                        WireError(f"bad frame signature from {pid.address}")
                    )
                    continue
                metrics.record_in(pid.address, nbytes, count=len(msgs))
                for msg in msgs:
                    self._dispatch_plugins(Ctx(msg, pid, trace=trace))
        if more and not self._dispatch.submit(key, self._drain_verify, key):
            with self._verify_lock:
                self._verify_scheduled.discard(key)

    def _dispatch_plugins(self, ctx: Ctx) -> None:
        metrics = transport_metrics()
        msg = ctx.message()
        key = trace_key(msg.file_signature) if isinstance(msg, Shard) else None
        rt = ctx.trace
        with span("deliver", key=key,
                  **({"request_trace": rt} if rt else {})):
            for plugin in self.plugins:
                try:
                    plugin.receive(ctx)
                except Exception as exc:  # noqa: BLE001
                    metrics.error("handler")
                    self._record_error(exc)
