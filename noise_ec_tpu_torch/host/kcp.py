"""Reliable-UDP streams: the transport's ``kcp`` protocol option.

Port of ``noise_ec_tpu.host.kcp``, whole.

The reference exposes ``-protocol tcp|kcp`` (main.go:123),
where kcp is ARQ-over-UDP from the noise library's transport registry. This
module is an original, minimal ARQ in that family — selective-repeat with
cumulative acks, Jacobson RTO, fast retransmit — presenting the same duplex
byte-stream interface the TCP path uses, so ``Network(protocol="kcp")``
reuses the entire signed-frame / handshake / discovery stack unchanged
(the ARQ layer carries no identity; authentication stays in the signed
HELLO handshake above it).

Wire format (one UDP datagram = one segment, little-endian):

    u32 conv | u8 cmd | u32 sn | u32 una | u16 len | payload

- ``conv``: connection id, chosen randomly by the dialer; sessions demux
  by (remote addr, conv), so no SYN exchange is needed — the first PUSH
  from an unknown pair creates the acceptor-side session.
- cmd PUSH (1): stream payload segment ``sn``.
- cmd ACK (2): payload is ``len/4`` u32 sns being acked explicitly;
  ``una`` (all-received-below) rides in every segment either way.
- cmd FIN (3): graceful close after delivery of everything below ``sn``.

Sender: sliding window of in-flight segments; retransmit on per-segment
RTO expiry (backed off 1.5x per transmission) or when two acks for later
segments arrive first (fast resend). A segment transmitted DEAD_XMIT times
closes the session (dead link). Receiver: out-of-order segments buffer
until contiguous, then feed an ``asyncio.StreamReader`` — reassembly is
positional, so the stream needs no fragment field.
"""

from __future__ import annotations

import asyncio
import os
import struct
import time
from collections import deque
from typing import Callable, Optional

from noise_ec_tpu_torch.obs.registry import default_registry

__all__ = ["open_kcp_connection", "start_kcp_server", "KcpServer"]


class _KcpMetrics:
    """Cached ARQ metric children (resolved once per process): retransmit
    counts by trigger, dead-link closes, sessions opened. Retransmit rate
    per peer is THE health signal for the UDP path — a rising rto share
    means loss, a rising fast share means reordering."""

    def __init__(self):
        reg = default_registry()
        fam = reg.counter("noise_ec_kcp_retransmits_total")
        self.rto = fam.labels(kind="rto")
        self.fast = fam.labels(kind="fast")
        self.dead = reg.counter("noise_ec_kcp_dead_links_total").labels()
        self.opened = reg.counter("noise_ec_kcp_sessions_opened_total").labels()


_metrics: Optional[_KcpMetrics] = None


def _kcp_metrics() -> _KcpMetrics:
    global _metrics
    if _metrics is None:
        _metrics = _KcpMetrics()
    return _metrics

_HDR = struct.Struct("<IBIIH")  # conv, cmd, sn, una, len
_CMD_PUSH = 1
_CMD_ACK = 2
_CMD_FIN = 3

MSS = 1200               # payload bytes per segment (under common MTUs)
SND_WND = 256            # max in-flight segments
UPDATE_INTERVAL = 0.01   # retransmission scan period (s)
RTO_MIN, RTO_MAX = 0.03, 3.0
DEAD_XMIT = 12           # transmissions of one segment before giving up
FAST_RESEND = 2          # later-acks before a skipped segment resends
HIGH_WATER = 1 << 20     # drain() blocks above this many buffered bytes
RCV_BUF_CAP = 4096       # out-of-order segments held before dropping


class _Seg:
    __slots__ = ("data", "sent_at", "rto", "xmit", "skips")

    def __init__(self, data: bytes):
        self.data = data
        self.sent_at = 0.0
        self.rto = 0.0
        self.xmit = 0
        self.skips = 0


class KcpSession:
    """One reliable stream over a shared UDP socket (see module doc)."""

    def __init__(self, conv: int, addr, sendto: Callable,
                 loop: asyncio.AbstractEventLoop,
                 on_close: Optional[Callable] = None):
        self.conv = conv
        self.addr = addr
        self._sendto = sendto
        self._loop = loop
        self._on_close = on_close
        self.reader = asyncio.StreamReader(loop=loop)
        # sender state
        self._snd_queue: deque[bytes] = deque()  # segmented, not yet in flight
        self._snd_buf: dict[int, _Seg] = {}      # sn -> in flight
        self._snd_nxt = 0
        self._queued_bytes = 0
        self._flight_bytes = 0
        self._partial = bytearray()              # < MSS tail awaiting more
        # receiver state
        self._rcv_nxt = 0
        self._rcv_buf: dict[int, bytes] = {}
        self._fin_at: Optional[int] = None
        self._read_eof = False  # peer FIN fully delivered (half-closed)
        self._half_close_deadline = 0.0  # write-idle close deadline after EOF
        # rtt estimation (Jacobson/Karels)
        self._srtt = 0.0
        self._rttvar = 0.0
        self._rto = 0.2
        self.closed = False
        # graceful-close state: FIN covers every byte written before
        # start_close(); the session lingers until it is acked (or the
        # linger deadline passes) so queued tail segments still deliver.
        self._fin_sn: Optional[int] = None
        self._fin_acked = False
        self._close_deadline: Optional[float] = None
        self._close_hard = 0.0  # set with _close_deadline in start_close
        self._drain_waiters: list[asyncio.Future] = []
        self._metrics = _kcp_metrics()
        self._metrics.opened.add(1)
        self._update_handle = loop.call_later(UPDATE_INTERVAL, self._update)

    # ------------------------------------------------------------- sending

    def write(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionError("kcp session closed")
        if self._fin_sn is not None:
            # Writer already closed (start_close announced _fin_sn): the
            # peer's _push guard drops any segment with sn >= _fin_sn
            # unacked, so queued data would be silently lost and
            # retransmitted until the close deadline. TCP
            # shutdown(SHUT_WR) semantics: writing after closing the
            # write side is an error.
            raise ConnectionError("kcp write side already closed")
        if self._read_eof:
            # Half-closed: each write pushes the idle-close deadline out.
            self._half_close_deadline = time.monotonic() + self.LINGER
        buf = self._partial + data
        for i in range(0, len(buf) - MSS + 1, MSS):
            seg = bytes(buf[i : i + MSS])
            self._snd_queue.append(seg)
            self._queued_bytes += len(seg)
        tail = len(buf) % MSS if len(buf) >= MSS else len(buf)
        self._partial = bytearray(buf[len(buf) - tail :]) if tail else bytearray()
        self._fill_window()

    def flush_partial(self) -> None:
        """Push the sub-MSS tail out now (called before drain/idle)."""
        if self._partial:
            seg = bytes(self._partial)
            self._partial = bytearray()
            self._snd_queue.append(seg)
            self._queued_bytes += len(seg)
            self._fill_window()

    def buffered_bytes(self) -> int:
        return self._queued_bytes + self._flight_bytes + len(self._partial)

    async def drain(self) -> None:
        self.flush_partial()
        if self.buffered_bytes() <= HIGH_WATER or self.closed:
            return
        fut = self._loop.create_future()
        self._drain_waiters.append(fut)
        await fut

    def _fill_window(self) -> None:
        while self._snd_queue and len(self._snd_buf) < SND_WND:
            data = self._snd_queue.popleft()
            self._queued_bytes -= len(data)
            sn = self._snd_nxt
            self._snd_nxt += 1
            seg = _Seg(data)
            self._snd_buf[sn] = seg
            self._flight_bytes += len(data)
            self._transmit(sn, seg)

    def _transmit(self, sn: int, seg: _Seg) -> None:
        seg.xmit += 1
        seg.sent_at = time.monotonic()
        seg.rto = max(RTO_MIN, min(self._rto * (1.5 ** (seg.xmit - 1)), RTO_MAX))
        seg.skips = 0
        self._send_raw(_CMD_PUSH, sn, seg.data)

    def _send_raw(self, cmd: int, sn: int, payload: bytes = b"") -> None:
        hdr = _HDR.pack(self.conv, cmd, sn, self._rcv_nxt, len(payload))
        try:
            self._sendto(hdr + payload, self.addr)
        except OSError:
            pass  # transient socket error; retransmission covers the loss

    # ----------------------------------------------------------- receiving

    def input(self, data: bytes) -> None:
        """One datagram from the socket (header already conv-matched)."""
        if self.closed or len(data) < _HDR.size:
            return
        conv, cmd, sn, una, ln = _HDR.unpack_from(data)
        payload = data[_HDR.size : _HDR.size + ln]
        if len(payload) != ln:
            return  # truncated datagram
        freed = self._ack_upto(una)
        if cmd == _CMD_ACK:
            now = time.monotonic()
            for (ack_sn,) in struct.iter_unpack("<I", payload):
                self._ack_one(ack_sn, now)
            self._after_acks()
        elif freed:
            # una piggybacked on PUSH/FIN freed flight slots: refill the
            # window and wake drain() waiters now rather than waiting up to
            # UPDATE_INTERVAL for the next timer tick (bidirectional flows).
            self._fill_window()
            self._wake_drains()
        if cmd == _CMD_PUSH:
            self._push(sn, payload)
        elif cmd == _CMD_FIN:
            self._fin_at = sn
            self._send_raw(_CMD_ACK, 0, struct.pack("<I", sn))
            self._maybe_finish()

    def _push(self, sn: int, payload: bytes) -> None:
        if self._fin_at is not None and sn >= self._fin_at:
            # The peer's FIN covers exactly the segments below _fin_at: a
            # PUSH at or past it is corrupt/spoofed traffic. During the
            # half-closed linger it could otherwise reach feed_data after
            # feed_eof (StreamReader asserts); drop it unacked.
            return
        if sn > self._rcv_nxt + RCV_BUF_CAP:
            # Beyond the reorder window: drop WITHOUT acking, so the sender
            # retransmits once the window advances (acking here would pop it
            # from the peer's flight buffer and lose the bytes forever).
            return
        # Ack stored segments and duplicates alike — the prior ack may have
        # been lost.
        self._send_raw(_CMD_ACK, 0, struct.pack("<I", sn))
        if sn < self._rcv_nxt or sn in self._rcv_buf:
            return
        if self._fin_sn is not None and self._close_deadline is not None:
            # Inbound progress while we wait out our own close: keep the
            # session alive so the peer's response can finish delivering —
            # but never past the hard cap, or a peer that streams forever
            # without FINning holds the session (and its reader buffer)
            # open unboundedly.
            self._close_deadline = min(
                time.monotonic() + self.LINGER, self._close_hard
            )
        self._rcv_buf[sn] = payload
        while self._rcv_nxt in self._rcv_buf:
            self.reader.feed_data(self._rcv_buf.pop(self._rcv_nxt))
            self._rcv_nxt += 1
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        # Half-close: the peer's FIN ends the READ side only. The write
        # side stays fully usable — locally queued and un-acked outbound
        # segments keep transmitting, and the app can still respond (the
        # TCP path would deliver both after a remote close). The session
        # fully closes when our own writer closes too (the FIN handshake in
        # _update), or after LINGER seconds of write-side idleness as leak
        # protection for handlers that never close their writer.
        if self._fin_at is not None and self._rcv_nxt >= self._fin_at:
            if not self._read_eof:
                self._read_eof = True
                self._half_close_deadline = time.monotonic() + self.LINGER
                self.reader.feed_eof()
            self._maybe_close_half_closed()

    def _maybe_close_half_closed(self) -> None:
        if not self._read_eof or self.closed:
            return
        if self._snd_buf or self._snd_queue or self._partial:
            return  # outbound data still delivering
        if self._fin_sn is not None:
            # Writer closed: the normal FIN completion in _update() owns
            # the close (fin acked, or its deadline); finish early here
            # when the ack already arrived.
            if self._fin_acked:
                self.close()
            return
        if time.monotonic() >= self._half_close_deadline:
            self.close()

    # -------------------------------------------------------------- acking

    def _ack_upto(self, una: int) -> int:
        """Drop in-flight segments below ``una``; returns how many freed."""
        acked = [s for s in self._snd_buf if s < una]
        for sn in acked:
            self._flight_bytes -= len(self._snd_buf.pop(sn).data)
        return len(acked)

    def _ack_one(self, sn: int, now: float) -> None:
        if self._fin_sn is not None and sn == self._fin_sn:
            self._fin_acked = True
        seg = self._snd_buf.pop(sn, None)
        if seg is None:
            return
        self._flight_bytes -= len(seg.data)
        if seg.xmit == 1:  # Karn: sample RTT only from unambiguous acks
            rtt = now - seg.sent_at
            if self._srtt == 0.0:
                self._srtt, self._rttvar = rtt, rtt / 2
            else:
                self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - rtt)
                self._srtt = 0.875 * self._srtt + 0.125 * rtt
            self._rto = max(RTO_MIN, min(self._srtt + 4 * self._rttvar, RTO_MAX))
        # Fast resend: anything older that keeps being skipped by newer acks.
        for older_sn, older in self._snd_buf.items():
            if older_sn < sn:
                older.skips += 1

    def _after_acks(self) -> None:
        for sn, seg in list(self._snd_buf.items()):
            if seg.skips >= FAST_RESEND:
                self._metrics.fast.add(1)
                self._transmit(sn, seg)
        self._fill_window()
        self._wake_drains()
        self._maybe_close_half_closed()

    # ------------------------------------------------------------ lifecycle

    def _update(self) -> None:
        if self.closed:
            return
        now = time.monotonic()
        for sn, seg in list(self._snd_buf.items()):
            if now - seg.sent_at >= seg.rto:
                if seg.xmit >= DEAD_XMIT:
                    self._metrics.dead.add(1)
                    self.close(ConnectionError("kcp dead link"))
                    return
                self._metrics.rto.add(1)
                self._transmit(sn, seg)
        # An idle tick flushes a lingering sub-MSS tail (write coalescing
        # above already batches; this bounds tail latency).
        if not self._snd_buf and not self._snd_queue and self._partial:
            self.flush_partial()
        if self._fin_sn is not None:
            done_sending = not self._snd_buf and not self._snd_queue
            # Both directions must finish before the full close: our FIN
            # acked AND the peer's FIN delivered (half-close: closing our
            # writer must not discard the peer's in-flight response). The
            # linger deadline bounds the wait for a peer that never FINs;
            # _push extends it while inbound data is still arriving.
            if (self._fin_acked and done_sending and self._read_eof) or (
                now >= self._close_deadline
            ):
                self.close()
                return
            if done_sending and not self._fin_acked:
                self._send_raw(_CMD_FIN, self._fin_sn)  # FIN retransmit
        self._maybe_close_half_closed()
        if self.closed:
            return
        self._wake_drains()
        self._update_handle = self._loop.call_later(UPDATE_INTERVAL, self._update)

    def _wake_drains(self) -> None:
        if self.buffered_bytes() <= HIGH_WATER or self.closed:
            for fut in self._drain_waiters:
                if not fut.done():
                    fut.set_result(None)
            self._drain_waiters.clear()

    LINGER = 5.0  # max seconds to keep delivering the tail after close()
    HALF_OPEN_MAX = 60.0  # hard cap on total post-close inbound lingering

    def start_close(self) -> None:
        """Graceful close (writer.close()): FIN covers ALL bytes written so
        far — including segments still waiting in the send queue, whose sns
        are preassigned by position — and the session lingers until the
        peer acks the FIN (everything delivered) or the deadline passes."""
        if self._fin_sn is not None or self.closed:
            return
        self.flush_partial()
        self._fin_sn = self._snd_nxt + len(self._snd_queue)
        now = time.monotonic()
        self._close_deadline = now + self.LINGER
        self._close_hard = now + self.HALF_OPEN_MAX
        self._send_raw(_CMD_FIN, self._fin_sn)

    def close(self, error: Optional[Exception] = None) -> None:
        if self.closed:
            return
        self.closed = True
        self._update_handle.cancel()
        if error is not None and not self._read_eof:
            self.reader.set_exception(error)
        else:
            # The inbound stream already finished cleanly (peer FIN fully
            # delivered): a send-side failure during the half-closed linger
            # (e.g. dead link) must not turn already-delivered data and its
            # clean EOF into a read error.
            self.reader.feed_eof()
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_result(None)
        self._drain_waiters.clear()
        if self._on_close is not None:
            self._on_close(self)


class KcpWriter:
    """StreamWriter-shaped facade over a session (the interface the signed
    framing layer consumes: write / drain / close /
    transport.get_write_buffer_size)."""

    def __init__(self, session: KcpSession):
        self._s = session
        self.transport = self  # .transport.get_write_buffer_size() duck type

    def get_write_buffer_size(self) -> int:
        return self._s.buffered_bytes()

    def write(self, data: bytes) -> None:
        self._s.write(data)
        self._s.flush_partial()

    async def drain(self) -> None:
        await self._s.drain()

    def close(self) -> None:
        if not self._s.closed:
            self._s.start_close()

    def is_closing(self) -> bool:
        return self._s.closed


class _Endpoint(asyncio.DatagramProtocol):
    """One UDP socket demuxing sessions by (remote addr, conv)."""

    TOMBSTONE_TTL = 30.0  # refuse re-accepting a closed (addr, conv) for this long

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 on_accept: Optional[Callable] = None):
        self._loop = loop
        self._on_accept = on_accept  # server: cb(reader, writer)
        self.sessions: dict[tuple, KcpSession] = {}
        # Closed-session keys with expiry: a PUSH retransmission straggling
        # in after close must not resurrect a zombie session + handler.
        self._tombstones: dict[tuple, float] = {}
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < _HDR.size:
            return
        conv, cmd, sn = _HDR.unpack_from(data)[:3]
        # Client endpoints are connected-UDP: one remote, sessions keyed by
        # conv alone (registered under addr=None before any reply arrives).
        key = (addr, conv) if self._on_accept is not None else (None, conv)
        sess = self.sessions.get(key)
        if sess is None:
            # Accept only a stream-INITIAL push (sn 0) from a non-tombstoned
            # key: mid-stream retransmissions for a dead session, and stray
            # ACK/FIN datagrams, must not create zombie sessions.
            if self._on_accept is None or cmd != _CMD_PUSH or sn != 0:
                return
            now = time.monotonic()
            dead_at = self._tombstones.get(key)
            if dead_at is not None:
                if now < dead_at + self.TOMBSTONE_TTL:
                    return
                del self._tombstones[key]
            if len(self._tombstones) > 4096:  # bounded; expire the stale
                self._tombstones = {
                    k: t for k, t in self._tombstones.items()
                    if now < t + self.TOMBSTONE_TTL
                }
            sess = self._make_session(conv, addr)
            reader, writer = sess.reader, KcpWriter(sess)
            self._loop.create_task(self._on_accept(reader, writer))
        sess.input(data)

    def _make_session(self, conv: int, addr) -> KcpSession:
        key = (addr, conv)

        def on_close(s, _key=key):
            self.sessions.pop(_key, None)
            self._tombstones[_key] = time.monotonic()

        sess = KcpSession(conv, addr, self._sendto, self._loop, on_close)
        self.sessions[key] = sess
        return sess

    def _sendto(self, data: bytes, addr) -> None:
        if self.transport is not None and not self.transport.is_closing():
            self.transport.sendto(data, addr)

    def close(self) -> None:
        for sess in list(self.sessions.values()):
            sess.close()
        if self.transport is not None:
            self.transport.close()


class KcpServer:
    """Server facade matching what the network layer uses from
    ``asyncio.AbstractServer``: ``.sockets[0].getsockname()``, ``.close()``."""

    def __init__(self, endpoint: _Endpoint):
        self._endpoint = endpoint

    @property
    def sockets(self):
        return [self._endpoint.transport.get_extra_info("socket")]

    def close(self) -> None:
        self._endpoint.close()


async def start_kcp_server(client_cb, host: str, port: int) -> KcpServer:
    """UDP-bind and dispatch each new (addr, conv) stream to ``client_cb``
    (same callback signature as ``asyncio.start_server``)."""
    loop = asyncio.get_running_loop()
    endpoint = _Endpoint(loop, on_accept=client_cb)
    await loop.create_datagram_endpoint(
        lambda: endpoint, local_addr=(host, port)
    )
    return KcpServer(endpoint)


async def open_kcp_connection(host: str, port: int):
    """Dial: returns (StreamReader, KcpWriter) like
    ``asyncio.open_connection``. The conv id is random; the session exists
    as soon as the first PUSH lands (no SYN round trip)."""
    loop = asyncio.get_running_loop()
    endpoint = _Endpoint(loop, on_accept=None)
    await loop.create_datagram_endpoint(
        lambda: endpoint, remote_addr=(host, port)
    )
    conv = struct.unpack("<I", os.urandom(4))[0]
    # connected-UDP transports pass addr=None to sendto
    sess = KcpSession(conv, None, lambda d, _a: endpoint._sendto(d, None), loop)
    endpoint.sessions[(None, conv)] = sess

    orig_on_close = sess._on_close

    def on_close(s):
        endpoint.sessions.pop((None, conv), None)
        endpoint.close()
        if orig_on_close:
            orig_on_close(s)

    sess._on_close = on_close
    return sess.reader, KcpWriter(sess)
