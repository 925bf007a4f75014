"""Chunked streaming encode/decode for wide and high-rate codes (BASELINE
config 3: RS(17,3), RS(50,20)) — the double-buffered host-device path.

Port of ``noise_ec_tpu.parallel.streaming``. The byte stream is chunked on
the host, each chunk one independent codeword batch (a lost chunk costs
only its own shards, as the reference's mempool isolates messages,
main.go:55), and three stages of the data path stay busy at once: while
chunk i computes on the card, chunk i+1's copy to the card is queued and
chunk i-1's rows are coming back. The consumer blocks only when the
window holds more than ``depth`` chunks and the oldest is still running.

The window is built from PyTorch's own parts:

- each chunk's rows are copied into pinned staging, and from there to the
  card on a side copy stream; the product waits for that copy on the
  device's current stream;
- the result comes back into fresh pinned host memory
  (``non_blocking=True``) behind an event, and ``Event.query()`` is the
  readiness probe that the reference's ``_is_ready`` was;
- a ring of depth + 1 (staging, device buffer) slots stands in for JAX
  buffer donation: a slot is written again only after the product that
  read it has finished.

Yielded arrays own their memory. A full chunk's data rows are views of
the caller's bytes (the caller holds them for the call, as in the
reference); a short tail chunk's rows are their own zero-padded buffer;
the parity and rebuilt rows sit in a pinned buffer of their own, which
torch's caching host allocator recycles only once the array is gone.

Parity-only fetch holds: the encoder brings back only the r parity rows,
since the k data rows are already the caller's. On the CPU
(``device="cpu"``) the same code runs the kernels' plain versions with no
copies in flight. Each chunk's dispatch-to-fetch latency lands in the
``noise_ec_stream_chunk_seconds`` histogram, one observation a chunk, as
in the reference (it includes the window's queueing: a growing p99 means
the consumer or the fetch, not the kernels, holds the stream back).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.parallel.batch import BatchCodec

__all__ = [
    "StreamChunk",
    "StreamingDecoder",
    "StreamingEncoder",
    "decode_stream",
]


class StreamChunk:
    """Encoded shards for one chunk of the stream.

    Constructed either from separate ``data`` (k, stride) / ``parity``
    (r, stride) uint8 rows — the parity-only-fetch path — or from a full
    ``shards`` (n, stride) array. ``shards`` is assembled (one concat
    copy) only if someone asks for it.
    """

    __slots__ = ("index", "data_len", "_shards", "data", "parity")

    def __init__(self, index: int, shards: Optional[np.ndarray] = None,
                 data_len: int = 0, *, data: Optional[np.ndarray] = None,
                 parity: Optional[np.ndarray] = None):
        self.index = index
        self.data_len = data_len
        self._shards = shards
        self.data = data
        self.parity = parity
        if shards is None and (data is None or parity is None):
            raise ValueError("StreamChunk needs shards or data+parity")

    @property
    def shards(self) -> np.ndarray:
        """(n, stride) codeword rows (assembled and cached on demand)."""
        if self._shards is None:
            self._shards = np.concatenate([self.data, self.parity], axis=0)
        return self._shards

    def rows(self) -> list:
        """Per-row buffers for wire marshal — zero-copy when the chunk
        carries split data/parity (no (n, stride) assembly)."""
        if self._shards is not None:
            return [self._shards[i] for i in range(self._shards.shape[0])]
        return (
            [self.data[i] for i in range(self.data.shape[0])]
            + [self.parity[i] for i in range(self.parity.shape[0])]
        )


class _UploadRing:
    """depth + 1 (staging, device buffer) slots for one stream's uploads
    (module doc). On the CPU the staging buffer is the product's input."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._slots: list = [None] * (depth + 1)
        self._next = 0
        self._copy = torch.cuda.Stream(device) if self.cuda else None

    def put(self, rows: np.ndarray) -> tuple[torch.Tensor, int]:
        """(R, stride) uint8 rows -> ((1, R, stride / 4) int32 words on the
        device, slot); work queued next on the current stream sees them."""
        R, stride = rows.shape
        if stride % 4:
            raise ValueError(f"row stride {stride} is not whole int32 words")
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is None or tuple(slot[0].shape) != (R, stride // 4):
            host = torch.empty((R, stride // 4), dtype=torch.int32,
                               pin_memory=self.cuda)
            dev = (torch.empty_like(host, device=self.device) if self.cuda
                   else host)
            slot = self._slots[i] = [host, dev, None]
        elif slot[2] is not None:
            slot[2].synchronize()  # the product that last read it is done
        host, dev, _ = slot
        host.numpy().view(np.uint8)[...] = rows
        if self.cuda:
            with torch.cuda.stream(self._copy):
                dev.copy_(host, non_blocking=True)
            dev.record_stream(self._copy)
            torch.cuda.current_stream(self.device).wait_stream(self._copy)
        return dev[None], i

    def release(self, i: int) -> None:
        """Slot ``i`` is free again once the work queued so far on the
        current stream has run."""
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._slots[i][2] = done


def _fetch(t: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start ``t``'s copy into fresh pinned host memory; (host tensor, the
    event that marks it done), or (t, None) for a tensor on the CPU."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _rows(host: torch.Tensor, done: Optional[torch.cuda.Event]) -> np.ndarray:
    """Wait for a fetch; its (R, TW) int32 words as (R, 4 * TW) uint8."""
    if done is not None:
        done.synchronize()
    return host.numpy().view(np.uint8)


def _drain(window: deque, depth: int) -> Iterator[tuple]:
    """Pop the window's leading (index, payload, host, done) entries in
    index order as (index, payload, rows): ready heads always flow; a head
    still in flight blocks only once the window holds more than ``depth``
    entries (0 drains it all)."""
    while window and (len(window) > depth or window[0][3] is None
                      or window[0][3].query()):
        index, payload, host, done = window.popleft()
        yield index, payload, _rows(host, done)


def _chunks(drained: Iterator[tuple], hist) -> Iterator[StreamChunk]:
    """The encoder's drained (index, (data_len, data, t0), parity) entries
    as StreamChunks, observing each chunk's seconds since its dispatch
    (``t0``) into ``hist``."""
    for index, (data_len, data, t0), parity in drained:
        hist.observe(time.perf_counter() - t0)
        yield StreamChunk(index=index, data_len=data_len, data=data,
                          parity=parity)


class StreamingEncoder:
    """Encode an arbitrary byte stream as a sequence of RS codewords.

    ``chunk_bytes`` is the payload per codeword, rounded down to whole
    symbols a stripe; it is split into k equal stripes, zero-padded to
    whole int32 words a stripe (the words path's unit; the padding sits
    at the tail, so :func:`decode_stream` drops it), and the parity is
    computed on the card through the double-buffered window (module doc).
    """

    def __init__(self, data_shards: int, parity_shards: int, *,
                 chunk_bytes: int = 1 << 20, field: str = "gf256",
                 matrix: str = "cauchy", device: str = "cuda"):
        self.codec = BatchCodec(data_shards, parity_shards, field=field,
                                matrix=matrix, device=device)
        self.k = data_shards
        self.r = parity_shards
        self.n = data_shards + parity_shards
        quantum = data_shards * (self.codec.gf.degree // 8)
        self.chunk_bytes = max(quantum, chunk_bytes - chunk_bytes % quantum)
        wq = 4 * data_shards
        self._padded_bytes = -(-self.chunk_bytes // wq) * wq
        # Per-chunk dispatch-to-fetch latency: one observe a chunk,
        # nothing on the per-kernel path.
        self._chunk_hist = default_registry().histogram(
            "noise_ec_stream_chunk_seconds"
        ).labels()

    def _stage(self, chunk) -> np.ndarray:
        """(k, stride) uint8 data rows: a view of the caller's bytes for a
        full chunk, a zero-padded buffer of its own for a short one."""
        buf = np.frombuffer(chunk, dtype=np.uint8)
        if buf.size < self._padded_bytes:
            pad = np.zeros(self._padded_bytes, dtype=np.uint8)
            pad[: buf.size] = buf
            buf = pad
        return buf.reshape(self.k, self._padded_bytes // self.k)

    def _dispatch(self, idx: int, chunk, ring: _UploadRing) -> tuple:
        """Queue one chunk's upload, parity product and parity fetch; its
        window entry. Waits on nothing in flight but its ring slot's last
        product."""
        t0 = time.perf_counter()
        data = self._stage(chunk)
        words, slot = ring.put(data)
        parity = self.codec.device_codec().matmul_words_batch(
            self.codec.parity_matrix, words)[0]
        ring.release(slot)
        return (idx, (len(chunk), data, t0), *_fetch(parity))

    def encode_stream(self, chunks: Iterable, depth: int = 4
                      ) -> Iterator[StreamChunk]:
        """Yield encoded StreamChunks in order; keeps up to ``depth``
        chunks in flight (module doc)."""
        ring = _UploadRing(self.codec.device_codec().device, depth)
        window: deque = deque()
        for idx, chunk in enumerate(chunks):
            if len(chunk) > self.chunk_bytes:
                raise ValueError(
                    f"chunk {idx} is {len(chunk)} bytes > chunk_bytes "
                    f"{self.chunk_bytes}"
                )
            window.append(self._dispatch(idx, chunk, ring))
            yield from _chunks(_drain(window, depth), self._chunk_hist)
        yield from _chunks(_drain(window, 0), self._chunk_hist)

    def encode_bytes(self, data, depth: int = 4) -> Iterator[StreamChunk]:
        """Chunk a contiguous buffer (zero-copy slices) and encode it."""
        view = memoryview(data).cast("B")
        if len(view) == 0:
            return iter(())
        return self.encode_stream(
            (view[off: off + self.chunk_bytes]
             for off in range(0, len(view), self.chunk_bytes)),
            depth=depth)


class StreamingDecoder:
    """Pipelined degraded-chunk rebuild: the decode half of the window.
    Chunks sharing one erasure pattern ride
    ``BatchCodec.reconstruct_batch_words`` with the encoder's overlap: the
    upload of chunk i+1 and the fetch of chunk i-1 around the rebuild of
    chunk i."""

    def __init__(self, data_shards: int, parity_shards: int, *,
                 field: str = "gf256", matrix: str = "cauchy",
                 device: str = "cuda"):
        self.codec = BatchCodec(data_shards, parity_shards, field=field,
                                matrix=matrix, device=device)
        self.k = data_shards
        self.n = data_shards + parity_shards

    def reconstruct_stream(self, chunks: Iterable[tuple], present: list[int],
                           depth: int = 4) -> Iterator[tuple]:
        """``chunks``: iterable of (index, rows) with ``rows`` a
        (len(present), stride) array of the surviving shards in
        ``present`` order, stride a multiple of 4 bytes. Yields (index,
        full (n, stride) uint8 codeword rows) in input order, ``depth``
        deep."""
        ring = _UploadRing(self.codec.device_codec().device, depth)
        window: deque = deque()
        for idx, rows in chunks:
            rows = np.asarray(rows)
            if rows.dtype != np.uint8:
                rows = np.ascontiguousarray(rows).view(np.uint8)
            if rows.ndim != 2 or rows.shape[0] != len(present):
                raise ValueError(
                    f"chunk {idx}: expected ({len(present)}, stride) rows, "
                    f"got {rows.shape}"
                )
            words, slot = ring.put(rows)
            full = self.codec.reconstruct_batch_words(words, present)[0]
            ring.release(slot)
            window.append((idx, None, *_fetch(full)))
            yield from ((i, out) for i, _, out in _drain(window, depth))
        yield from ((i, out) for i, _, out in _drain(window, 0))


def decode_stream(chunks: Iterable[StreamChunk], data_shards: int,
                  total_len: Optional[int] = None) -> bytes:
    """Reassemble the byte stream from (in-order, complete) StreamChunks."""
    parts = []
    for c in chunks:
        arr = (
            np.asarray(c.data) if c.data is not None
            else np.asarray(c.shards[:data_shards])
        )
        if arr.dtype != np.uint8:  # rebuilt gf65536 chunks may be uint16
            arr = arr.view(np.uint8)
        parts.append(arr.reshape(-1)[: c.data_len].tobytes())
    out = b"".join(parts)
    return out[:total_len] if total_len is not None else out
