"""Wire format: the ``erasurecode.Shard`` proto3 message.

Port of ``noise_ec_tpu.host.wire``, whole: the port's node puts the same
bytes on the wire as the reference's.

Byte-compatible with the reference's wire schema (field numbers and types
are the compatibility contract — SURVEY.md §2.3 D4):

    message Shard {                         // protobuf/shard.proto:21-27
      bytes  file_signature        = 1;
      bytes  shard_data            = 2;
      uint64 shard_number          = 3;
      uint64 total_shards          = 4;
      uint64 minimum_needed_shards = 5;
    }

The codec is hand-rolled (no protobuf runtime dependency), mirroring the
observable semantics of the reference's generated gogoproto code:

- marshal writes tags 0x0a/0x12/0x18/0x20/0x28 in field order and **omits**
  empty bytes / zero varints (proto3 default elision —
  protobuf/shard.pb.go:219-252);
- unmarshal is a varint-driven field loop with overflow and truncation
  checks (shard.pb.go:413-581); unknown fields are skipped, including
  nested group recursion (``skipShard``, shard.pb.go:582-680); a known
  field with the wrong wire type is an error;
- ``size()`` equals ``len(marshal())`` (shard.pb.go:355-376);
- ``populate(rng)`` is the randomized-instance generator the reference's
  fuzz tests build on (``NewPopulatedShard``, shard.pb.go:263-281).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Shard", "WireError", "marshal_shard", "unmarshal_shard"]

_MAX_VARINT_BYTES = 10  # 64-bit varints occupy at most 10 bytes


class WireError(ValueError):
    """Malformed wire bytes (truncation, varint overflow, bad wire type)."""


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varint_size(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def _get_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    start = pos
    while True:
        if pos >= len(buf):
            raise WireError("unexpected EOF in varint")
        if pos - start >= _MAX_VARINT_BYTES:
            raise WireError("varint overflow")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int, depth: int = 0) -> int:
    """Skip one unknown field's payload; mirrors skipShard
    (shard.pb.go:582-680) including group recursion."""
    if depth > 64:
        raise WireError("group nesting too deep")
    if wire_type == 0:  # varint
        _, pos = _get_varint(buf, pos)
        return pos
    if wire_type == 1:  # fixed64
        if pos + 8 > len(buf):
            raise WireError("unexpected EOF in fixed64")
        return pos + 8
    if wire_type == 2:  # length-delimited
        ln, pos = _get_varint(buf, pos)
        if ln < 0 or pos + ln > len(buf):
            raise WireError("unexpected EOF in bytes field")
        return pos + ln
    if wire_type == 3:  # start group: skip until matching end group
        while True:
            if pos >= len(buf):
                raise WireError("unexpected EOF in group")
            tag, pos = _get_varint(buf, pos)
            inner_type = tag & 0x7
            if inner_type == 4:  # end group
                return pos
            pos = _skip_field(buf, pos, inner_type, depth + 1)
    if wire_type == 5:  # fixed32
        if pos + 4 > len(buf):
            raise WireError("unexpected EOF in fixed32")
        return pos + 4
    raise WireError(f"illegal wire type {wire_type}")


_TEXT_ESCAPES = {0x07: "\\a", 0x08: "\\b", 0x0C: "\\f", 0x0A: "\\n",
                 0x0D: "\\r", 0x09: "\\t", 0x0B: "\\v",
                 0x22: '\\"', 0x27: "\\'", 0x5C: "\\\\"}
_TEXT_UNESCAPES = {"a": 7, "b": 8, "f": 12, "n": 10, "r": 13, "t": 9,
                   "v": 11, '"': 0x22, "'": 0x27, "\\": 0x5C, "?": 0x3F}


def _text_escape(b: bytes) -> str:
    """Proto text-format string escaping (C escapes + octal)."""
    out = []
    for c in b:
        esc = _TEXT_ESCAPES.get(c)
        if esc is not None:
            out.append(esc)
        elif 0x20 <= c < 0x7F:
            out.append(chr(c))
        else:
            out.append(f"\\{c:03o}")
    return "".join(out)


def _text_unescape(s: str, pos: int) -> tuple[bytes, int]:
    """Parse one quoted string starting at s[pos]; returns (bytes, end)."""
    quote = s[pos]
    pos += 1
    out = bytearray()
    n = len(s)
    while pos < n and s[pos] != quote:
        c = s[pos]
        if c != "\\":
            out += c.encode("utf-8")
            pos += 1
            continue
        pos += 1
        if pos >= n:
            raise WireError("dangling escape in text string")
        e = s[pos]
        if e in _TEXT_UNESCAPES:
            out.append(_TEXT_UNESCAPES[e])
            pos += 1
        elif e in "xX":
            pos += 1
            start = pos
            while pos < n and pos - start < 2 and s[pos] in "0123456789abcdefABCDEF":
                pos += 1
            if pos == start:
                raise WireError("bad hex escape in text string")
            out.append(int(s[start:pos], 16))
        elif e in "01234567":
            start = pos
            while pos < n and pos - start < 3 and s[pos] in "01234567":
                pos += 1
            val = int(s[start:pos], 8)
            if val > 255:
                raise WireError(f"octal escape \\{s[start:pos]} > 255")
            out.append(val)
        else:
            raise WireError(f"unknown escape \\{e} in text string")
    if pos >= n:
        raise WireError("unterminated text string")
    return bytes(out), pos + 1


@dataclass
class Shard:
    """One erasure-coded shard in flight (SURVEY.md C13).

    ``file_signature`` is the ed25519 signature of the *whole* original
    message (not this shard) — it identifies the reassembly pool and
    provides end-to-end integrity. ``total_shards``/``minimum_needed_shards``
    carry the RS geometry so the receiver never relies on its own defaults
    (main.go:73, §3.1 geometry note).
    """

    file_signature: bytes = b""
    shard_data: bytes = b""
    shard_number: int = 0
    total_shards: int = 0
    minimum_needed_shards: int = 0
    # --- streaming extension (fields 6-8; this framework only) ---------
    # Large objects stream as a sequence of independently erasure-coded
    # chunks sharing ONE object signature (file_signature signs the whole
    # object; per-chunk pools key on signature + chunk index). All three
    # fields zero-elide, so non-stream shards marshal byte-identically to
    # the reference schema, and reference decoders skip them as unknown
    # fields (shard.pb.go:582-680 skips; so does our _skip_field).
    # ``stream_chunk_count > 0`` marks a stream shard; every chunk carries
    # the same payload capacity (k * len(shard_data) bytes), and
    # ``stream_object_bytes`` trims the final chunk's zero padding.
    stream_chunk_index: int = 0
    stream_chunk_count: int = 0
    stream_object_bytes: int = 0

    def __str__(self) -> str:
        """Log-friendly one-liner (the gogoproto String(), SURVEY.md C20):
        byte fields as truncated hex, varints verbatim."""
        sig = self.file_signature.hex()
        data = self.shard_data
        body = data[:16].hex() + ("…" if len(data) > 16 else "")
        return (
            f"shard {self.shard_number}/{self.total_shards}"
            f"(min {self.minimum_needed_shards}) "
            f"sig={sig[:16]}… data[{len(data)}]={body}"
        )

    def gostring(self) -> str:
        """Evaluable constructor expression (the gogoproto GoString(),
        SURVEY.md C20) — ``eval(s.gostring())`` reproduces the shard."""
        return (
            f"Shard(file_signature={self.file_signature!r}, "
            f"shard_data={self.shard_data!r}, "
            f"shard_number={self.shard_number!r}, "
            f"total_shards={self.total_shards!r}, "
            f"minimum_needed_shards={self.minimum_needed_shards!r})"
        )

    # JSON / text-format field table: (attribute, jsonpb lowerCamelCase
    # name, kind). The reference's generated test suite round-trips both
    # representations (shardpb_test.go:84-137 — jsonpb, proto text,
    # compact text); these methods are the equivalents, cross-checked
    # against google.protobuf's json_format/text_format in
    # tests/test_wire_interop.py.
    _FIELDS = (
        ("file_signature", "fileSignature", "bytes"),
        ("shard_data", "shardData", "bytes"),
        ("shard_number", "shardNumber", "u64"),
        ("total_shards", "totalShards", "u64"),
        ("minimum_needed_shards", "minimumNeededShards", "u64"),
        ("stream_chunk_index", "streamChunkIndex", "u64"),
        ("stream_chunk_count", "streamChunkCount", "u64"),
        ("stream_object_bytes", "streamObjectBytes", "u64"),
    )

    def to_json_dict(self) -> dict:
        """proto3 JSON mapping (jsonpb): camelCase keys, bytes as
        standard base64, uint64 as decimal STRINGS, defaults omitted."""
        import base64

        out: dict = {}
        for attr, camel, kind in self._FIELDS:
            v = getattr(self, attr)
            if not v:
                continue
            if kind == "bytes":
                out[camel] = base64.b64encode(bytes(v)).decode("ascii")
            else:
                out[camel] = str(int(v))
        return out

    def to_json(self, indent=None) -> str:
        import json

        return json.dumps(self.to_json_dict(), indent=indent)

    @classmethod
    def from_json(cls, s) -> "Shard":
        """Parse jsonpb output; accepts both camelCase and original
        snake_case keys (required of proto3 JSON parsers), and u64 values
        as strings or numbers."""
        import base64
        import json

        obj = json.loads(s) if isinstance(s, (str, bytes)) else dict(s)
        if not isinstance(obj, dict):
            raise WireError("JSON shard must be an object")
        by_name = {}
        for attr, camel, kind in cls._FIELDS:
            by_name[camel] = (attr, kind)
            by_name[attr] = (attr, kind)
        kwargs: dict = {}
        for key, val in obj.items():
            hit = by_name.get(key)
            if hit is None:
                raise WireError(f"unknown JSON field {key!r}")
            attr, kind = hit
            if kind == "bytes":
                if not isinstance(val, str):
                    raise WireError(f"{key}: bytes field must be base64 string")
                # proto3 JSON parsers must accept the standard AND
                # URL-safe alphabets, padded or not (json_format does the
                # same normalize-then-decode); ONE strict decode after
                # normalization so foreign characters raise instead of
                # being silently dropped.
                b64 = val.replace("-", "+").replace("_", "/")
                b64 += "=" * (-len(b64) % 4)
                try:
                    kwargs[attr] = base64.b64decode(b64, validate=True)
                except Exception as exc:
                    raise WireError(f"{key}: invalid base64") from exc
            else:
                if isinstance(val, bool):
                    raise WireError(f"{key}: uint64 field got a bool")
                if isinstance(val, float):
                    if not val.is_integer():
                        raise WireError(f"{key}: uint64 got non-integer {val}")
                    val = int(val)
                try:
                    iv = int(val)
                except (TypeError, ValueError) as exc:
                    raise WireError(f"{key}: invalid uint64 {val!r}") from exc
                if not 0 <= iv < (1 << 64):
                    raise WireError(f"{key}: uint64 out of range")
                kwargs[attr] = iv
        return cls(**kwargs)

    def to_text(self) -> str:
        """proto text format, one ``name: value`` per line (gogo/golang
        text marshaling; shardpb_test.go:105-120)."""
        return "".join(
            f"{line}\n" for line in self._text_entries()
        )

    def to_compact_text(self) -> str:
        """Single-line text format (shardpb_test.go:122-137)."""
        return " ".join(self._text_entries())

    def _text_entries(self):
        for attr, _camel, kind in self._FIELDS:
            v = getattr(self, attr)
            if not v:
                continue
            if kind == "bytes":
                yield f'{attr}: "{_text_escape(bytes(v))}"'
            else:
                yield f"{attr}: {int(v)}"

    @classmethod
    def from_text(cls, s: str) -> "Shard":
        """Parse the text format (own output and google text_format's)."""
        by_name = {attr: kind for attr, _c, kind in cls._FIELDS}
        kwargs: dict = {}
        pos, n = 0, len(s)
        while True:
            while pos < n and s[pos] in " \t\r\n":
                pos += 1
            if pos >= n:
                break
            end = pos
            while end < n and (s[end].isalnum() or s[end] == "_"):
                end += 1
            name = s[pos:end]
            kind = by_name.get(name)
            if kind is None:
                raise WireError(f"unknown text field {name!r}")
            pos = end
            while pos < n and s[pos] in " \t":
                pos += 1
            if pos >= n or s[pos] != ":":
                raise WireError(f"expected ':' after {name}")
            pos += 1
            while pos < n and s[pos] in " \t":
                pos += 1
            if kind == "bytes":
                if pos >= n or s[pos] not in "\"'":
                    raise WireError(f"{name}: expected quoted string")
                chunks = []
                # Adjacent quoted strings concatenate (C/proto rule).
                while pos < n and s[pos] in "\"'":
                    part, pos = _text_unescape(s, pos)
                    chunks.append(part)
                    while pos < n and s[pos] in " \t":
                        pos += 1
                kwargs[name] = b"".join(chunks)
            else:
                end = pos
                while end < n and s[end] in "0123456789":
                    end += 1
                if end == pos:
                    raise WireError(f"{name}: expected integer")
                iv = int(s[pos:end])
                if iv >= (1 << 64):
                    raise WireError(f"{name}: uint64 out of range")
                kwargs[name] = iv
                pos = end
        return cls(**kwargs)

    def marshal(self) -> bytes:
        # shard_data dominates the message (often megabytes on the stream
        # path): join the three segments so its bytes are copied exactly
        # once, instead of bytearray-append + bytes() copying them twice.
        head = bytearray()
        if self.file_signature:
            head.append(0x0A)
            _put_varint(head, len(self.file_signature))
            head += self.file_signature
        if self.shard_data:
            head.append(0x12)
            _put_varint(head, len(self.shard_data))
        out = bytearray()
        if self.shard_number:
            out.append(0x18)
            _put_varint(out, self.shard_number)
        if self.total_shards:
            out.append(0x20)
            _put_varint(out, self.total_shards)
        if self.minimum_needed_shards:
            out.append(0x28)
            _put_varint(out, self.minimum_needed_shards)
        if self.stream_chunk_index:
            out.append(0x30)
            _put_varint(out, self.stream_chunk_index)
        if self.stream_chunk_count:
            out.append(0x38)
            _put_varint(out, self.stream_chunk_count)
        if self.stream_object_bytes:
            out.append(0x40)
            _put_varint(out, self.stream_object_bytes)
        if self.shard_data:
            return b"".join((bytes(head), self.shard_data, bytes(out)))
        return bytes(head + out)

    def marshal_parts(self) -> tuple:
        """``marshal()`` as (head, shard_data, tail) buffer parts whose
        concatenation is byte-identical to ``marshal()`` — the
        scatter-gather shape of the wire hot loop (docs/design.md §15):
        the transport signs the parts with a streaming hash and hands
        them to ``sendmsg`` as iovecs, so the dominant ``shard_data``
        buffer is never copied into a joined frame on the send path."""
        head = bytearray()
        if self.file_signature:
            head.append(0x0A)
            _put_varint(head, len(self.file_signature))
            head += self.file_signature
        data = self.shard_data
        if data:
            head.append(0x12)
            _put_varint(head, len(data))
        out = bytearray()
        if self.shard_number:
            out.append(0x18)
            _put_varint(out, self.shard_number)
        if self.total_shards:
            out.append(0x20)
            _put_varint(out, self.total_shards)
        if self.minimum_needed_shards:
            out.append(0x28)
            _put_varint(out, self.minimum_needed_shards)
        if self.stream_chunk_index:
            out.append(0x30)
            _put_varint(out, self.stream_chunk_index)
        if self.stream_chunk_count:
            out.append(0x38)
            _put_varint(out, self.stream_chunk_count)
        if self.stream_object_bytes:
            out.append(0x40)
            _put_varint(out, self.stream_object_bytes)
        return (bytes(head), data if data else b"", bytes(out))

    def size(self) -> int:
        n = 0
        if self.file_signature:
            ln = len(self.file_signature)
            n += 1 + _varint_size(ln) + ln
        if self.shard_data:
            ln = len(self.shard_data)
            n += 1 + _varint_size(ln) + ln
        if self.shard_number:
            n += 1 + _varint_size(self.shard_number)
        if self.total_shards:
            n += 1 + _varint_size(self.total_shards)
        if self.minimum_needed_shards:
            n += 1 + _varint_size(self.minimum_needed_shards)
        if self.stream_chunk_index:
            n += 1 + _varint_size(self.stream_chunk_index)
        if self.stream_chunk_count:
            n += 1 + _varint_size(self.stream_chunk_count)
        if self.stream_object_bytes:
            n += 1 + _varint_size(self.stream_object_bytes)
        return n

    @classmethod
    def unmarshal(cls, buf) -> "Shard":
        """Decode wire bytes into a Shard.

        ``buf`` may be ``bytes``, ``bytearray`` or a ``memoryview`` — the
        decoder walks it IN PLACE (the ring-buffer receive path hands in
        views of the recv ring, docs/design.md §15) and materializes each
        field as its own ``bytes`` exactly once, so the dominant
        ``shard_data`` payload is copied a single time end to end instead
        of whole-buffer-then-per-field."""
        if isinstance(buf, memoryview):
            buf = buf if buf.contiguous else bytes(buf)
        msg = cls()
        pos = 0
        while pos < len(buf):
            tag, pos = _get_varint(buf, pos)
            field_num = tag >> 3
            wire_type = tag & 0x7
            if field_num == 0:
                raise WireError("illegal field number 0")
            if field_num in (1, 2):
                if wire_type != 2:
                    raise WireError(
                        f"field {field_num}: expected wire type 2, got {wire_type}"
                    )
                ln, pos = _get_varint(buf, pos)
                if pos + ln > len(buf):
                    raise WireError("unexpected EOF in bytes field")
                # bytes() of a bytes slice is a no-op; of a memoryview
                # slice it is THE one copy this field ever pays.
                val = bytes(buf[pos : pos + ln])
                pos += ln
                if field_num == 1:
                    msg.file_signature = val
                else:
                    msg.shard_data = val
            elif field_num in (3, 4, 5, 6, 7, 8):
                if wire_type != 0:
                    raise WireError(
                        f"field {field_num}: expected wire type 0, got {wire_type}"
                    )
                val, pos = _get_varint(buf, pos)
                if field_num == 3:
                    msg.shard_number = val
                elif field_num == 4:
                    msg.total_shards = val
                elif field_num == 5:
                    msg.minimum_needed_shards = val
                elif field_num == 6:
                    msg.stream_chunk_index = val
                elif field_num == 7:
                    msg.stream_chunk_count = val
                else:
                    msg.stream_object_bytes = val
            else:
                pos = _skip_field(buf, pos, wire_type)
        return msg

    @classmethod
    def populate(cls, rng) -> "Shard":
        """Random instance for property/fuzz tests (mirrors
        NewPopulatedShard, shard.pb.go:263-281: 0-99-byte bytes fields,
        u32-range varints)."""
        return cls(
            file_signature=bytes(rng.integers(0, 256, size=int(rng.integers(0, 100)), dtype=int).tolist()),
            shard_data=bytes(rng.integers(0, 256, size=int(rng.integers(0, 100)), dtype=int).tolist()),
            shard_number=int(rng.integers(0, 1 << 32)),
            total_shards=int(rng.integers(0, 1 << 32)),
            minimum_needed_shards=int(rng.integers(0, 1 << 32)),
        )


def marshal_shard(s: Shard) -> bytes:
    return s.marshal()


def unmarshal_shard(buf: bytes) -> Shard:
    return Shard.unmarshal(buf)
