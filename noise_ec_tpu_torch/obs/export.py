"""Prometheus text-format exposition (version 0.0.4).

Port of ``noise_ec_tpu.obs.export``, whole.

Renders the labeled registry (counters, gauges, histograms with
cumulative ``le`` buckets) plus any number of plain :class:`Counters`
bags (the plugin's per-node counters, the global kernel counters) as
prefixed counter series — so one scrape of ``/metrics`` carries the
whole node: transport per-peer series, stage latency histograms, plugin
state machine counts, and per-kernel byte totals.

No prometheus_client dependency: the format is a stable line protocol and
the stdlib renders it in ~100 lines, which keeps the container-image
constraint (nothing new to install) and the export path auditable.
"""

from __future__ import annotations

import re
from typing import Optional

from noise_ec_tpu_torch.obs.metrics import Counters
from noise_ec_tpu_torch.obs.registry import Registry, default_registry

__all__ = [
    "escape_label_value",
    "parse_exemplar",
    "parse_prometheus",
    "render_counters",
    "render_parsed",
    "render_prometheus",
    "split_exemplar",
    "unescape_label_value",
]

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")


def escape_label_value(value: str) -> str:
    """Backslash, double-quote and newline escaping per the exposition
    format spec — peer addresses carry ``://`` and arbitrary hosts."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    # Integral values print as integers (Prometheus convention); floats
    # get shortest-roundtrip formatting.
    if float(v).is_integer() and abs(v) < 2**63:
        return str(int(v))
    return repr(float(v))


def _labels_str(names: tuple[str, ...], values: tuple[str, ...],
                extra: str = "") -> str:
    parts = [
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _render_family(fam, out: list[str]) -> None:
    children = sorted(fam.children())
    if not children:
        # Empty-family suppression: a family touched but never labeled
        # has no samples; bare HELP/TYPE lines would make scrapers
        # ingest a sampleless family forever.
        return
    out.append(f"# HELP {fam.name} {fam.help}")
    out.append(f"# TYPE {fam.name} {fam.type}")
    for values, child in children:
        lbl = _labels_str(fam.label_names, values)
        if fam.type == "counter":
            out.append(f"{fam.name}{lbl} {_fmt(child.value)}")
        elif fam.type == "gauge":
            out.append(f"{fam.name}{lbl} {_fmt(child.read())}")
        else:  # histogram: cumulative le buckets + sum + count
            snap = child.snapshot()
            exemplars = snap.get("exemplars") or {}
            cum = 0
            for i, (bound, count) in enumerate(
                zip(snap["bounds"], snap["counts"])
            ):
                cum += count
                le = _labels_str(
                    fam.label_names, values, f'le="{_fmt_le(bound)}"'
                )
                out.append(
                    f"{fam.name}_bucket{le} {cum}"
                    f"{_fmt_exemplar(exemplars.get(i))}"
                )
            cum += snap["counts"][-1]
            le = _labels_str(fam.label_names, values, 'le="+Inf"')
            out.append(
                f"{fam.name}_bucket{le} {cum}"
                f"{_fmt_exemplar(exemplars.get(len(snap['bounds'])))}"
            )
            out.append(f"{fam.name}_sum{lbl} {repr(snap['sum'])}")
            out.append(f"{fam.name}_count{lbl} {snap['count']}")


def _fmt_exemplar(ex: Optional[dict]) -> str:
    """OpenMetrics-style exemplar suffix for one bucket line
    (`` # {trace_id="..."} <value>``), or "" — the parser keeps sample
    values as raw text, so the suffix round-trips byte-exact and the
    federator can forward it untouched."""
    if not ex:
        return ""
    tid = escape_label_value(str(ex["trace_id"]))
    return f' # {{trace_id="{tid}"}} {repr(float(ex["value"]))}'


def _fmt_le(bound: float) -> str:
    return _fmt(bound) if bound == int(bound) else format(bound, ".9g")


def sanitize_name(name: str) -> str:
    """Counter-bag keys (``decode_s``, ``matmul_words_bytes``) to legal
    metric name fragments."""
    name = _NAME_FIX.sub("_", name)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def render_counters(prefix: str, counters: Counters) -> list[str]:
    """One :class:`Counters` bag as ``<prefix>_<key>`` counter lines.

    Flat counter bags are untyped at the source, but every key is
    monotonically increasing by the Counters contract, so counter is the
    honest exposition type.
    """
    out: list[str] = []
    for key, value in sorted(counters.snapshot().items()):
        name = f"{prefix}_{sanitize_name(key)}"
        out.append(f"# TYPE {name} counter")
        out.append(f"{name} {_fmt(value)}")
    return out


def render_prometheus(
    registry: Optional[Registry] = None,
    extra_counters: Optional[dict[str, Counters]] = None,
) -> str:
    """The full exposition document. ``extra_counters`` maps a metric
    prefix to a plain Counters bag (e.g. ``{"noise_ec_plugin":
    plugin.counters, "noise_ec_kernel": kernel_counters}``)."""
    reg = registry if registry is not None else default_registry()
    out: list[str] = []
    for fam in reg.collect():
        _render_family(fam, out)
    for prefix, counters in (extra_counters or {}).items():
        out.extend(render_counters(prefix, counters))
    return "\n".join(out) + "\n"


# --------------------------------------------------------------- parsing
#
# The inverse of the renderer above, shared by metrics federation
# (obs/federate.py) and the round-trip tests: parse_prometheus keeps
# sample values as the RAW strings the peer rendered, so
# parse -> render_parsed reproduces the input byte for byte — the
# property that pins escaping, +Inf buckets and integer formatting to
# one codec instead of two drifting halves.

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

_EXEMPLAR_RE = re.compile(
    r'^\{trace_id="((?:[^"\\]|\\.)*)"\}\s+(\S+)$'
)


def split_exemplar(raw: str) -> tuple[str, Optional[str]]:
    """Split one raw sample value into ``(numeric text, exemplar text or
    None)``. ``parse_prometheus`` keeps values verbatim, so a bucket
    line's ``# {trace_id=...} v`` exemplar rides inside the value
    string; consumers that need the number alone (the federator's
    bucket folding) split here."""
    num, sep, ex = raw.partition(" # ")
    if not sep:
        return raw, None
    return num, ex or None


def parse_exemplar(text: Optional[str]) -> Optional[dict]:
    """One exemplar suffix (the :func:`split_exemplar` tail) ->
    ``{"trace_id", "value"}``, or None when absent/unparseable."""
    if not text:
        return None
    m = _EXEMPLAR_RE.match(text.strip())
    if m is None:
        return None
    try:
        value = float(m.group(2))
    except ValueError:
        return None
    return {
        "trace_id": unescape_label_value(m.group(1)),
        "value": value,
    }


def unescape_label_value(value: str) -> str:
    """Inverse of :func:`escape_label_value`. Strict: an escape sequence
    other than ``\\\\``, ``\\"`` or ``\\n`` raises ``ValueError`` —
    a malformed peer document must fail the scrape, not corrupt the
    merged view."""
    if "\\" not in value:
        return value
    out: list[str] = []
    i, n = 0, len(value)
    while i < n:
        ch = value[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        if i + 1 >= n:
            raise ValueError(f"dangling backslash in label value {value!r}")
        nxt = value[i + 1]
        if nxt == "\\":
            out.append("\\")
        elif nxt == '"':
            out.append('"')
        elif nxt == "n":
            out.append("\n")
        else:
            raise ValueError(
                f"unknown escape \\{nxt} in label value {value!r}"
            )
        i += 2
    return "".join(out)


def _parse_labels(line: str, pos: int) -> tuple[tuple[tuple[str, str], ...], int]:
    """Scan ``{name="value",...}`` starting at ``line[pos] == '{'``;
    returns the (name, unescaped value) pairs in document order plus the
    index just past the closing brace."""
    assert line[pos] == "{"
    pos += 1
    pairs: list[tuple[str, str]] = []
    while True:
        if pos < len(line) and line[pos] == "}":
            return tuple(pairs), pos + 1
        eq = line.find("=", pos)
        if eq < 0 or eq + 1 >= len(line) or line[eq + 1] != '"':
            raise ValueError(f"malformed labels in sample line {line!r}")
        name = line[pos:eq]
        if not _NAME_OK.match(name):
            raise ValueError(f"bad label name {name!r} in {line!r}")
        # Scan the quoted value honouring backslash escapes.
        i = eq + 2
        raw: list[str] = []
        while True:
            if i >= len(line):
                raise ValueError(f"unterminated label value in {line!r}")
            ch = line[i]
            if ch == "\\":
                if i + 1 >= len(line):
                    raise ValueError(f"dangling backslash in {line!r}")
                raw.append(line[i:i + 2])
                i += 2
                continue
            if ch == '"':
                break
            raw.append(ch)
            i += 1
        pairs.append((name, unescape_label_value("".join(raw))))
        pos = i + 1
        if pos < len(line) and line[pos] == ",":
            pos += 1
        elif pos < len(line) and line[pos] == "}":
            return tuple(pairs), pos + 1
        else:
            raise ValueError(f"malformed labels in sample line {line!r}")


def _parse_sample(line: str) -> tuple[str, tuple[tuple[str, str], ...], str]:
    """One sample line -> (sample name, label pairs, raw value text).

    The value is kept verbatim (including any trailing timestamp) so a
    re-render is byte-identical."""
    brace = line.find("{")
    space = line.find(" ")
    if brace >= 0 and (space < 0 or brace < space):
        name = line[:brace]
        labels, pos = _parse_labels(line, brace)
        if pos >= len(line) or line[pos] != " ":
            raise ValueError(f"missing value in sample line {line!r}")
        value = line[pos + 1:]
    else:
        if space < 0:
            raise ValueError(f"missing value in sample line {line!r}")
        name = line[:space]
        labels = ()
        value = line[space + 1:]
    if not _NAME_OK.match(name):
        raise ValueError(f"bad metric name {name!r} in {line!r}")
    if not value:
        raise ValueError(f"empty value in sample line {line!r}")
    return name, labels, value


def parse_prometheus(text: str) -> list[dict]:
    """Parse one exposition document into family dicts, in document
    order: ``{"name", "type" (str|None), "help" (str|None), "samples":
    [(sample_name, ((label, value), ...), raw_value_str), ...]}``.

    Histogram child samples (``_bucket``/``_sum``/``_count``) attach to
    their base family; a sample with no preceding HELP/TYPE gets an
    untyped family of its own (render_parsed then emits no comment
    lines for it). Malformed lines raise ``ValueError``.
    """
    families: list[dict] = []
    by_name: dict[str, dict] = {}
    cur: Optional[dict] = None

    def _new(name: str, mtype: Optional[str], help_text: Optional[str]) -> dict:
        fam = {"name": name, "type": mtype, "help": help_text, "samples": []}
        families.append(fam)
        by_name[name] = fam
        return fam

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            cur = _new(name, None, help_text)
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[len("# TYPE "):].partition(" ")
            mtype = mtype.strip()
            if cur is not None and cur["name"] == name and cur["type"] is None:
                cur["type"] = mtype
            else:
                cur = _new(name, mtype, None)
            continue
        if line.startswith("#"):
            continue  # free comment — legal, carries nothing
        name, labels, value = _parse_sample(line)
        fam = None
        for suffix in _HIST_SUFFIXES:
            if name.endswith(suffix):
                base = by_name.get(name[:-len(suffix)])
                if base is not None and base["type"] == "histogram":
                    fam = base
                    break
        if fam is None:
            fam = by_name.get(name)
        if fam is None:
            fam = _new(name, None, None)
        fam["samples"].append((name, labels, value))
    return families


def render_parsed(families: list[dict]) -> str:
    """Render :func:`parse_prometheus` output back to exposition text —
    the byte-exact inverse on documents this module produced."""
    out: list[str] = []
    for fam in families:
        if fam.get("help") is not None:
            out.append(f"# HELP {fam['name']} {fam['help']}")
        if fam.get("type") is not None:
            out.append(f"# TYPE {fam['name']} {fam['type']}")
        for name, labels, value in fam["samples"]:
            lbl = _labels_str(
                tuple(k for k, _ in labels), tuple(v for _, v in labels)
            )
            out.append(f"{name}{lbl} {value}")
    return "\n".join(out) + "\n"
