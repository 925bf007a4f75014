"""Chrome trace-event export: merged distributed traces → Perfetto.

Converts node-stamped, clock-corrected span dicts (the
``TraceCollector.merged_spans()`` shape) into the Chrome trace-event
JSON format that Perfetto and ``chrome://tracing`` load natively:

- one **process (pid) per node**, named by the node id via
  ``process_name`` metadata — so the UI shows one track group per node;
- one **thread (tid) per trace** inside each process, named by the
  trace id — concurrent messages stack into separate rows instead of
  nesting incorrectly;
- one complete slice (``ph: "X"``) per span, with the trace id and the
  span's attrs/error in ``args``.

Timestamps are microseconds relative to the earliest span in the
export (Chrome's viewers render absolute epoch-microsecond values
poorly), with the chosen origin recorded in ``otherData``.
"""

from __future__ import annotations

import json
from typing import Optional

__all__ = ["to_chrome_trace", "write_chrome_trace"]


def to_chrome_trace(
    spans: list[dict], *, time_origin: Optional[float] = None
) -> dict:
    """Build the trace-event document for ``spans`` (merged span dicts:
    each carries ``node``, ``trace_id``, ``name``, ``start`` [epoch
    seconds], ``seconds``). Returns the JSON-serializable dict."""
    events: list[dict] = []
    if time_origin is None:
        time_origin = min(
            (float(s.get("start", 0.0)) for s in spans), default=0.0
        )
    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    for s in sorted(spans, key=lambda d: float(d.get("start", 0.0))):
        node = str(s.get("node", "") or "unknown")
        pid = pids.get(node)
        if pid is None:
            pid = pids[node] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": node},
            })
        trace_id = str(s.get("trace_id", "") or "untraced")
        tid = tids.get((pid, trace_id))
        if tid is None:
            tid = tids[(pid, trace_id)] = (
                sum(1 for p, _ in tids if p == pid) + 1
            )
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"trace {trace_id}"},
            })
        args = {"trace_id": trace_id}
        if s.get("attrs"):
            args.update(s["attrs"])
        if s.get("error"):
            args["error"] = s["error"]
        events.append({
            "name": str(s.get("name", "span")),
            "cat": "pipeline",
            "ph": "X",
            "pid": pid,
            "tid": tid,
            "ts": (float(s.get("start", 0.0)) - time_origin) * 1e6,
            "dur": max(0.0, float(s.get("seconds", 0.0))) * 1e6,
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "time_origin_unix_seconds": time_origin,
            "nodes": sorted(pids),
        },
    }


def write_chrome_trace(path: str, spans: list[dict]) -> dict:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the
    document (callers log slice/node counts from it)."""
    doc = to_chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    return doc
