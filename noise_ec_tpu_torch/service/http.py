"""HTTP surface of the object service: PUT / GET / range-GET / DELETE /
LIST mounted onto the stats server's route table.

The API lives alongside ``/metrics`` and ``/healthz`` on the same stdlib
``StatsServer`` (obs/server.py) — :meth:`ObjectAPI.mount` registers the
``/objects`` tree through the server's route registration table, no
dispatch chain edits needed. Endpoints (docs/object-service.md):

- ``PUT /objects/<tenant>/<name>`` — streamed upload (body consumed in
  O(stripe) memory). 201 + manifest summary JSON; 413 on quota, 403 on
  an unknown tenant under closed admission, **503 + Retry-After** when
  admission control sheds (SLO degraded / HBM watermark) — the PUT is
  refused before any stripe is encoded.
- ``GET /objects/<tenant>/<name>`` — the object bytes; honors
  ``Range: bytes=a-b`` / ``bytes=a-`` / ``bytes=-n`` with 206 +
  ``Content-Range`` (416 when unsatisfiable). Served through the tiered
  read path (decoded cache → local join → warm peer → degraded decode,
  docs/object-service.md "Read path"); a stripe below k waits on the
  anti-entropy fetch and 503s if peers cannot heal it in time. ``ETag``
  is the object's content address. A request carrying
  ``X-NoiseEC-Route: direct`` (a warm-peer fetch from another node) is
  served from local tiers only — peer routing never recurses. When the
  node is degraded (SLO/HBM), a GET that cannot be served entirely from
  the warm cache sheds **503 + Retry-After** like a PUT.
- ``DELETE /objects/<tenant>/<name>`` — 204; local delete (see
  service/objects.py on replica semantics).
- ``GET /objects/<tenant>`` — cursored LIST
  (``?cursor=<addr>&limit=<n>``) returning ``{"objects": [...],
  "next_cursor": ...}``.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Optional
from urllib.parse import unquote

from noise_ec_tpu_torch.obs.trace import request as trace_request
from noise_ec_tpu_torch.service.objects import (
    ObjectStore,
    ObjectUnavailableError,
    ShedError,
    UnknownObjectError,
)
from noise_ec_tpu_torch.service.tenants import (
    QuotaExceededError,
    UnknownTenantError,
)

__all__ = ["ObjectAPI"]

_RANGE_RE = re.compile(r"^bytes=(\d*)-(\d*)$")


def _json(status: int, doc: dict, headers: Optional[dict] = None) -> tuple:
    return status, "application/json", (
        json.dumps(doc, indent=1).encode() + b"\n"
    ), (headers or {})


class ObjectAPI:
    """Route handlers over one :class:`ObjectStore` (module docstring)."""

    def __init__(self, objects: ObjectStore):
        self.objects = objects

    def mount(self, server) -> None:
        """Register the /objects tree on a :class:`~noise_ec_tpu_torch.obs.
        server.StatsServer` (or anything with the same ``mount``)."""
        server.mount("GET", "/objects", self._get, prefix=True)
        server.mount("PUT", "/objects/", self._put, prefix=True, stream=True)
        server.mount("DELETE", "/objects/", self._delete, prefix=True)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _segments(path: str) -> list[str]:
        rest = path[len("/objects"):]
        return [unquote(s) for s in rest.split("/") if s]

    # ------------------------------------------------------------- routes

    def _put(self, req: dict) -> tuple:
        seg = self._segments(req["path"])
        if len(seg) != 2:
            return _json(400, {"error": "expected /objects/<tenant>/<name>"})
        tenant, name = seg
        length = req["length"]
        if length <= 0:
            return _json(400, {"error": "missing or empty body "
                                        "(Content-Length required)"})
        rfile = req["rfile"]

        def chunks():
            remaining = length
            while remaining > 0:
                blk = rfile.read(min(1 << 20, remaining))
                if not blk:
                    return
                remaining -= len(blk)
                yield blk

        try:
            # Adopt a propagated trace id (X-NoiseEC-Trace) so a routed
            # PUT joins the originator's request trace; shed/quota
            # refusals raise through the scope and are kept as error
            # traces by the tail sampler.
            with trace_request(
                "put", trace_id=req["headers"].get("X-NoiseEC-Trace"),
                route="http",
            ):
                doc = self.objects.put_stream(
                    tenant, name, chunks(), length
                )
        except ShedError as exc:
            return _json(
                503,
                {"error": str(exc), "shed": exc.reason},
                {"Retry-After": f"{exc.retry_after:g}"},
            )
        except QuotaExceededError as exc:
            return _json(413, {"error": str(exc), "reason": exc.reason})
        except UnknownTenantError:
            return _json(403, {"error": f"unknown tenant {tenant!r}"})
        except ValueError as exc:
            return _json(400, {"error": str(exc)})
        return _json(201, {
            "address": doc["address"],
            "tenant": doc["tenant"],
            "name": doc["name"],
            "size": doc["size"],
            "stripes": len(doc["stripes"]),
            "k": doc["k"],
            "n": doc["n"],
        }, {"ETag": f'"{doc["address"]}"'})

    def _get(self, req: dict) -> tuple:
        seg = self._segments(req["path"])
        if len(seg) == 1:
            return self._list(req, seg[0])
        if len(seg) != 2:
            return _json(400, {"error": "expected /objects/<tenant>[/<name>]"})
        tenant, name = seg
        try:
            doc = self.objects.resolve(tenant, name)
        except UnknownObjectError:
            return _json(404, {"error": f"no object {tenant}/{name}"})
        size = int(doc["size"])
        start, length, ranged = 0, None, False
        range_header = req["headers"].get("Range")
        if range_header:
            parsed = self._parse_range(range_header, size)
            if parsed is None:
                return _json(
                    416, {"error": f"unsatisfiable range {range_header!r}"},
                    {"Content-Range": f"bytes */{size}"},
                )
            start, length, ranged = parsed
        # A warm-peer fetch from another node: serve local tiers only,
        # so peer routing is a single hop by construction.
        direct = req["headers"].get("X-NoiseEC-Route") == "direct"
        # The request scope must outlive this handler frame (the body
        # streams after we return), so it is entered manually here and
        # closed by finish() — on any error return below, or when the
        # streamed body is exhausted/abandoned. A propagated
        # X-NoiseEC-Trace id (a warm-peer routed fetch) is adopted so
        # the serving node's tier spans merge into the originator's
        # trace; the object layer's own scope joins this one.
        attrs = {"route": "http"}
        if req["headers"].get("X-NoiseEC-Hedge"):
            # This serving leg is one arm of a hedged race on the
            # requesting node — stamped so a fleet-wide trace shows
            # which legs were hedges (and which lost).
            attrs["hedge"] = 1
        rscope = trace_request(
            "get", trace_id=req["headers"].get("X-NoiseEC-Trace"),
            **attrs,
        )
        rscope.__enter__()
        done = [False]

        def finish(exc: Optional[BaseException] = None) -> None:
            if not done[0]:
                done[0] = True
                rscope.__exit__(
                    type(exc) if exc is not None else None, exc, None
                )

        try:
            doc, total, chunks = self.objects.get_range(
                tenant, name, start, length, peer_route=not direct
            )
            # Pull the first chunk EAGERLY: stripe-unavailable is by far
            # the likeliest failure and must surface as a status code,
            # not a broken stream after the 200 went out.
            try:
                first = next(chunks)
            except StopIteration:
                first = b""
        except ShedError as exc:
            finish(exc)
            return _json(
                503,
                {"error": str(exc), "shed": exc.reason},
                {"Retry-After": f"{exc.retry_after:g}"},
            )
        except ObjectUnavailableError as exc:
            finish(exc)
            return _json(503, {"error": str(exc)},
                         {"Retry-After": "2"})
        except ValueError as exc:
            finish(exc)
            return _json(416, {"error": str(exc)},
                         {"Content-Range": f"bytes */{size}"})
        except BaseException as exc:
            finish(exc)
            raise

        def body():
            try:
                yield first
                yield from chunks
            finally:
                finish(sys.exc_info()[1])

        headers = {
            "Content-Length": str(total),
            "Accept-Ranges": "bytes",
            "ETag": f'"{doc["address"]}"',
        }
        status = 200
        if ranged:
            status = 206
            headers["Content-Range"] = (
                f"bytes {start}-{start + total - 1}/{size}"
            )
        return status, "application/octet-stream", body(), headers

    def _list(self, req: dict, tenant: str) -> tuple:
        q = req["query"]
        cursor = q.get("cursor", [None])[0]
        try:
            limit = max(1, min(1024, int(q.get("limit", ["64"])[0])))
        except ValueError:
            return _json(400, {"error": "bad limit"})
        entries, next_cursor = self.objects.list_objects(
            tenant, cursor=cursor, limit=limit
        )
        return _json(200, {
            "tenant": tenant,
            "objects": entries,
            "next_cursor": next_cursor,
        })

    def _delete(self, req: dict) -> tuple:
        seg = self._segments(req["path"])
        if len(seg) != 2:
            return _json(400, {"error": "expected /objects/<tenant>/<name>"})
        tenant, name = seg
        try:
            with trace_request(
                "delete",
                trace_id=req["headers"].get("X-NoiseEC-Trace"),
                route="http",
            ):
                self.objects.delete(tenant, name)
        except UnknownObjectError:
            return _json(404, {"error": f"no object {tenant}/{name}"})
        return 204, "text/plain", b""

    @staticmethod
    def _parse_range(
        header: str, size: int
    ) -> Optional[tuple[int, Optional[int], bool]]:
        """``(start, length, True)`` for a satisfiable single range,
        None otherwise. Suffix ranges (``bytes=-n``) serve the last n
        bytes, RFC 9110 §14.1.2."""
        m = _RANGE_RE.match(header.strip())
        if not m:
            return None
        first, last = m.group(1), m.group(2)
        if first:
            start = int(first)
            if start >= size:
                return None
            if last:
                end = int(last)
                if end < start:
                    return None
                return start, min(end, size - 1) - start + 1, True
            return start, None, True
        if not last:
            return None
        suffix = int(last)
        if suffix <= 0:
            return None
        start = max(0, size - suffix)
        return start, None, True
