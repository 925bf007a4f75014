"""Background scrubber: walk stripes, verify parity in device batches,
feed the repair queue.

A scrub cycle snapshots the store's keys and, for every stripe:

- flags missing shards (holes and unverified wire absorbs) straight into
  the repair queue with the classified kind;
- for fully-trusted stripes, runs the parity verify BATCHED: same-shape
  stripes (geometry, field, shard length) are stacked along the stripe
  axis into one ``(k, B*S)`` matrix and checked with a single
  generator-submatrix multiply through the codec's device dispatch
  (``ReedSolomon._mul`` → ``ops/dispatch`` on the device backend) — B
  verifies for the price of one kernel launch. Mismatching stripes are
  flagged ``verify_failed`` for the engine's error-correcting restore.

Findings are counted once per state change (a hole re-seen on the next
cycle does not re-count), so the counters measure rot discovered, not
scan frequency. The walk rate is configurable two ways: the interval
between cycles and an optional stripes/second throttle inside a cycle.

Run as a daemon thread (:meth:`start`) or drive :meth:`run_cycle`
directly (tests, bench).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import node_attrs, span
from noise_ec_tpu_torch.store.stripe import StripeStore, UnknownStripeError

__all__ = ["Scrubber"]

log = logging.getLogger("noise_ec_tpu_torch.store")


class Scrubber:
    """Periodic stripe health walk over one :class:`StripeStore`."""

    def __init__(
        self,
        store: StripeStore,
        engine,
        *,
        interval_seconds: float = 30.0,
        verify_batch: int = 32,
        rate_stripes_per_second: float = 0.0,
    ):
        self.store = store
        self.engine = engine
        self.interval_seconds = interval_seconds
        self.verify_batch = max(1, verify_batch)
        self.rate_stripes_per_second = rate_stripes_per_second
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # key -> (missing tuple, verify_ok) at last flag, so repeated
        # cycles do not re-count unrepaired findings.
        self._seen: dict[str, tuple] = {}
        reg = default_registry()
        self._cycles = reg.counter("noise_ec_store_scrub_cycles_total").labels()
        self._scrubbed = reg.counter(
            "noise_ec_store_scrubbed_stripes_total"
        ).labels()
        self._missing = reg.counter(
            "noise_ec_store_missing_shards_total"
        ).labels()
        self._verify_failures = reg.counter(
            "noise_ec_store_verify_failures_total"
        ).labels()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="noise-ec-scrub", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        from noise_ec_tpu_torch.ops.coalesce import qos_lane

        # The scrub thread's verify dispatches ride the device gate's
        # background lane: they yield to live traffic (up to the gate's
        # starvation floor) instead of racing it for slots.
        with qos_lane("background", tenant="scrub"):
            while not self._closed:
                try:
                    self.run_cycle()
                except Exception as exc:  # noqa: BLE001 — keep scrubbing
                    log.error("scrub cycle failed: %s", exc)
                self._wake.wait(self.interval_seconds)
                self._wake.clear()

    # -------------------------------------------------------------- cycle

    def run_cycle(self) -> dict:
        """One full walk; returns {scrubbed, flagged_missing,
        flagged_corrupt} for callers that drive cycles directly."""
        t0 = time.monotonic()
        keys = self.store.keys()
        stats = {"scrubbed": 0, "flagged_missing": 0, "flagged_corrupt": 0}
        # Same-shape fully-trusted stripes batch into one verify dispatch.
        verify_groups: dict[tuple, list[tuple[str, list]]] = {}
        # Scrub traces are usually anonymous (no message key), so the
        # node identity rides as a span attr — after a fleet-wide merge
        # the background work still attributes to the node that did it.
        with span("scrub", stripes=len(keys), **node_attrs()):
            for key in keys:
                try:
                    meta, shards, unverified = self.store.snapshot(key)
                except UnknownStripeError:
                    continue
                stats["scrubbed"] += 1
                missing = tuple(
                    i for i, s in enumerate(shards)
                    if s is None or i in unverified
                )
                if missing:
                    prev = self._seen.get(key)
                    if prev is None or prev[0] != missing:
                        new = missing if prev is None else tuple(
                            i for i in missing if i not in prev[0]
                        )
                        if new:
                            self._missing.add(len(new))
                        stats["flagged_missing"] += 1
                        self._seen[key] = (missing, True)
                    self.engine.enqueue_auto(key)
                else:
                    gkey = (
                        meta.k, meta.n, meta.field, meta.shard_len,
                        meta.code,
                    )
                    verify_groups.setdefault(gkey, []).append((key, shards))
                self._throttle(t0, stats["scrubbed"])
            for gkey, members in verify_groups.items():
                for lo in range(0, len(members), self.verify_batch):
                    self._verify_batch(gkey, members[lo : lo + self.verify_batch],
                                       stats)
        self._cycles.add(1)
        self._scrubbed.add(stats["scrubbed"])
        # Drop tracking for evicted stripes so _seen stays bounded.
        live = set(keys)
        for key in [k for k in self._seen if k not in live]:
            del self._seen[key]
        return stats

    def _throttle(self, t0: float, processed: int) -> None:
        if self.rate_stripes_per_second <= 0:
            return
        budget = processed / self.rate_stripes_per_second
        elapsed = time.monotonic() - t0
        if budget > elapsed:
            time.sleep(min(budget - elapsed, 1.0))

    def _verify_batch(self, gkey: tuple, members: list, stats: dict) -> None:
        """One batched parity check for B same-shape stripes: stack the
        data shards along the stripe axis and run a single (r, k) x
        (k, B*S) multiply on the store codec's backend (the r rows of an
        LRC generator cover its local AND global parities, so one
        multiply verifies both tiers)."""
        k, n, fieldname, shard_len, code = gkey
        rs = self.store.codec(k, n, fieldname, code)
        if rs.r == 0:
            ok = [True] * len(members)
        else:
            dt = np.dtype("<u2") if fieldname == "gf65536" else np.dtype(
                np.uint8
            )
            S = shard_len // dt.itemsize
            D = np.hstack([
                np.stack([
                    np.frombuffer(shards[i], dtype=np.uint8).view(dt)
                    for i in range(k)
                ])
                for _, shards in members
            ])
            want = np.asarray(rs._mul(rs.G[k:], D))
            ok = []
            for b, (_, shards) in enumerate(members):
                have = np.stack([
                    np.frombuffer(shards[i], dtype=np.uint8).view(dt)
                    for i in range(k, n)
                ])
                ok.append(
                    bool(np.array_equal(want[:, b * S : (b + 1) * S], have))
                )
        for good, (key, _) in zip(ok, members):
            if good:
                self._seen.pop(key, None)
                continue
            prev = self._seen.get(key)
            if prev is None or prev[1]:
                self._verify_failures.add(1)
                stats["flagged_corrupt"] += 1
                self._seen[key] = ((), False)
                event("scrub.corrupt", "error", key=key[:16])
            self.engine.enqueue(key, "verify_failed")
