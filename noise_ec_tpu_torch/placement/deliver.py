"""Targeted shard delivery + the owner-side gather read path.

``send`` replaces a cohort's full broadcast with one signed
``SHARD_BATCH`` cohort frame per DESTINATION peer: the ring names each
shard's owner, shards group by owner, and each owner receives exactly
its cohort — per-message wire sends drop from peers× to n×
(``noise_ec_placement_fanout_saved_total`` counts the avoided per-peer
shard deliveries). The manifest broadcast is untouched (every node
still indexes every object); with no topology configured the plugin
falls straight back to the broadcast path, byte-identical to before.

The flip side of sending each shard to ONE owner is that no single
peer can decode a stripe locally any more — reads must gather.
``gather`` asks the live owners for their slots
(``network.placement_fetch``), reconstructs from any k, then
re-encodes and compares EVERY gathered shard against the reconstructed
codeword: a corrupt or stale shard makes the gather refuse (return
None) rather than serve wrong bytes, and the caller falls back to the
anti-entropy path. Transports without a directed fetch surface simply
never gather (``getattr`` probing, same as ``broadcast_many``).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import current_trace_id, span, trace_key

__all__ = ["TargetedDelivery"]

log = logging.getLogger("noise_ec_tpu_torch.placement")


class TargetedDelivery:
    """Ring-directed send/absorb/gather policy for one node.

    ``self_token`` is this node's own topology token (its shards are
    never self-sent — the origin already stores its full stripe)."""

    def __init__(
        self,
        ring,
        *,
        self_token: Optional[str] = None,
        hedge: bool = True,
        hedge_extra: int = 1,
        gather_timeout_seconds: float = 5.0,
    ):
        if hedge_extra < 0:
            raise ValueError(f"hedge_extra must be >= 0, got {hedge_extra}")
        self.ring = ring
        self.self_token = self_token
        # Hedged gather (docs/object-service.md "Read path"): with >= 2
        # remote owners the gather fans to the owners needed for k PLUS
        # ``hedge_extra`` next-ranked sources in parallel, decodes the
        # moment any k distinct slots arrive, and abandons the losers —
        # one straggling owner stops bounding the read's tail.
        self.hedge = hedge
        self.hedge_extra = hedge_extra
        self.gather_timeout_seconds = gather_timeout_seconds
        reg = default_registry()
        self._m_saved = reg.counter(
            "noise_ec_placement_fanout_saved_total"
        ).labels()
        # Shared hedge accounting family (service/objects.py's peer tier
        # feeds the same counters): every fan-out, hedge win, abandoned
        # loser and post-decision completion is accounted, never leaked.
        self._m_hedge_requests = reg.counter(
            "noise_ec_hedge_requests_total"
        ).labels()
        self._m_hedge_wins = reg.counter(
            "noise_ec_hedge_wins_total"
        ).labels()
        self._m_hedge_cancelled = reg.counter(
            "noise_ec_hedge_cancelled_total"
        ).labels()
        self._m_hedge_late = reg.counter(
            "noise_ec_hedge_late_total"
        ).labels()
        # Per-owner completed-fetch latency: the same family the
        # warm-peer tier feeds (ObjectMetrics.peer_fetch_seconds), so
        # the slow-peer diagnosis rule and hedge p95 triggers see
        # gather traffic too. Children cached and capped like the
        # tenant/peer label sets.
        self._peer_seconds = reg.histogram("noise_ec_peer_fetch_seconds")
        self._peer_children: dict[str, object] = {}

    PEER_LABEL_CAP = 64

    def _observe_fetch(self, token: str, seconds: float) -> None:
        """Observe one COMPLETED owner fetch (ok/empty/late; errors and
        cancellations stay out — they would poison the p95 the hedge
        trigger and slow-peer verdict read)."""
        label = token if (
            token in self._peer_children
            or len(self._peer_children) < self.PEER_LABEL_CAP
        ) else "other"
        child = self._peer_children.get(label)
        if child is None:
            child = self._peer_children[label] = self._peer_seconds.labels(
                peer=label
            )
        child.observe(seconds)

    # -------------------------------------------------------------- send

    def send(self, network, shards) -> Optional[dict]:
        """Targeted cohort send; returns delivery stats, or None when
        the transport lacks the directed surface / nothing could be
        placed (the caller then falls back to full broadcast)."""
        directory_fn = getattr(network, "placement_directory", None)
        send_many = getattr(network, "send_many_to", None)
        if directory_fn is None or send_many is None:
            return None
        directory = directory_fn()
        if not directory:
            return None
        shards = list(shards)
        if not shards:
            return None
        n = int(shards[0].total_shards)
        k = int(shards[0].minimum_needed_shards)
        key = trace_key(shards[0].file_signature)
        alive = set(directory)
        if self.self_token is not None:
            alive.add(self.self_token)
        owners = self.ring.owners(key, n, k=k, alive=alive)
        cohorts: dict[str, list] = {}
        skipped = 0
        for shard in shards:
            owner = owners[int(shard.shard_number)]
            if owner is None or owner == self.self_token:
                skipped += 1
                continue
            cohorts.setdefault(owner, []).append(shard)
        sent = 0
        rt = current_trace_id()
        for token, group in cohorts.items():
            # One span per destination cohort (PUT-side delivery leg).
            # The span joins the signature trace through its ancestor
            # chain; ``request_trace`` keys it to the user request so a
            # collector can merge the delivery into the PUT's trace.
            attrs = {"peer": token, "shards": len(group)}
            if rt is not None:
                attrs["request_trace"] = rt
            with span("placement_send", **attrs) as sp:
                if send_many(directory[token], group):
                    sent += len(group)
                    sp.set_attr(outcome="ok")
                else:
                    skipped += len(group)
                    sp.set_attr(outcome="refused")
        # What a broadcast would have cost: every shard to every
        # directory peer. The saved delta is the wire win the fanout
        # acceptance test and the bench's placement_fanout_ratio gate.
        self._m_saved.add(max(0, len(shards) * len(directory) - sent))
        return {"sent": sent, "dests": len(cohorts), "skipped": skipped}

    # ------------------------------------------------------------- absorb

    def absorbs(self, msg) -> bool:
        """Receive-side gate: should this node store-absorb ``msg`` as a
        targeted placement shard? True when this node lives in the
        slot's ASSIGNED failure domain (liveness-blind: any domain
        member may hold the slot — re-homed rebalance copies included —
        which keeps the domain invariant while selection inside the
        domain stays best-effort)."""
        if self.self_token is None:
            return False
        my_domain = self.ring.topology.domain_of(self.self_token)
        if my_domain is None:
            return False
        key = trace_key(msg.file_signature)
        n = int(msg.total_shards)
        slot = int(msg.shard_number)
        if not 0 <= slot < n:
            return False
        domains = self.ring.owner_domains(key, n)
        return domains[slot] == my_domain

    # ------------------------------------------------------------- gather

    def gather(
        self,
        store,
        network,
        key: str,
        *,
        k: int,
        n: int,
        field: str = "gf256",
        code: str = "rs",
    ) -> Optional[bytes]:
        """Reconstruct one stripe's padded payload from the live owners'
        slots (module docstring). Returns the ``k * shard_len`` padded
        bytes, or None when fewer than k consistent shards could be
        gathered."""
        directory_fn = getattr(network, "placement_directory", None)
        fetch = getattr(network, "placement_fetch", None)
        if directory_fn is None or fetch is None:
            return None
        directory = directory_fn()
        if not directory:
            return None
        collected: dict[int, bytes] = {}
        # Local slots first (an owner gathering its own stripe, or a
        # partially-absorbed one, starts from what it already holds).
        try:
            _, local_shards, _ = store.snapshot(key)
            for num, blob in enumerate(local_shards):
                if blob is not None:
                    collected[num] = blob
        # noise-ec: allow(event-on-swallow) — a stripe not held locally is the norm, not a failure
        except Exception:  # noqa: BLE001 — not held locally is the norm
            pass
        alive = set(directory)
        if self.self_token is not None:
            alive.add(self.self_token)
        # Ranked remote sources: ring-owner order (the ring already
        # prefers live, domain-diverse owners), deduped — one owner may
        # hold several of the stripe's slots and is asked once.
        candidates = [
            token
            for token in dict.fromkeys(
                self.ring.owners(key, n, k=k, alive=alive)
            )
            if token is not None
            and token != self.self_token
            and token in directory
        ]
        if candidates and len(collected) < k:
            if self.hedge and len(candidates) >= 2:
                self._gather_parallel(
                    fetch, directory, key, n, k, candidates, collected
                )
            else:
                self._gather_serial(
                    fetch, directory, key, n, candidates, collected
                )
        if len(collected) < k:
            return None
        shard_lens = {len(b) for b in collected.values()}
        return self._decode_gathered(store, key, k, n, field, code,
                                     collected, shard_lens)

    def _gather_serial(
        self, fetch, directory, key: str, n: int,
        candidates: list, collected: dict,
    ) -> None:
        """The pre-hedge sequential gather (hedging disabled, or a
        single remote owner): ask each owner in rank order."""
        for token in candidates:
            # One span per owner fetch: peer id + outcome + bytes, so a
            # straggling owner is visible in the GET's critical path.
            with span("gather_fetch", peer=token) as sp:
                t0 = time.monotonic()
                try:
                    got = fetch(directory[token], key)
                except Exception as exc:  # noqa: BLE001 — a dead owner
                    # degrades the gather, never breaks the read
                    sp.set_attr(outcome="error", bytes=0)
                    log.debug("placement fetch from %s failed: %s",
                              token, exc)
                    continue
                self._observe_fetch(token, time.monotonic() - t0)
                if not got:
                    sp.set_attr(outcome="empty", bytes=0)
                    continue
                nbytes = 0
                for num, blob in got.items():
                    if 0 <= int(num) < n and blob is not None:
                        nbytes += len(blob)
                        collected.setdefault(int(num), bytes(blob))
                sp.set_attr(outcome="ok", bytes=nbytes, shards=len(got))

    def _gather_parallel(
        self, fetch, directory, key: str, n: int, k: int,
        candidates: list, collected: dict,
    ) -> None:
        """The hedged k+Δ gather fan-out (constructor comment): launch
        the owners needed to reach k plus ``hedge_extra`` hedges in
        parallel, merge slots under one condition variable, and stop the
        moment ``collected`` holds k distinct slots. A concluded failure
        promotes the next ranked owner (keeping the fan width), and the
        decision point abandons the in-flight losers — their eventual
        results are dropped and accounted (cancelled/late), never
        merged, so a decode never mixes in post-decision bytes."""
        import threading

        self._m_hedge_requests.add(1)
        cond = threading.Condition()
        state = {"live": 0, "decided": False}
        attempts: list[dict] = []
        needed = max(1, k - len(collected))
        fan = min(len(candidates), needed + self.hedge_extra)

        def run(att: dict) -> None:
            token = att["token"]
            with span(
                "gather_fetch", peer=token, hedge=int(att["rank"] >= needed)
            ) as sp:
                got = None
                outcome = "error"
                nbytes = 0
                win = False
                t0 = time.monotonic()
                try:
                    got = fetch(directory[token], key)
                    outcome = "ok" if got else "empty"
                except Exception as exc:  # noqa: BLE001 — a dead owner
                    # degrades the gather, never breaks the read
                    log.debug("placement fetch from %s failed: %s",
                              token, exc)
                elapsed = time.monotonic() - t0
                # Only plain state mutates under the condition —
                # metrics land after release (lock-order hygiene: the
                # registry families have their own locks).
                with cond:
                    att["live"] = False
                    state["live"] -= 1
                    if att["cancel"]:
                        # The decision point already counted this
                        # attempt as cancelled; drop its result.
                        outcome = "cancelled"
                    elif state["decided"]:
                        if outcome == "ok":
                            outcome = "late"
                    elif outcome == "ok":
                        for num, blob in got.items():
                            if 0 <= int(num) < n and blob is not None:
                                nbytes += len(blob)
                                collected.setdefault(int(num), bytes(blob))
                        if att["rank"] >= needed and len(collected) >= k:
                            # A hedge source completed the k-set: the
                            # fan-out beat a straggling primary owner.
                            win = True
                    cond.notify_all()
                if outcome != "error":
                    # Unlike the warm-peer tier (whose cancel closes
                    # the connection mid-flight), a gather fetch always
                    # runs to completion — cancel only discards the
                    # result — so the elapsed time is a real per-owner
                    # RPC latency either way. Observing it keeps the
                    # slow owner the hedge outran visible in the
                    # distribution the p95 trigger and the slow-peer
                    # verdict read.
                    self._observe_fetch(token, elapsed)
                if outcome == "late":
                    self._m_hedge_late.add(1)
                if outcome == "late" or (
                    outcome == "cancelled" and got is not None
                ):
                    # "A cancelled leg's reply arrived anyway" — the
                    # wide event that lets the diagnosis engine pin a
                    # straggler by name.
                    event("hedge.late", "warn", peer=token,
                          elapsed_ms=round(elapsed * 1e3, 3))
                if win:
                    self._m_hedge_wins.add(1)
                    event("hedge.win", peer=token,
                          elapsed_ms=round(elapsed * 1e3, 3))
                sp.set_attr(
                    outcome=outcome, bytes=nbytes,
                    shards=len(got) if got else 0,
                )

        next_rank = 0

        def fill() -> None:
            """Launch until the fan is full (or sources/need run out).
            Threads start OUTSIDE the condition: Thread.start() blocks
            on its own started-event, and holding the gather lock
            across that handshake is a lock-order edge the lockgraph
            harness (rightly) rejects."""
            nonlocal next_rank
            while True:
                with cond:
                    if (
                        next_rank >= len(candidates)
                        or state["live"] >= fan
                        or len(collected) >= k
                        or state["decided"]
                    ):
                        return
                    att = {
                        "token": candidates[next_rank], "rank": next_rank,
                        "cancel": False, "live": True,
                    }
                    attempts.append(att)
                    state["live"] += 1
                    next_rank += 1
                threading.Thread(
                    target=run, args=(att,),
                    name="noise-ec-gather", daemon=True,
                ).start()

        deadline = time.monotonic() + self.gather_timeout_seconds
        while True:
            # Top up the fan: a concluded failure hands its slot to the
            # next ranked owner (the serial ladder's promotion, without
            # giving up the parallelism).
            fill()
            with cond:
                if len(collected) >= k:
                    break
                if state["live"] == 0 and next_rank >= len(candidates):
                    break  # sources exhausted
                now = time.monotonic()
                if now >= deadline:
                    break
                cond.wait(min(0.25, deadline - now))
        cancelled = 0
        with cond:
            state["decided"] = True
            for att in attempts:
                if att["live"] and not att["cancel"]:
                    att["cancel"] = True
                    cancelled += 1
        if cancelled:
            self._m_hedge_cancelled.add(cancelled)
            event("hedge.cancel", losers=cancelled)

    def _decode_gathered(
        self, store, key: str, k: int, n: int, field: str, code: str,
        collected: dict, shard_lens: set,
    ) -> Optional[bytes]:
        if len(shard_lens) != 1:
            return None  # inconsistent cohort: refuse
        rs = store.codec(k, n, field, code)
        usable = [collected.get(i) for i in range(n)]
        try:
            full = rs.reconstruct_data(usable)
        except Exception as exc:  # noqa: BLE001 — decode failure =
            # gathered set was not a consistent codeword
            log.debug("placement gather decode of %s failed: %s", key, exc)
            return None
        # End-to-end consistency: the reconstructed data must re-encode
        # to a codeword agreeing with EVERY gathered shard. Unverified
        # owner-absorbed slots are only served once they pass this.
        try:
            import numpy as np

            encoded = [
                np.ascontiguousarray(s).view(np.uint8).tobytes()
                for s in rs.encode(full[:k])
            ]
        except Exception as exc:  # noqa: BLE001
            log.debug("placement gather re-encode of %s failed: %s",
                      key, exc)
            return None
        for num, blob in collected.items():
            if encoded[num] != blob:
                log.warning(
                    "placement gather of %s: shard %d inconsistent with "
                    "reconstructed codeword; refusing", key, num,
                )
                return None
        return b"".join(encoded[:k])
