"""The fleet lab: hundreds–thousands of lightweight in-process peers.

A :class:`FleetLab` is the load/chaos harness the ROADMAP's
"fleet-scale scenario harness" item calls for: every peer is a REAL
:class:`~noise_ec_tpu_torch.host.plugin.ShardPlugin` (the full receive state
machine: pool, decode, Berlekamp–Welch repair, Ed25519 verify, stripe
store, SLO evaluator) behind a *network-shaped* shim — no subprocess,
no socket, no event loop per node. What scale costs is concentrated in
three shared structures:

- **cheap identity** — per-peer Ed25519 keys derived from the lab seed
  (``KeyPair.from_seed``), so a thousand identities cost a thousand
  hashes + keygens and the same seed reproduces every signature;
- **bounded-degree overlay** — each peer broadcasts to a fixed, seeded
  ``fanout``-sized neighbor set (real fleets are not full meshes; a
  1000-peer full mesh would be O(P²) deliveries per message);
- **one shared dispatcher** — deliveries ride a
  :class:`~noise_ec_tpu_torch.host.transport._SerialDispatcher` keyed by
  (sender, receiver) link, exactly the TCP transport's per-sender
  ordered dispatch shape, via the BLOCKING ``submit_wait`` entry: a
  full link window makes the producer yield (backpressure), never drop.

Chaos composes per link: every directed edge gets its own seeded
:class:`~noise_ec_tpu_torch.resilience.chaos.ChaosLink` (the proxy's pure
frame pipeline), so drop/corrupt/reorder/partition faults hit the
marshaled wire bytes with the same reproducibility contract as the TCP
chaos proxy. Churn reuses the ``ChaosProfile`` ``churn@`` primitive:
each churned peer expands its own seeded kill/restart schedule
(``churn_windows(stream=peer_index)``).

Admission (fleet-wide load shedding): a sender whose local SLO verdict
is degraded sheds new chat submissions with a Retry-After hint instead
of broadcasting (``noise_ec_fleet_shed_total{reason="slo"}``); object
traffic sheds through the object service's own admission path
(:class:`~noise_ec_tpu_torch.service.objects.ShedError`). The scorer counts
shed separately from lost (fleet/score.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import struct
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np

from noise_ec_tpu_torch.fleet.profile import FleetProfile
from noise_ec_tpu_torch.fleet.score import FleetScorer
from noise_ec_tpu_torch.host.crypto import KeyPair, PeerID
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import Ctx, _SerialDispatcher
from noise_ec_tpu_torch.host.wire import Shard, WireError
from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import default_tracer
from noise_ec_tpu_torch.resilience.chaos import ChaosLink

__all__ = ["FleetLab", "FleetPeer"]

log = logging.getLogger("noise_ec_tpu_torch.fleet")

# Chat payload header: magic + u32 msg_id, then seeded filler. The
# receiver callback matches deliveries back to submissions by it; any
# verified object without the magic (object stripes, manifests) is
# simply not a scored chat message.
_HDR = b"FLT1"
_HDR_LEN = len(_HDR) + 4

# How far ahead churn schedules expand (run horizon; soaks are minutes).
CHURN_HORIZON = 3600.0


class FleetPeer:
    """One lightweight in-process node (module docstring).

    Network-shaped: exposes ``id`` / ``keys`` / ``broadcast`` — the
    slice of the transport surface ``ShardPlugin`` and the object
    service drive — so the production plugin runs unmodified."""

    def __init__(self, lab: "FleetLab", idx: int, keys: KeyPair,
                 profile: FleetProfile):
        self._lab = weakref.ref(lab)
        self.idx = idx
        self.keys = keys
        self.id = PeerID.create(f"fleet://{idx}", keys.public_key)
        self.up = True
        self.kill_times: list[float] = []
        self.neighbors: tuple[int, ...] = ()
        # Tolerant targets: a corrupted-then-BW-repaired message records
        # verify_failed AND ok, so a strict 0.99 success target would
        # shed on every transient corruption; shedding should gate on
        # SUSTAINED degradation (the scorer owns final-delivery truth).
        self.slo = SLOEvaluator(
            window_seconds=15.0, min_events=8,
            success_rate_target=lab.slo_success_target,
            p99_target_seconds=lab.p99_target_seconds,
        )
        self.store = None
        self.objects = None
        # Seeded per-call jitter stream for slow@ placement fetches.
        self._fetch_seq = itertools.count()
        if profile.needs_stores():
            from noise_ec_tpu_torch.store import StripeStore

            self.store = StripeStore(backend=lab.backend, device=lab.device)
        self.plugin = ShardPlugin(
            backend=lab.backend,
            device=lab.device,
            minimum_needed_shards=profile.k,
            total_shards=profile.n,
            on_message=self._on_message,
            store=self.store,
            slo=self.slo,
        )
        # NACK repair needs a directed transport (send_to) and its
        # broadcast rounds would multiply fleet traffic; parity plus the
        # scorer's explicit loss accounting own the loss story here.
        self.plugin.nack_grace_seconds = 0.0
        if self.store is not None:
            from noise_ec_tpu_torch.service import DecodedObjectCache, ObjectStore

            # Hot-read (get=) traffic exercises the decoded-stripe
            # cache tiers; a modest per-peer ceiling keeps a thousand
            # peers' caches bounded.
            cache = (
                DecodedObjectCache(max_bytes=8 << 20)
                if profile.get > 0 else None
            )
            self.objects = ObjectStore(
                self.store, self.plugin, self,
                stripe_bytes=profile.stripe_bytes,
                k=profile.k, n=profile.n,
                slo=self.slo,
                cache=cache,
                # A below-k stripe with no repair engine cannot heal;
                # fail reads fast instead of stalling the scorer.
                fetch_timeout_seconds=0.2,
                hedge_enabled=bool(profile.hedge),
            )

    # ---- the network surface the plugin drives

    def broadcast(self, msg: Shard) -> None:
        lab = self._lab()
        if lab is not None:
            lab.hub.fan_out(self, msg.marshal())

    # ---- placement surfaces (docs/placement.md): the directed slice a
    # TargetedDelivery probes for. Handles are peer indices; tokens are
    # the ring topology's "fleet://idx" addresses.

    def send_many_to(self, handle, msgs) -> bool:
        lab = self._lab()
        if lab is None:
            return False
        return lab.hub.send_direct(
            self, int(handle), [m.marshal() for m in msgs]
        )

    def placement_directory(self) -> dict:
        lab = self._lab()
        if lab is None:
            return {}
        return {
            f"fleet://{p.idx}": p.idx
            for p in lab.peers
            if p.up and p.idx != self.idx
        }

    def placement_fetch(self, handle, key) -> dict:
        """Owner-slot fetch for the gather read path: a direct snapshot
        of the target peer's store (the lab's stand-in for a directed
        fetch RPC). Raises for a down/storeless peer — the gather
        degrades per-owner. A ``slow@`` endpoint pays its declared link
        delay here too, so the hedged gather actually races the slow
        source (docs/fleet.md)."""
        lab = self._lab()
        if lab is None:
            raise RuntimeError("lab is gone")
        peer = lab.peers[int(handle)]
        if not peer.up or peer.store is None:
            raise RuntimeError(f"peer {handle} is down")
        delay, jitter = lab.slow_edge(self.idx, peer.idx)
        if delay or jitter:
            u = 0.0
            if jitter:
                # Seeded, call-indexed jitter keeps slow fetches
                # reproducible across runs with the same lab seed.
                draw = hashlib.blake2b(
                    struct.pack(
                        "<QIIQ", lab.seed & (2**64 - 1),
                        self.idx, peer.idx, next(self._fetch_seq),
                    ),
                    digest_size=8,
                ).digest()
                u = int.from_bytes(draw, "little") / 2.0**64
            # Same cap as the hub's _deliver: a mis-profiled delay must
            # not wedge a gather worker for seconds.
            time.sleep(min(delay + jitter * u, 0.25))
        _, shards, _ = peer.store.snapshot(key)
        return {i: b for i, b in enumerate(shards) if b is not None}

    def _on_message(self, message: bytes, sender: PeerID) -> None:
        if len(message) < _HDR_LEN or message[:4] != _HDR:
            return  # an object stripe / manifest, not a scored chat
        (msg_id,) = struct.unpack_from("<I", message, 4)
        lab = self._lab()
        if lab is not None:
            lab.scorer.deliver(msg_id, self.idx)


class FleetHub:
    """Link fabric + shared delivery dispatcher (module docstring)."""

    def __init__(self, lab: "FleetLab", workers: int, link_window: int):
        self._lab = weakref.ref(lab)
        self.dispatch = _SerialDispatcher(
            max_workers=workers, max_queue=link_window,
            on_error=lab._record_error,
        )
        self.links: dict[tuple[int, int], ChaosLink] = {}
        self.frame_errors = 0
        self.dropped = 0  # submit_wait timeouts (counted as overflow too)
        # Per-receiver wire sends (pre-chaos): broadcast fan_out and
        # directed send_direct both count, so targeted delivery's
        # peers×→n× cut reads straight off this (bench.py's
        # placement_fanout_ratio).
        self.sends = 0
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def fan_out(self, sender: FleetPeer, wire: bytes) -> None:
        """Deliver one marshaled shard to the sender's up-neighbors
        through each link's chaos pipeline. Runs on the driver thread —
        a full link window BLOCKS here (submit_wait), which is the
        transport tier of the backpressure chain."""
        lab = self._lab()
        if lab is None:
            return
        now = self.now()
        for ridx in sender.neighbors:
            receiver = lab.peers[ridx]
            if not receiver.up:
                continue
            self.sends += 1
            link = self.links[(sender.idx, ridx)]
            for buf, delay in link.admit(wire, now):
                if not self.dispatch.submit_wait(
                    struct.pack("<II", sender.idx, ridx),
                    self._deliver, receiver, buf, sender.id, delay,
                ):
                    self.dropped += 1

    def send_direct(self, sender: FleetPeer, ridx: int, wires) -> bool:
        """Directed delivery to ONE peer — the placement layer's
        targeted cohort path and the rebalancer's shard mover. Links to
        non-neighbor targets are created lazily with the SAME seeded
        chaos pipeline (conn_id keeps the (sender, receiver) derivation
        fan_out uses), so targeted traffic faces identical fault odds.
        Returns False when the receiver is down (or the lab is gone)."""
        lab = self._lab()
        if lab is None:
            return False
        receiver = lab.peers[ridx]
        if not receiver.up:
            return False
        link = self.links.get((sender.idx, ridx))
        if link is None:
            conn_id = sender.idx * len(lab.peers) + ridx
            link = self.links.setdefault(
                (sender.idx, ridx),
                ChaosLink(
                    lab.link_chaos(sender.idx, ridx),
                    lab.seed, conn_id, "a2b",
                ),
            )
        now = self.now()
        ok = True
        for wire in wires:
            self.sends += 1
            for buf, delay in link.admit(wire, now):
                if not self.dispatch.submit_wait(
                    struct.pack("<II", sender.idx, ridx),
                    self._deliver, receiver, buf, sender.id, delay,
                ):
                    self.dropped += 1
                    ok = False
        return ok

    def _deliver(self, receiver: FleetPeer, buf: bytes, sender_pid: PeerID,
                 delay: float) -> None:
        if delay > 0:
            # Link delay/bandwidth shaping; capped so a mis-profiled
            # delay cannot wedge a dispatch worker.
            time.sleep(min(delay, 0.25))
        if not receiver.up:
            return  # killed mid-flight; the scorer classifies it churned
        try:
            msg = Shard.unmarshal(buf)
        except WireError:
            self.frame_errors += 1  # corrupt-faulted frame
            return
        lab = self._lab()
        try:
            receiver.plugin.receive(Ctx(msg, sender_pid))
        except Exception as exc:  # noqa: BLE001 — isolate the fabric
            if lab is not None:
                lab._record_error(exc)

    def chaos_stats(self) -> dict:
        agg: dict[str, int] = {}
        for link in self.links.values():
            for key, val in link.stats().items():
                agg[key] = agg.get(key, 0) + val
        agg["frame_errors"] = self.frame_errors
        agg["window_timeouts"] = self.dropped
        return agg


class FleetLab:
    """Build, drive, score and report one fleet run (module docstring).

    ``backend`` and ``device`` say where each peer's plugin and store run
    their codecs; the JAX package builds every lab peer on
    ``backend="numpy"``.

    Lifecycle: ``start()`` (peers, topology, links, churn schedule) →
    ``run()`` (drive the traffic mix, wait for drain, return the scored
    report) → optionally ``write_report`` / ``write_trace`` →
    ``close()``. ``attach(stats_server)`` mounts ``GET /fleet`` and
    folds the live fleet block into ``/healthz`` details.
    """

    def __init__(
        self,
        profile: FleetProfile,
        *,
        size: Optional[int] = None,
        seed: int = 0,
        p99_target_seconds: float = 2.0,
        slo_success_target: float = 0.85,
        dispatch_workers: int = 4,
        link_window: int = 512,
        shed_retry_after: float = 2.0,
        rebalance_rate_bytes_per_s: float = 4 << 20,
        rebalance_burst_bytes: int = 8 << 20,
        backend: str = "device",
        device: str = "cuda",
    ):
        if size is not None:
            profile = dataclasses.replace(profile, peers=size)
            profile.validate()
        self.profile = profile
        self.seed = seed
        # Where every peer's plugin and store run their codecs: the card
        # by default, as every entry point of the port ("cpu" runs the
        # kernels' plain versions, backend="numpy" the host codec).
        self.backend = backend
        self.device = device
        # slow@PEER:MS[:JITTER] → {peer index: (delay_s, jitter_s)};
        # every link touching a slow peer pays the extra delay.
        self._slow = {
            int(idx): (float(d), float(j))
            for idx, d, j in profile.slow_peers
        }
        self.p99_target_seconds = p99_target_seconds
        self.slo_success_target = slo_success_target
        self.dispatch_workers = dispatch_workers
        self.link_window = link_window
        self.shed_retry_after = shed_retry_after
        self.rebalance_rate_bytes_per_s = rebalance_rate_bytes_per_s
        self.rebalance_burst_bytes = rebalance_burst_bytes
        self.peers: list[FleetPeer] = []
        self.hub: Optional[FleetHub] = None
        # Placement ring state (profile ``domains@D``; docs/placement.md):
        # one shared Topology + PlacementRing, a TargetedDelivery per
        # peer plugin, and a Rebalancer per store-carrying peer.
        self.topology = None
        self.ring = None
        self.rebalancers: dict[int, object] = {}
        self.federator = None  # built by build_federator()/attach()
        self.scorer = FleetScorer()
        self.errors: deque = deque(maxlen=256)
        self.error_count = 0
        self.last_report: Optional[dict] = None
        # Put-object ledger for the hot-read (get=) mix: zipfian GETs
        # draw from what the run has already stored.
        self._obj_lock = threading.Lock()
        self._put_objects: list[tuple[str, str, bytes]] = []
        # "missing": the reader never got the manifest (UnknownObjectError);
        # "failed": a read that resolved and then raised. The reference
        # counts both as "missing".
        self.get_results = {"ok": 0, "bad": 0, "missing": 0, "failed": 0,
                            "shed": 0}
        # The post-run verification reads (_verify_objects), by the same
        # outcomes: every expected receiver of every put object.
        self.verify_results = {"ok": 0, "bad": 0, "missing": 0, "failed": 0}
        self._churn_events: list[tuple[float, str, int]] = []
        self._churn_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False
        reg = default_registry()
        self._churn_kill = reg.counter(
            "noise_ec_fleet_churn_events_total"
        ).labels(event="kill")
        self._churn_restart = reg.counter(
            "noise_ec_fleet_churn_events_total"
        ).labels(event="restart")
        ref = weakref.ref(self)
        reg.gauge("noise_ec_fleet_peers").set_callback(
            lambda: _count_peers(ref, up=True), state="up"
        )
        reg.gauge("noise_ec_fleet_peers").set_callback(
            lambda: _count_peers(ref, up=False), state="down"
        )

    def _record_error(self, exc: Exception) -> None:
        self.errors.append(exc)
        self.error_count += 1

    # ---- slow-peer link shaping (profile ``slow@PEER:MS[:JITTER]``)

    def slow_edge(self, a_idx: int, b_idx: int) -> tuple:
        """``(delay_s, jitter_s)`` the profile's ``slow@`` entries add
        to the a↔b link — (0, 0) unless an endpoint is slow; the larger
        delay wins when both are."""
        best = (0.0, 0.0)
        for idx in (a_idx, b_idx):
            entry = self._slow.get(idx)
            if entry is not None and entry[0] >= best[0]:
                best = entry
        return best

    def link_chaos(self, a_idx: int, b_idx: int):
        """The chaos profile for the directed link a→b: the base
        profile, plus any ``slow@`` delay/jitter when either endpoint
        is a declared slow peer. Links between two fast peers share the
        unmodified base profile object."""
        delay, jitter = self.slow_edge(a_idx, b_idx)
        base = self.profile.chaos
        if not delay and not jitter:
            return base
        return dataclasses.replace(
            base, delay=base.delay + delay, jitter=base.jitter + jitter
        )

    # -------------------------------------------------------------- build

    def start(self) -> "FleetLab":
        if self._started:
            return self
        self._started = True
        prof = self.profile
        # Cheap, reproducible identities: one blake2b per peer seeds its
        # Ed25519 keypair.
        for idx in range(prof.peers):
            seed32 = hashlib.blake2b(
                b"noise-ec-fleet\0" + struct.pack("<QI", self.seed & (2**64 - 1), idx),
                digest_size=32,
            ).digest()
            self.peers.append(
                FleetPeer(self, idx, KeyPair.from_seed(seed32), prof)
            )
        if self.backend == "device":
            # Build every peer's codecs before traffic: without the card
            # this raises here (nothing falls back to the host), and
            # planning stays off the run's clock.
            for peer in self.peers:
                peer.plugin.prewarm()
                if peer.store is not None:
                    peer.store.codec(prof.k, prof.n)
        # Bounded-degree overlay: each peer draws `fanout` distinct
        # neighbors from one seeded stream.
        topo_rng = np.random.default_rng(
            np.random.SeedSequence([self.seed & 0xFFFFFFFF, 0x70B0])
        )
        for peer in self.peers:
            others = [i for i in range(prof.peers) if i != peer.idx]
            picks = topo_rng.choice(
                len(others), size=prof.fanout, replace=False
            )
            peer.neighbors = tuple(others[int(i)] for i in picks)
        self.hub = FleetHub(
            self, workers=self.dispatch_workers,
            link_window=self.link_window,
        )
        for peer in self.peers:
            for ridx in peer.neighbors:
                conn_id = peer.idx * prof.peers + ridx
                self.hub.links[(peer.idx, ridx)] = ChaosLink(
                    self.link_chaos(peer.idx, ridx),
                    self.seed, conn_id, "a2b",
                )
        if prof.domains:
            self._build_placement()
        if prof.chaos.churns:
            self._schedule_churn()
        if prof.domain_kills:
            events = list(self._churn_events)
            for at, name in prof.domain_kills:
                for token in self.topology.peers_of(name):
                    events.append(
                        (at, "kill", int(token.rsplit("//", 1)[1]))
                    )
            self._churn_events = sorted(events)
        log.info(
            "fleet lab: %d peers, fanout %d, %d links, chaos=%s%s",
            prof.peers, prof.fanout, len(self.hub.links), prof.chaos_name,
            f", churn over {len(set(i for _, _, i in self._churn_events))} "
            "peer(s)" if self._churn_events else "",
        )
        return self

    def _build_placement(self) -> None:
        """Partition the peers round-robin into the profile's failure
        domains ("d0".."d{D-1}": domain j holds peers j, j+D, ...), build
        ONE shared :class:`PlacementRing` (every node must compute the
        same maps), wire a TargetedDelivery per plugin and a Rebalancer
        per store-carrying peer, and register the per-domain
        ``noise_ec_placement_shards`` gauges."""
        from noise_ec_tpu_torch.placement import (
            PlacementRing, TargetedDelivery, Topology,
        )
        from noise_ec_tpu_torch.placement.rebalance import (
            Rebalancer, register_domain_gauges,
        )

        prof = self.profile
        domains = tuple(
            (
                f"d{j}",
                tuple(
                    f"fleet://{i}" for i in range(j, prof.peers, prof.domains)
                ),
            )
            for j in range(prof.domains)
        )
        weights = {tok: 1.0 for _, toks in domains for tok in toks}
        self.topology = Topology(domains=domains, weights=weights)
        self.ring = PlacementRing(self.topology, seed=self.seed)
        for peer in self.peers:
            token = f"fleet://{peer.idx}"
            peer.plugin.placement = TargetedDelivery(
                self.ring, self_token=token,
                hedge=bool(prof.hedge),
            )
            if peer.store is not None:
                self.rebalancers[peer.idx] = Rebalancer(
                    peer.store, self.ring,
                    self_token=token,
                    send=self._rebalance_send(peer),
                    rate_bytes_per_s=self.rebalance_rate_bytes_per_s,
                    burst_bytes=self.rebalance_burst_bytes,
                    self_public_key=peer.keys.public_key,
                )
        ref = weakref.ref(self)
        register_domain_gauges(
            lambda d: _placement_census(ref, d), self.topology.names()
        )

    def _rebalance_send(self, peer: FleetPeer):
        """The rebalancer's directed transport: topology token →
        peer index → the hub's chaos-faithful ``send_direct``."""
        ref = weakref.ref(peer)

        def send(token: str, msgs) -> bool:
            p = ref()
            if p is None or not p.up:
                return False
            return p.send_many_to(int(token.rsplit("//", 1)[1]), msgs)

        return send

    def _schedule_churn(self) -> None:
        prof = self.profile
        count = prof.churn_peers or max(1, prof.peers // 20)
        count = min(count, prof.peers)
        churn_rng = np.random.default_rng(
            np.random.SeedSequence([self.seed & 0xFFFFFFFF, 0xC0C0])
        )
        churned = churn_rng.choice(prof.peers, size=count, replace=False)
        events: list[tuple[float, str, int]] = []
        for idx in sorted(int(i) for i in churned):
            for start, down in prof.chaos.churn_windows(
                self.seed, horizon=CHURN_HORIZON, stream=idx
            ):
                events.append((start, "kill", idx))
                events.append((start + down, "restart", idx))
        self._churn_events = sorted(events)

    def _churn_run(self) -> None:
        hub = self.hub
        for t, event, idx in self._churn_events:
            delay = t - hub.now()
            if delay > 0 and self._stop.wait(delay):
                return
            peer = self.peers[idx]
            if event == "kill":
                peer.up = False
                peer.kill_times.append(time.monotonic())
                self._churn_kill.add(1)
            else:
                peer.up = True
                self._churn_restart.add(1)

    # --------------------------------------------------------------- drive

    def run(self, drain_timeout: float = 60.0) -> dict:
        """Drive the profile's traffic mix to completion, wait for the
        delivery fabric to drain, verify object GETs, and return the
        scored report."""
        if not self._started:
            self.start()
        prof = self.profile
        if self._churn_events and self._churn_thread is None:
            self._churn_thread = threading.Thread(
                target=self._churn_run, name="noise-ec-fleet-churn",
                daemon=True,
            )
            self._churn_thread.start()
        t0 = time.monotonic()
        sender_idxs = list(range(prof.peers))
        if prof.senders:
            sender_idxs = sender_idxs[: prof.senders]
        n_drivers = prof.drivers or min(4, len(sender_idxs))
        # Disjoint sender partitions keep per-link frame order owned by
        # exactly one thread — the chaos reproducibility contract.
        partitions = [sender_idxs[d::n_drivers] for d in range(n_drivers)]
        quotas = [
            prof.msgs // n_drivers + (1 if d < prof.msgs % n_drivers else 0)
            for d in range(n_drivers)
        ]
        threads = [
            threading.Thread(
                target=self._drive, name=f"noise-ec-fleet-drive-{d}",
                args=(partitions[d], quotas[d], d), daemon=True,
            )
            for d in range(n_drivers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._wait_drained(drain_timeout)
        self._verify_objects()
        duration = time.monotonic() - t0
        report = self.scorer.report(
            {p.idx: list(p.kill_times) for p in self.peers}, duration
        )
        report["peers"] = prof.peers
        report["fanout"] = prof.fanout
        report["chaos_profile"] = prof.chaos_name
        report["chaos"] = self.hub.chaos_stats()
        report["churn"] = {
            "scheduled": len(self._churn_events),
            "kills_applied": sum(len(p.kill_times) for p in self.peers),
        }
        report["errors"] = self.error_count
        report["backpressure_waits"] = _backpressure_waits()
        report["gets"] = dict(self.get_results)
        report["verify_reads"] = dict(self.verify_results)
        report["wire_sends"] = self.hub.sends
        reg = default_registry()
        report["hedge"] = {
            key: int(reg.counter(f"noise_ec_hedge_{key}_total")
                     .labels().value)
            for key in ("requests", "wins", "cancelled", "late")
        }
        if self.ring is not None:
            self.scorer.note_placement({
                "domains": self.profile.domains,
                "census": self.placement_census(),
            })
            report["placement"] = dict(self.scorer.placement)
        if self.federator is not None:
            try:
                self.federator.scrape()
                fams = self.federator.merged_families()
                report["fleet_metrics"] = {
                    "targets": len(self.federator.sources),
                    "series": sum(len(f["samples"]) for f in fams),
                }
            except Exception as exc:  # noqa: BLE001 — federation is
                # telemetry; a merge failure must not sink the report
                self._record_error(exc)
        self.last_report = report
        return report

    def _drive(self, senders: list[int], quota: int, stream: int) -> None:
        prof = self.profile
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [self.seed & 0xFFFFFFFF, 0xD21F, stream]
            )
        )
        weights = prof.weights()
        cuts = (
            weights["chat"],
            weights["chat"] + weights["object"],
            weights["chat"] + weights["object"] + weights["get"],
        )
        si = 0
        for _ in range(quota):
            peer = None
            for _ in range(len(senders)):
                cand = self.peers[senders[si % len(senders)]]
                si += 1
                if cand.up:
                    peer = cand
                    break
            if peer is None:
                continue  # every sender in this partition is down
            roll = float(rng.random())
            try:
                if roll < cuts[0] or (peer.objects is None and prof.chat > 0):
                    self.submit_chat(peer, rng)
                elif roll < cuts[1]:
                    self.submit_object(peer, rng)
                elif roll < cuts[2]:
                    self.submit_get(peer, rng)
                else:
                    self.submit_repair(peer, rng)
            except Exception as exc:  # noqa: BLE001 — one bad submission
                # must not end the driver
                self._record_error(exc)
            if prof.rate > 0:
                time.sleep(1.0 / prof.rate)

    # ---- submission kinds (public: tests drive custom patterns)

    def _expected(self, sender: FleetPeer, stores_only: bool = False) -> tuple:
        return tuple(
            r for r in sender.neighbors
            if self.peers[r].up
            and (not stores_only or self.peers[r].objects is not None)
        )

    def submit_chat(self, sender: FleetPeer, rng) -> Optional[int]:
        """One chat-sized broadcast; returns the msg_id or None when
        shed/skipped. Admission: a degraded local SLO verdict sheds the
        submission with a Retry-After hint (scored separately)."""
        if not sender.up:
            return None
        if not sender.slo.verdict()["healthy"]:
            self.scorer.shed(
                "chat", sender.idx, "slo", self.shed_retry_after
            )
            return None
        expected = self._expected(sender)
        msg_id = self.scorer.begin("chat", sender.idx, expected)
        prof = self.profile
        body = _HDR + struct.pack("<I", msg_id)
        fill = max(0, prof.chat_bytes - len(body))
        payload = body + rng.bytes(fill)
        pad = (-len(payload)) % prof.k
        payload += bytes(pad)
        sender.plugin.shard_and_broadcast(
            sender, payload, geometry=(prof.k, prof.n)
        )
        return msg_id

    def submit_object(self, sender: FleetPeer, rng) -> Optional[int]:
        """One object PUT through the service layer; the matching GETs
        are verified from every expected receiver's service after the
        run (fleet/score.py)."""
        if not sender.up or sender.objects is None:
            return None
        from noise_ec_tpu_torch.service.objects import ShedError

        prof = self.profile
        payload = rng.bytes(prof.object_bytes)
        expected = self._expected(sender, stores_only=True)
        name = f"o{sender.idx}-{int(rng.integers(0, 2**31))}"
        tenant = "fleet"
        if prof.noisy > 0:
            # noisy=M tenant mix: M noisy submissions per quiet one, so
            # the noisy share is M/(M+1). The per-tenant op histograms
            # plus the scorer's independent tenant_get samples are what
            # the QoS-isolation scenario reads back (docs/fleet.md).
            share = prof.noisy / (prof.noisy + 1.0)
            tenant = "noisy" if float(rng.random()) < share else "quiet"
        try:
            sender.objects.put(tenant, name, payload)
        except ShedError as exc:
            self.scorer.shed("object", sender.idx, exc.reason,
                             exc.retry_after)
            return None
        msg_id = self.scorer.begin("object", sender.idx, expected)
        digest = hashlib.blake2b(payload, digest_size=16).digest()
        self.scorer.add_object(msg_id, tenant, name, digest)
        with self._obj_lock:
            self._put_objects.append((tenant, name, digest))
        return msg_id

    def submit_get(self, peer: FleetPeer, rng) -> None:
        """One hot-read GET: a zipfian-popular already-put object read
        back through ``peer``'s service layer (the decoded-cache tiers;
        repeated draws of the same hot object hit the peer's cache).
        Not delivery-scored — the run ledger's byte-digest check owns
        read correctness, ``get_results`` reports the outcome mix."""
        if peer.objects is None:
            self.submit_chat(peer, rng)
            return
        with self._obj_lock:
            objs = list(self._put_objects)
        if not objs:
            self.submit_chat(peer, rng)
            return
        from noise_ec_tpu_torch.service.objects import (
            ShedError, UnknownObjectError,
        )

        # Zipf rank (s > 1) over the put ledger: rank 1 = the hottest.
        rank = int(rng.zipf(self.profile.zipf_s))
        tenant, name, digest = objs[(rank - 1) % len(objs)]
        default_registry().counter(
            "noise_ec_fleet_messages_total"
        ).labels(kind="get").add(1)
        t0 = time.monotonic()
        try:
            data = peer.objects.read(tenant, name)
        except ShedError as exc:
            self.get_results["shed"] += 1
            self.scorer.shed("get", peer.idx, exc.reason, exc.retry_after)
        except UnknownObjectError:
            # Manifest never replicated to this peer (bounded-degree
            # overlay): the read failed at resolve, BEFORE the op
            # histogram's timing scope — no scorer sample either, so
            # the two per-tenant views stay aligned.
            self.get_results["missing"] += 1
        except Exception:  # noqa: BLE001 — a below-k/unavailable read;
            # delivery scoring owns loss accounting, not the GET mix.
            # The op histogram DID time this read (its finally runs on
            # the unavailable path), so record the same wall time here —
            # the scorer's per-tenant p99 and the fleet-merged histogram
            # p99 must estimate the same sample set.
            self.scorer.tenant_get(tenant, time.monotonic() - t0)
            self.get_results["failed"] += 1
        else:
            # Scorer-side wall time for the same read the tenant-labeled
            # op histogram observed — the independent per-tenant p99.
            self.scorer.tenant_get(tenant, time.monotonic() - t0)
            ok = hashlib.blake2b(data, digest_size=16).digest() == digest
            self.get_results["ok" if ok else "bad"] += 1

    def submit_repair(self, sender: FleetPeer, rng) -> None:
        """One repair-storm op: drop a shard from a random stored stripe
        and degraded-read it back through the codec (success/failure is
        scored; falls back to chat while the store is still empty).
        With ``lrc@G`` in the profile the op runs on the LRC tier
        instead: a seeded LRC(k, G, n-k-G) stripe loses one data shard
        and the degraded read heals it from its ~k/G-member group cell
        (codec/lrc.py local tier) — the fleet-scale proof that cheap
        repair holds under the chaos profile."""
        if sender.store is None:
            self.submit_chat(sender, rng)
            return
        prof = self.profile
        if prof.lrc_groups:
            key = self._ensure_lrc_stripe(sender, rng)
            try:
                sender.store.drop_shard(
                    key, int(rng.integers(0, prof.k))
                )
                sender.store.read(key)  # local-tier heal
            except Exception as exc:  # noqa: BLE001 — scored, not raised
                self.scorer.repair_result(False)
                self._record_error(exc)
            else:
                self.scorer.repair_result(True)
            return
        keys = sender.store.keys()
        if not keys:
            self.submit_chat(sender, rng)
            return
        key = keys[int(rng.integers(0, len(keys)))]
        try:
            sender.store.drop_shard(
                key, int(rng.integers(0, self.profile.k))
            )
            sender.store.read(key)  # degraded read reconstructs
        except Exception as exc:  # noqa: BLE001 — scored, not raised
            self.scorer.repair_result(False)
            self._record_error(exc)
        else:
            self.scorer.repair_result(True)

    def _ensure_lrc_stripe(self, sender: FleetPeer, rng) -> str:
        """The peer's store-local LRC stripe for the repair mix (lazily
        created, seeded payload). LRC stripes are a STORE tier — the
        wire path stays plain RS — so the repair op puts directly."""
        keys = getattr(sender, "_lrc_keys", None)
        if keys:
            return keys[int(rng.integers(0, len(keys)))]
        prof = self.profile
        gs_bytes = max(prof.k, 512)
        payload = rng.bytes(prof.k * gs_bytes)
        sig = hashlib.blake2b(
            b"noise-ec-fleet-lrc\0" + struct.pack("<I", sender.idx),
            digest_size=32,
        ).digest()
        key = sender.store.put_object(
            sig, payload, prof.k, prof.n,
            code=f"lrc:{prof.lrc_groups}",
        )
        sender._lrc_keys = [key]
        return key

    # ---- placement/rebalance drivers (tests and bench call these)

    def kill_domain(self, name: str) -> int:
        """Kill EVERY peer in failure domain ``name`` at once (the
        ``killdomain@`` drill, callable directly); returns how many
        peers went down. Killed peers count as churned in scoring
        (kill_times), exactly like ``churn@`` kills."""
        if self.topology is None:
            raise RuntimeError("kill_domain needs a domains@ profile")
        downed = 0
        for token in self.topology.peers_of(name):
            peer = self.peers[int(token.rsplit("//", 1)[1])]
            if peer.up:
                peer.up = False
                peer.kill_times.append(time.monotonic())
                self._churn_kill.add(1)
                downed += 1
        return downed

    def restart_domain(self, name: str) -> int:
        """Bring every peer in domain ``name`` back up."""
        if self.topology is None:
            raise RuntimeError("restart_domain needs a domains@ profile")
        restarted = 0
        for token in self.topology.peers_of(name):
            peer = self.peers[int(token.rsplit("//", 1)[1])]
            if not peer.up:
                peer.up = True
                self._churn_restart.add(1)
                restarted += 1
        return restarted

    def placement_census(self) -> dict:
        """``{domain: in-place shard count}`` across the UP peers — the
        numbers the per-domain gauges export and rebalance convergence
        settles (docs/placement.md)."""
        if self.ring is None:
            return {}
        from noise_ec_tpu_torch.placement.rebalance import domain_census

        holdings = [
            (f"fleet://{p.idx}", p.store)
            for p in self.peers
            if p.up and p.store is not None
        ]
        return domain_census(self.ring, holdings)

    def rebalance_cycle(self) -> dict:
        """One rebalance pass across every up store-carrying peer: sync
        each Rebalancer's alive view to the lab's authoritative up set,
        run its cycle, and drain the resulting moves. Returns the
        aggregated cycle stats."""
        agg = {"examined": 0, "moved": 0, "deferred": 0, "dropped": 0}
        alive = {f"fleet://{p.idx}" for p in self.peers if p.up}
        for idx, rb in self.rebalancers.items():
            if not self.peers[idx].up:
                continue
            rb.set_alive(alive)
            stats = rb.run_cycle()
            for key in agg:
                agg[key] += stats.get(key, 0)
        self._wait_drained(10.0)
        return agg

    def rebalance_until_converged(self, max_cycles: int = 8) -> dict:
        """Run rebalance cycles until one completes with nothing moved
        or deferred (converged) or the cycle budget runs out; returns
        the LAST cycle's aggregate plus the cycle count and the total
        bytes every rebalancer has moved."""
        stats: dict = {}
        cycles = 0
        for _ in range(max_cycles):
            stats = self.rebalance_cycle()
            cycles += 1
            if not stats["moved"] and not stats["deferred"]:
                break
        stats["cycles"] = cycles
        stats["bytes_moved"] = sum(
            rb.bytes_moved for rb in self.rebalancers.values()
        )
        self.scorer.note_placement({"rebalance": dict(stats)})
        return stats

    def _wait_drained(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        idle_since = None
        while time.monotonic() < deadline:
            if self.hub.dispatch.queue_depth() == 0:
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > 0.25:
                    return
            else:
                idle_since = None
            time.sleep(0.02)

    def _verify_objects(self) -> None:
        """Post-run GET verification: every expected receiver must serve
        each put object byte-identical through its own service layer."""
        from noise_ec_tpu_torch.service.objects import UnknownObjectError

        with self.scorer._lock:
            objects = dict(self.scorer.objects)
            sent = {m: dict(r) for m, r in self.scorer.sent.items()}
        for msg_id, obj in objects.items():
            rec = sent.get(msg_id)
            if rec is None:
                continue
            for ridx in rec["expected"]:
                receiver = self.peers[ridx]
                if receiver.objects is None:
                    continue
                t0 = time.monotonic()
                try:
                    # shed=False: post-run verification must measure
                    # REPLICATION, not a receiver's late-window load
                    # verdict refusing the read.
                    data = receiver.objects.read(
                        obj["tenant"], obj["name"], shed=False
                    )
                except UnknownObjectError:
                    # not delivered; no op-histogram sample
                    self.verify_results["missing"] += 1
                    continue
                except Exception:  # noqa: BLE001 — not delivered, but
                    # the op histogram timed the failed read: mirror it
                    # so scorer and histogram p99 stay comparable.
                    self.scorer.tenant_get(
                        obj["tenant"], time.monotonic() - t0
                    )
                    self.verify_results["failed"] += 1
                    continue
                # Verification reads land in the tenant-labeled op
                # histogram too; keep the scorer's sample set aligned.
                self.scorer.tenant_get(
                    obj["tenant"], time.monotonic() - t0
                )
                digest = hashlib.blake2b(data, digest_size=16).digest()
                self.verify_results[
                    "ok" if digest == obj["digest"] else "bad"] += 1
                if digest == obj["digest"]:
                    # Latency is not meaningful for a post-run read;
                    # stamp the send time so it lands as 0 and the
                    # report's latency stats skip it.
                    self.scorer.deliver(msg_id, ridx, now=rec["t"])

    # ------------------------------------------------------------ surfaces

    def health_block(self) -> dict:
        """The ``fleet`` block folded into ``/healthz`` details while a
        lab is attached (docs/fleet.md)."""
        snap = self.scorer.snapshot()
        up = sum(1 for p in self.peers if p.up)
        expected = snap["expected_deliveries"]
        return {
            "peers": len(self.peers),
            "up": up,
            "down": len(self.peers) - up,
            "sent": snap["sent"],
            "delivered": snap["delivered"],
            "shed": snap["shed"],
            "delivery_rate": round(
                snap["delivered"] / max(1, expected), 6
            ),
        }

    def build_federator(self):
        """The lab's :class:`~noise_ec_tpu_torch.obs.federate.MetricsFederator`
        over one scrape source per peer (built once; requires
        ``start()``).

        Lab peers share the ONE process registry, so each source serves
        the same exposition document and the merged fleet view
        multiplies every count by the number of reachable peers —
        histogram *quantiles* are scale-invariant under that
        multiplication, so fleet p50/p99 read off ``/fleet/metrics``
        exactly as they would from genuinely separate nodes (the lab
        limitation is counts, not latencies; docs/fleet.md).

        Chaos couples in: each source fails with the profile's ``drop``
        probability from its own seeded stream (``clean`` scrapes never
        fail; ``lossy`` failures are deterministic per seed and bounded
        by the per-target breaker)."""
        if self.federator is not None:
            return self.federator
        if not self._started:
            self.start()
        from noise_ec_tpu_torch.obs.federate import MetricsFederator

        drop = self.profile.chaos.drop
        sources = {
            f"fleet://{peer.idx}": self._scrape_source(peer, drop)
            for peer in self.peers
        }
        self.federator = MetricsFederator(
            sources=sources, registry=default_registry(),
            reset_timeout=0.05,
        )
        return self.federator

    def _scrape_source(self, peer: FleetPeer, drop: float):
        from noise_ec_tpu_torch.obs.export import render_prometheus

        rng = np.random.default_rng(
            np.random.SeedSequence(
                [self.seed & 0xFFFFFFFF, 0xFEDE, peer.idx]
            )
        )
        ref = weakref.ref(peer)

        def source() -> str:
            p = ref()
            if p is None or not p.up:
                raise RuntimeError(f"peer {peer.idx} is down")
            if drop > 0 and float(rng.random()) < drop:
                raise RuntimeError(
                    f"scrape of peer {peer.idx} dropped (chaos)"
                )
            return render_prometheus(default_registry())

        return source

    def attach(self, server) -> None:
        """Mount ``GET /fleet`` (and the federator's ``GET
        /fleet/metrics``) on a StatsServer and fold the live fleet
        block into its ``/healthz`` details."""
        server.mount("GET", "/fleet", self._route_fleet)
        self.build_federator().attach(server)
        prev = server.health_details
        ref = weakref.ref(self)

        def details() -> dict:
            out: dict = {}
            if prev is not None:
                try:
                    out.update(prev())
                except Exception as exc:  # noqa: BLE001 — same contract
                    # as StatsServer: details must never break the probe
                    out["error"] = str(exc)
            lab = ref()
            if lab is not None:
                out["fleet"] = lab.health_block()
            return out

        server.health_details = details

    def _route_fleet(self, req: dict) -> tuple:
        doc = {
            "profile": {
                "peers": self.profile.peers,
                "fanout": self.profile.fanout,
                "chaos": self.profile.chaos_name,
                "mix": self.profile.weights(),
            },
            "live": self.health_block(),
            "report": self.last_report,
        }
        return 200, "application/json", json.dumps(doc, indent=1).encode()

    def write_report(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.last_report or {}, f, indent=1)

    def write_trace(self, path: str) -> dict:
        """Write the fleet-wide merged Perfetto trace: every peer shares
        the process tracer, so one dump IS the merged fleet view (spans
        carry the message trace ids; the single ``node`` track is the
        lab itself)."""
        from noise_ec_tpu_torch.obs.perfetto import write_chrome_trace

        spans = default_tracer().dump()
        label = f"fleet[{len(self.peers)} peers]"
        for s in spans:
            s.setdefault("node", label)
        return write_chrome_trace(path, spans)

    def close(self) -> None:
        self._stop.set()
        if self.federator is not None:
            self.federator.close()
            self.federator = None
        if self._churn_thread is not None:
            self._churn_thread.join(timeout=5)
            self._churn_thread = None
        if self.hub is not None:
            self.hub.dispatch.shutdown(wait=True)


def _placement_census(ref, domain: str) -> float:
    lab = ref()
    if lab is None or lab.ring is None:
        return 0.0
    try:
        return float(lab.placement_census().get(domain, 0))
    except Exception:  # noqa: BLE001 — a scrape must never raise
        return 0.0


def _count_peers(ref, up: bool) -> int:
    lab = ref()
    if lab is None:
        return 0
    return sum(1 for p in lab.peers if p.up == up)


def _backpressure_waits() -> float:
    """Total producer waits across layers (report convenience)."""
    total = 0.0
    fam = default_registry().counter("noise_ec_backpressure_waits_total")
    for _, child in fam.children():
        total += child.value
    return total
