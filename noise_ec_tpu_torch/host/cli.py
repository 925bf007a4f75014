"""CLI / REPL driver — the reference's L5 (main.go:116-200).

Port of ``noise_ec_tpu.host.cli``. Run one node per process:

    python -m noise_ec_tpu_torch.host.cli -port 3001
    python -m noise_ec_tpu_torch.host.cli -port 3002 -peers tcp://localhost:3001

With ``-backend device`` (the default) the codec runs on ``-device``
("cuda" by default; "cpu" runs each kernel's plain PyTorch version), and a
node that cannot build its codec there (no card, a kernel that does not
build) exits 1 with the codec's error. ``-backend numpy`` runs the host
codec (NumPy, and the native shim for streams).

Each stdin line is erasure-sharded, signed, and broadcast to all peers;
peers reassemble, verify, and log the completed message. A line of the
form ``/send PATH`` streams the FILE at PATH instead (chunked
erasure-coded broadcast — ``ShardPlugin.stream_and_broadcast``), which is
how objects beyond one codeword travel; receivers log the object and,
with ``-recv-dir DIR``, save it under a content-hash name. Flags mirror
the reference (`-port -host -protocol -peers`, main.go:121-124); the
codec backend, trace, recv-dir, and chunk-size flags are new.

The stripe store (``-store-dir``, ``-scrub-interval``,
``-announce-interval``), placement (``-topology``) and the object service
(``-object-port``, ``-object-cache-mb``, ``-tenants``,
``-convert-interval``) run as in the reference, their codecs on
``-backend``/``-device`` like the plugin's. So do metrics federation
(``-federate``), the flight recorder (``-incident-dir``), the trace
collector (``-trace-peers``, ``-collect-traces``), the chaos proxy
(``-chaos-profile``, ``-chaos-seed``) and the fleet lab
(``-fleet-profile``, ``-fleet-size``, ``-fleet-report``), whose peers run
their codecs on ``-backend``/``-device`` too. With ``-metrics-port`` the
node also serves ``GET /diagnose``, which the reference's CLI does not
mount.
"""

from __future__ import annotations

import argparse
import logging
import sys

from noise_ec_tpu_torch.host.crypto import KeyPair, PeerID
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import TCPNetwork
from noise_ec_tpu_torch.obs.events import default_event_log
from noise_ec_tpu_torch.obs.health import default_slo
from noise_ec_tpu_torch.obs.profiling import device_trace, kernel_counters
from noise_ec_tpu_torch.obs.registry import set_build_info
from noise_ec_tpu_torch.obs.server import PeriodicReporter, StatsServer
from noise_ec_tpu_torch.obs.trace import default_tracer
from noise_ec_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("noise_ec_tpu_torch.host.cli")


def _kernel_label(backend: str, device: str) -> str:
    """The kernel tier actually serving this node, for the
    noise_ec_build_info deployment-identity gauge: "cuda" (a CUDA device
    codec), "cpu" (a CPU device codec: the kernels' plain versions) or
    "numpy"."""
    if backend != "device":
        return "numpy"
    return "cuda" if device == "cuda" else "cpu"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="noise-ec-torch-node",
        description="erasure-coded broadcast node (CUDA codec backend)",
    )
    # single-dash long flags, like Go's flag package (main.go:121-124)
    p.add_argument("-port", type=int, default=3000, help="port to listen on")
    p.add_argument("-host", default="localhost", help="host to listen on")
    p.add_argument(
        "-protocol", default="tcp",
        help="protocol to use: tcp or kcp (reliable UDP), main.go:123",
    )
    p.add_argument("-peers", default="", help="comma-separated peer addresses")
    p.add_argument(
        "-recv-shards",
        type=int,
        default=1,
        metavar="N",
        help="SO_REUSEPORT acceptor shards on the listen port (one "
        "event-loop thread each, kernel-balanced, all feeding the one "
        "shared dispatcher — docs/design.md §15); tcp only, default 1",
    )
    p.add_argument(
        "-backend",
        default="device",
        choices=["device", "numpy"],
        help="codec backend: device (the CUDA kernels on -device) or "
        "numpy (host)",
    )
    p.add_argument(
        "-device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the device backend runs: cuda (the card; the node "
        "exits 1 when there is none) or cpu (the kernels' plain PyTorch "
        "versions)",
    )
    p.add_argument(
        "-trace",
        default="",
        metavar="LOGDIR",
        help="capture a torch.profiler trace of the session (host and, on "
        "a card, CUDA activity) into LOGDIR as a Chrome trace (view in "
        "Perfetto or chrome://tracing)",
    )
    p.add_argument(
        "-xprof-dir",
        default="",
        metavar="DIR",
        help="enable on-demand xprof capture: GET /xprof?seconds=N on the "
        "stats endpoint records a torch.profiler trace of the next N "
        "seconds into DIR (a live decode burst, without -trace's "
        "whole-session capture); requires -metrics-port",
    )
    p.add_argument(
        "-profile",
        action="store_true",
        help="start the always-on sampling profiler (~50 Hz folded Python "
        "stacks, obs/sampler.py) at startup; GET /profile?seconds=N on "
        "the stats endpoint serves the last N seconds as flamegraph-ready "
        "collapsed text (without this flag the sampler starts lazily on "
        "the first /profile request)",
    )
    p.add_argument(
        "-compile-cache-dir",
        default="",
        metavar="DIR",
        help="build the CUDA kernel library into DIR instead of the "
        "package's _build/ (a restart reuses the library built there, "
        "keyed on the sources' hash). Also arms the ladder pre-warm hook "
        "(the default geometry's parity and recovery matrices are planned "
        "and its power-of-two batch sizes run once at startup, off the "
        "serving path). Empty disables",
    )
    p.add_argument(
        "-recv-dir",
        default="",
        metavar="DIR",
        help="save received messages/objects into DIR (file name = 16-hex "
        "BLAKE2b content hash of the bytes; logged on save)",
    )
    p.add_argument(
        "-chunk-bytes",
        type=int,
        default=4 << 20,
        help="chunk payload size for /send file streaming (bytes)",
    )
    p.add_argument(
        "-store-dir",
        default="",
        metavar="DIR",
        help="persist verified objects as erasure-coded stripes under DIR "
        "(the stripe store, docs/store.md); enables degraded reads and "
        "background repair. Empty disables unless -scrub-interval is set "
        "(then the store runs in memory only)",
    )
    p.add_argument(
        "-scrub-interval",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="walk the stripe store every SECONDS verifying parity and "
        "queueing repairs (0 disables the scrubber; repairs triggered by "
        "wire absorbs still run whenever the store is enabled)",
    )
    p.add_argument(
        "-announce-interval",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="broadcast one shard of each recently stored stripe every "
        "SECONDS (anti-entropy announce, docs/resilience.md): peers that "
        "silently lost an object — e.g. through a partition — discover "
        "and NACK-repair it. 0 disables; requires the stripe store "
        "(enabled automatically when set)",
    )
    p.add_argument(
        "-object-port",
        type=int,
        default=-1,
        metavar="PORT",
        help="serve the erasure-coded object service API "
        "(PUT/GET/range/DELETE/LIST under /objects, docs/object-service.md) "
        "on 127.0.0.1:PORT, alongside /metrics and /healthz on the same "
        "server. 0 binds an ephemeral port (logged); negative disables "
        "(default). Enables the stripe store automatically",
    )
    p.add_argument(
        "-object-cache-mb",
        type=int,
        default=256,
        metavar="MB",
        help="decoded-object cache ceiling for the GET hot path "
        "(docs/object-service.md Read path): hot reads serve from host "
        "RAM, warm addresses are advertised to peers on the announce "
        "loop, and the ceiling shrinks under the device HBM watermark. "
        "0 disables the cache tier",
    )
    p.add_argument(
        "-tenants",
        default="",
        metavar="FILE",
        help="tenant config JSON for the object service (namespaces, "
        "byte/object quotas, per-tenant geometry, replication targets, "
        "hot->archival conversion policies — docs/object-service.md, "
        "docs/lrc.md). Empty = open admission, unlimited quotas",
    )
    p.add_argument(
        "-convert-interval",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="walk the object manifests every SECONDS converting cold "
        "objects to their tenant's archival tier (policy grammar "
        "'archive=lrc:K/G+R,age=...' — docs/lrc.md). 0 disables; "
        "requires the object service (-object-port)",
    )
    p.add_argument(
        "-chaos-profile",
        default="",
        metavar="PROFILE",
        help="dial every -peers address through an in-process chaos "
        "proxy applying PROFILE (e.g. "
        "'drop=0.05,corrupt=0.01,partition@2:2:a2b,reset@5' — "
        "docs/resilience.md for the grammar). Fault injection for the "
        "REAL transport; empty disables",
    )
    p.add_argument(
        "-chaos-seed",
        type=int,
        default=0,
        metavar="SEED",
        help="seed for -chaos-profile fault decisions (same seed + "
        "profile + frame order reproduces the run)",
    )
    p.add_argument(
        "-fleet-profile",
        default="",
        metavar="PROFILE",
        help="run the in-process fleet lab instead of the REPL: spin up "
        "PROFILE's peers (e.g. 'peers=200,fanout=6,msgs=500,chat=0.9,"
        "object=0.1,chaos=lossy,churn@2:4:0.5' — docs/fleet.md for the "
        "grammar), drive the traffic mix, score delivery/shed/lost, and "
        "exit. -chaos-seed seeds the run; with -metrics-port the live "
        "status serves on GET /fleet and inside /healthz details",
    )
    p.add_argument(
        "-fleet-size",
        type=int,
        default=0,
        metavar="N",
        help="override the peers= count of -fleet-profile (0 keeps the "
        "profile's value)",
    )
    p.add_argument(
        "-fleet-report",
        default="",
        metavar="PATH",
        help="write the scored fleet report JSON to PATH and the "
        "fleet-wide merged Perfetto trace to PATH.trace.json "
        "(requires -fleet-profile)",
    )
    p.add_argument(
        "-metrics-port",
        type=int,
        default=-1,
        metavar="PORT",
        help="serve Prometheus exposition on 127.0.0.1:PORT (/metrics; "
        "also /spans for the trace ring buffer). 0 binds an ephemeral "
        "port (logged); negative disables (default)",
    )
    p.add_argument(
        "-stats-interval",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="log a stats snapshot every SECONDS while running "
        "(0 disables; stats always log once at shutdown)",
    )
    p.add_argument(
        "-trace-peers",
        default="",
        metavar="URLS",
        help="comma-separated peer metrics endpoints "
        "(http://host:port) whose /spans this node pulls and merges "
        "into distributed traces (docs/observability.md)",
    )
    p.add_argument(
        "-collect-traces",
        default="",
        metavar="PATH",
        help="write the merged local+peer spans as Chrome "
        "trace-event JSON to PATH at shutdown (open in Perfetto or "
        "chrome://tracing); implies periodic collection while running",
    )
    p.add_argument(
        "-collect-interval",
        type=float,
        default=10.0,
        metavar="SECONDS",
        help="poll interval for -trace-peers span collection "
        "(default 10)",
    )
    p.add_argument(
        "-federate",
        default="",
        metavar="URLS",
        help="comma-separated peer metrics endpoints "
        "(http://host:port) whose /metrics this node scrapes and "
        "merges; the fleet-wide view serves on GET /fleet/metrics "
        "(requires -metrics-port; docs/observability.md)",
    )
    p.add_argument(
        "-federate-interval",
        type=float,
        default=10.0,
        metavar="SECONDS",
        help="background scrape interval for -federate (default 10)",
    )
    p.add_argument(
        "-topology",
        default="",
        metavar="SPEC",
        help="failure-domain topology for placement-ring shard "
        "delivery: 'domain=rack1:peerA,peerB;domain=rack2:peerC' "
        "(docs/placement.md). Every node in the deployment must be "
        "given the SAME spec — the ring is deterministic, so "
        "identical topologies compute identical shard->peer maps. "
        "Unset = full broadcast exactly as before",
    )
    p.add_argument(
        "-incident-dir",
        default="",
        metavar="PATH",
        help="run the flight recorder: keep a byte-bounded ring of "
        "per-second metric deltas and write an incident bundle "
        "(JSON timeline + Perfetto trace) to PATH when the /healthz "
        "SLO flips to degraded, or on GET /incident "
        "(docs/observability.md)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    setup_logging()  # stderr-forced, like flag.Set("logtostderr") main.go:118
    args = build_parser().parse_args(argv)

    ladder = 0
    if args.compile_cache_dir and args.backend == "device":
        # Before the first codec: the kernel library is built and loaded
        # once per process, from the directory set here.
        from noise_ec_tpu_torch.ops._build import set_build_dir

        set_build_dir(args.compile_cache_dir)
        ladder = 8

    keys = KeyPair.random()  # fresh identity per run, main.go:132
    log.info("private key: %s", keys.private_key_hex())
    log.info("public key: %s", keys.public_key_hex())

    net = TCPNetwork(
        host=args.host, port=args.port, keys=keys, protocol=args.protocol,
        recv_shards=args.recv_shards,
    )

    def on_message(message: bytes, sender: PeerID) -> None:
        # The reference logs the full hex dump (main.go:92); for streamed
        # objects that would be megabytes of log — log a prefix + length,
        # and save the body when -recv-dir is set.
        if len(message) <= 256:
            log.info("message from %s: %s", sender.address, message.hex())
        else:
            log.info(
                "message from %s: %s… (%d bytes)",
                sender.address, message[:32].hex(), len(message),
            )
        if args.recv_dir:
            import hashlib
            import os

            # Never raise out of on_message: the plugin has already marked
            # the object completed, so an exception here would lose the
            # bytes silently (the transport only records it).
            try:
                os.makedirs(args.recv_dir, exist_ok=True)
                name = hashlib.blake2b(message, digest_size=8).hexdigest()
                path = os.path.join(args.recv_dir, name)
                # Atomic: the name claims to be the content hash, so a
                # torn write must never leave a partial file under it.
                tmp = path + ".part"
                with open(tmp, "wb") as f:
                    f.write(message)
                os.replace(tmp, path)
                log.info("saved %d bytes to %s", len(message), path)
            except OSError as exc:
                log.error("could not save received object: %s", exc)

    store = scrubber = engine = None
    if (
        args.store_dir or args.scrub_interval > 0
        or args.announce_interval > 0 or args.object_port >= 0
    ):
        from noise_ec_tpu_torch.store import StripeStore

        # The store's codecs run where the plugin's do.
        store = StripeStore(
            args.store_dir or None, backend=args.backend, device=args.device
        )

    plugin = ShardPlugin(
        backend=args.backend, device=args.device, on_message=on_message,
        store=store,
    )
    try:
        # Plan the default geometry before traffic arrives; with
        # -compile-cache-dir, also pre-warm the batch ladder.
        plugin.prewarm(ladder=ladder)
        if store is not None:
            store.codec(plugin.minimum_needed_shards, plugin.total_shards)
    except RuntimeError as exc:  # no card, a kernel that does not build
        log.error("codec unavailable on %s: %s", args.device, exc)
        net.close()
        return 1

    if store is not None:
        from noise_ec_tpu_torch.store import RepairEngine, Scrubber

        engine = RepairEngine(
            store, network=net,
            announce_interval_seconds=args.announce_interval,
        )
        engine.start()
        if args.scrub_interval > 0:
            scrubber = Scrubber(
                store, engine, interval_seconds=args.scrub_interval
            )
            scrubber.start()
        log.info(
            "stripe store enabled (%s, %d stripes loaded, scrub %s)",
            args.store_dir or "in-memory",
            len(store),
            f"every {args.scrub_interval}s" if args.scrub_interval > 0
            else "disabled",
        )
    net.add_plugin(plugin)

    rebalancer = None
    if args.topology:
        from noise_ec_tpu_torch.placement import (
            PlacementRing,
            Rebalancer,
            TargetedDelivery,
            Topology,
        )
        from noise_ec_tpu_torch.placement.rebalance import (
            register_domain_gauges,
        )

        topology = Topology.parse(args.topology)
        # Seed pinned to 0: every node given the same -topology (port or
        # reference) MUST compute the same shard->peer map, or targeted
        # delivery and gather disagree about owners.
        ring = PlacementRing(topology, seed=0)
        plugin.placement = TargetedDelivery(ring, self_token=net.id.address)
        log.info(
            "placement ring active: %d failure domains, %d peers "
            "(docs/placement.md)",
            len(topology.names()), len(topology.all_peers()),
        )
        if store is not None:
            def _rebalance_send(token, msgs, _net=net):
                pk = _net.placement_directory().get(token)
                return pk is not None and _net.send_many_to(pk, msgs)

            rebalancer = Rebalancer(
                store, ring,
                self_token=net.id.address,
                send=_rebalance_send,
                self_public_key=keys.public_key,
                repair=engine,
            ).start()
            register_domain_gauges(
                lambda d, _rb=rebalancer: float(
                    _rb.census()
                    if ring.topology.domain_of(net.id.address) == d
                    else 0
                ),
                topology.names(),
            )
            if net.supervisor is not None:
                def _on_membership(address, up, _rb=rebalancer):
                    (_rb.note_up if up else _rb.note_down)(address)

                net.supervisor.add_membership_listener(_on_membership)

    net.listen()  # background accept loop (go net.Listen(), main.go:169)
    log.info("listening for peers on %s", net.id.address)

    # Node identity for distributed tracing: every span dump this node
    # serves is stamped with the transport address + pubkey prefix, so a
    # collector can merge it with other nodes' dumps unambiguously.
    default_tracer().set_node(net.id.address, keys.public_key)
    set_build_info(backend=args.backend,
                   kernel=_kernel_label(args.backend, args.device))

    def stats_snapshot() -> dict:
        stats = plugin.counters.snapshot()
        stats.update(kernel_counters.snapshot())
        return stats

    sampler = None
    if args.profile:
        from noise_ec_tpu_torch.obs.sampler import default_sampler

        sampler = default_sampler()
        log.info("sampling profiler running (~%.0f Hz)", sampler.hz)

    stats_server = reporter = None
    if args.metrics_port >= 0:
        stats_server = StatsServer(
            port=args.metrics_port,
            # Kernel call/byte series are registry families
            # (noise_ec_kernel_{calls,bytes}_total{entry}); only the
            # plugin's state-machine bag still rides the prefix path.
            extra_counters={
                "noise_ec_plugin": plugin.counters,
            },
            sampler=sampler,
            xprof_dir=args.xprof_dir or None,
            # /healthz answers 503 with the verdict JSON once the
            # receive path burns the rolling SLO window (obs/health.py)
            # — orchestrators can restart/deweight on it.
            slo=default_slo(),
            # The peer supervisor's circuit-breaker summary rides the
            # /healthz JSON body (503, or 200 with ?verbose=1).
            health_details=(
                net.supervisor.health_summary
                if net.supervisor is not None else None
            ),
        )
        # The decision log rides the same server (GET /events).
        default_event_log().attach(stats_server)
        log.info("metrics endpoint on %s/metrics", stats_server.url)
        if args.xprof_dir:
            log.info("xprof capture armed: GET %s/xprof?seconds=N -> %s",
                     stats_server.url, args.xprof_dir)
    if args.stats_interval > 0:
        reporter = PeriodicReporter(args.stats_interval, stats_snapshot, log)

    federator = None
    federate_peers = [u for u in args.federate.split(",") if u]
    if federate_peers and stats_server is not None:
        from noise_ec_tpu_torch.obs.federate import MetricsFederator

        federator = MetricsFederator(peers=federate_peers)
        federator.attach(stats_server)
        federator.start(interval=max(args.federate_interval, 1.0))
        log.info(
            "federating metrics from %d peer(s) on %s/fleet/metrics",
            len(federate_peers), stats_server.url,
        )

    recorder = None
    if args.incident_dir:
        from noise_ec_tpu_torch.obs.recorder import FlightRecorder

        recorder = FlightRecorder(
            slo=default_slo(), incident_dir=args.incident_dir
        )
        recorder.start()
        if stats_server is not None:
            recorder.attach(stats_server)
        log.info(
            "flight recorder armed: incident bundles -> %s on SLO "
            "flip%s", args.incident_dir,
            " or GET /incident" if stats_server is not None else "",
        )

    if stats_server is not None:
        # GET /diagnose and the /healthz fold (docs/observability.md
        # "Diagnosis"); with the recorder, its bundles carry a verdict.
        from noise_ec_tpu_torch.obs.diagnose import DiagnosisEngine

        DiagnosisEngine(slo=default_slo(), recorder=recorder).attach(
            stats_server
        )

    object_server = converter = None
    if args.object_port >= 0:
        from noise_ec_tpu_torch.service import (
            DecodedObjectCache,
            ObjectAPI,
            ObjectStore,
            TenantRegistry,
        )

        tenants = (
            TenantRegistry.from_file(args.tenants) if args.tenants
            else TenantRegistry()
        )
        cache = None
        if args.object_cache_mb > 0:
            cache = DecodedObjectCache(max_bytes=args.object_cache_mb << 20)
        objects = ObjectStore(
            store, plugin, net,
            tenants=tenants, engine=engine, slo=default_slo(), cache=cache,
        )
        # The object API rides a StatsServer, so PORT serves /objects
        # alongside /metrics and /healthz: one scrape-and-serve surface
        # per node.
        object_server = StatsServer(
            port=args.object_port,
            extra_counters={"noise_ec_plugin": plugin.counters},
            slo=default_slo(),
            health_details=(
                net.supervisor.health_summary
                if net.supervisor is not None else None
            ),
        )
        ObjectAPI(objects).mount(object_server)
        # Warm-peer routing: advertise this node's warm addresses on the
        # announce loop so peers can serve hot reads from each other's
        # decoded caches before touching shards.
        objects.enable_peer_routing(object_server.url)
        log.info("object service on %s/objects (%d tenants configured)",
                 object_server.url, len(tenants.names()))
        if args.convert_interval > 0:
            from noise_ec_tpu_torch.store import ConversionEngine

            converter = ConversionEngine(
                store, tenants, cache=cache, repair=engine,
                interval_seconds=args.convert_interval,
            )
            converter.start()
            log.info(
                "hot->archival conversion every %gs (per-tenant "
                "'policy' drives the tier, docs/lrc.md)",
                args.convert_interval,
            )

    collector = None
    trace_peers = [u for u in args.trace_peers.split(",") if u]
    if trace_peers or args.collect_traces:
        from noise_ec_tpu_torch.obs.collector import TraceCollector

        # handshake_rtts is passed as the bound method: hints re-read
        # every poll, so peers dialed later still tighten clock sync.
        collector = TraceCollector(trace_peers, rtt_hints=net.handshake_rtts)
        collector.start(interval=max(args.collect_interval, 1.0))
        log.info(
            "collecting distributed traces from %d peer endpoint(s)",
            len(trace_peers),
        )

    peers = [a for a in args.peers.split(",") if a]
    chaos_proxies = []
    if peers and args.chaos_profile:
        from noise_ec_tpu_torch.resilience.chaos import ChaosProfile, ChaosProxy

        profile = ChaosProfile.parse(args.chaos_profile)
        proxied = []
        for addr in peers:
            host, port = TCPNetwork._split(addr)
            proxy = ChaosProxy(
                host, port, profile=profile, seed=args.chaos_seed
            ).start()
            chaos_proxies.append(proxy)
            proxied.append(proxy.address)
            log.info("chaos proxy %s -> %s (seed %d)",
                     proxy.address, addr, args.chaos_seed)
        peers = proxied
    if peers:
        net.bootstrap(peers)

    fleet_lab = None
    try:
        if args.fleet_profile:
            # Fleet-lab mode (docs/fleet.md): drive the declarative
            # traffic mix across an in-process fleet, score it, and
            # exit: no REPL. The TCP node above keeps serving its
            # endpoints while the lab runs, so /fleet and /healthz show
            # live status. The lab's peers run their codecs where this
            # node's do (-backend, -device).
            from noise_ec_tpu_torch.fleet import FleetLab, FleetProfile

            fleet_profile = FleetProfile.parse(args.fleet_profile)
            fleet_lab = FleetLab(
                fleet_profile,
                size=args.fleet_size or None,
                seed=args.chaos_seed,
                backend=args.backend,
                device=args.device,
            )
            fleet_lab.start()
            if stats_server is not None:
                fleet_lab.attach(stats_server)
                log.info("fleet status on %s/fleet", stats_server.url)
            with device_trace(args.trace):
                report = fleet_lab.run()
            log.info(
                "fleet run: %d peers, %d sent, delivery %.4f "
                "(%d delivered / %d lost / %d churned), %d shed",
                report["peers"], report["sent"],
                report["delivery"]["rate"], report["delivery"]["delivered"],
                report["delivery"]["lost"], report["delivery"]["churned"],
                report["shed"]["total"],
            )
            if args.fleet_report:
                fleet_lab.write_report(args.fleet_report)
                doc = fleet_lab.write_trace(args.fleet_report + ".trace.json")
                log.info(
                    "fleet report written to %s (+%d-span Perfetto trace)",
                    args.fleet_report,
                    len(doc.get("traceEvents", [])),
                )
            return 0
        with device_trace(args.trace):
            for line in sys.stdin:  # blocking REPL, main.go:175-198
                stripped = line.rstrip("\n")
                if not stripped:
                    continue  # skip blank lines, main.go:179-181
                if stripped.startswith("/send "):
                    path = stripped[len("/send "):].strip()
                    try:
                        # O(chunk) sender memory: the plugin hashes and
                        # reads the file in passes, never loading it whole.
                        chunks = plugin.stream_and_broadcast_file(
                            net, path, chunk_bytes=args.chunk_bytes
                        )
                    except (OSError, ValueError) as exc:
                        log.error("stream of %s failed: %s", path, exc)
                        continue
                    log.info("streamed %s as %d chunks", path, chunks)
                    continue
                input_bytes = stripped.encode()
                log.info("broadcasting message: %s", input_bytes.hex())
                try:
                    plugin.shard_and_broadcast(net, input_bytes)
                except ValueError as exc:
                    # e.g. accumulated dynamic geometry exceeding the field
                    # order (main.go:185-191 reproduced) — the node must
                    # outlive a rejected line.
                    log.error("broadcast failed: %s", exc)
    except KeyboardInterrupt:
        pass
    finally:
        if fleet_lab is not None:
            fleet_lab.close()
        if converter is not None:
            converter.close()
        if rebalancer is not None:
            rebalancer.close()
        if scrubber is not None:
            scrubber.close()
        if engine is not None:
            engine.close()
        if reporter is not None:
            reporter.close()
        if collector is not None:
            collector.close()
            try:
                collector.poll()  # final sweep before the transport dies
                if args.collect_traces:
                    from noise_ec_tpu_torch.obs.perfetto import (
                        write_chrome_trace,
                    )

                    spans = collector.merged_spans()
                    doc = write_chrome_trace(args.collect_traces, spans)
                    log.info(
                        "wrote %d spans from %d node(s) to %s "
                        "(open in Perfetto / chrome://tracing)",
                        len(spans), len(doc["otherData"]["nodes"]),
                        args.collect_traces,
                    )
            except Exception as exc:  # noqa: BLE001 — telemetry teardown
                log.error("trace export failed: %s", exc)
        if recorder is not None:
            recorder.close()
        if federator is not None:
            federator.close()
        if object_server is not None:
            object_server.close()
        if stats_server is not None:
            stats_server.close()
        if sampler is not None:
            sampler.close()
        net.close()
        for proxy in chaos_proxies:
            proxy.close()
            log.info("chaos stats: %s", proxy.stats())
        stats = stats_snapshot()
        if stats:
            log.info("session stats: %s", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
