"""The fleet traffic-mix grammar: ``FleetProfile.parse``.

Styled after :meth:`~noise_ec_tpu_torch.resilience.chaos.ChaosProfile.parse`
(comma-separated tokens, one seed reproduces a run): a declarative
description of WHAT a fleet run does — how many peers, what traffic mix
(chat-sized spam / object PUT+GET through the service layer / repair
storms), how fast, under which named chaos profile, with what churn —
while :mod:`noise_ec_tpu_torch.fleet.runner` owns HOW it runs.

Chaos composes by NAME (``chaos=lossy``): the lab's per-link fault model
is the existing :class:`ChaosLink` pipeline, so a named profile is just
a curated ``ChaosProfile.parse`` string. Churn rides the SAME chaos
grammar (the ``churn@`` primitive added to ``ChaosProfile.parse``):
``churn@`` / ``partition@`` / ``reset@`` / ``kill@`` tokens inside a
fleet profile pass through verbatim to the chaos parser rather than
growing a parallel scheduler.

Grammar (docs/fleet.md):

``peers=N``            fleet size (CLI ``-fleet-size`` overrides)
``fanout=F``           per-peer neighbor count (bounded-degree overlay)
``msgs=N``             total traffic submissions across the run
``senders=K``          peers that originate traffic (0 = all)
``drivers=D``          concurrent driver threads (0 = auto)
``rate=R``             per-driver submissions/second pacing (0 = unpaced)
``chat=W``             weight of chat-sized broadcasts in the mix
``object=W``           weight of object PUT/GET through the service layer
``get=W``              weight of hot-read GETs: a zipfian-popular object
                       read back through a random peer's service layer
                       (exercises the decoded-object cache tiers)
``zipf_s=S``           zipf exponent of the GET popularity draw
                       (default 1.1; must be > 1)
``repair=W``           weight of repair-storm ops (drop a stored shard,
                       degraded-read it back through the codec)
``lrc@G``              run the repair-storm mix on the LRC tier
                       (docs/lrc.md): each repair op exercises an
                       LRC(k, G groups, n-k-G globals) stripe, healing
                       single losses from ~k/G local shards; G must
                       divide k and leave >= 1 global parity
``chat_bytes=B``       chat payload size (padded to a multiple of k)
``object_bytes=B``     object payload size
``stripe_bytes=B``     object-service stripe capacity
``k=K`` / ``n=N``      RS geometry for all fleet traffic
``chaos=NAME``         named chaos profile (see :data:`NAMED_CHAOS`)
``churn_peers=C``      peers subject to the churn schedule (0 = ~5%)
``churn@S:I:D[:J]``    passed through to ``ChaosProfile.parse``
``partition@...`` / ``reset@...`` / ``kill@...``  likewise
``domains@D``          partition the fleet's peers into D failure
                       domains ("d0".."d{D-1}", round-robin) and place
                       object stripes through the placement ring
                       (docs/placement.md); D must cover the active
                       geometry (>= n for RS, >= groups + globals for
                       LRC) — rejected at parse time otherwise
``killdomain@T:NAME``  chaos: at T seconds, kill EVERY peer in failure
                       domain NAME at once (the rack-failure drill;
                       requires ``domains@``)
``slow@PEER:MS[:JITTER]``  delay-only chaos on every link touching peer
                       index PEER: MS milliseconds (+ uniform 0..JITTER
                       ms, seeded) on each delivery to or from it, and
                       on every placement gather fetch it serves — the
                       one-straggler scenario the hedged read path is
                       for (docs/fleet.md). Repeatable for several slow
                       peers.
``hedge=0|1``          disable/enable hedged k+Δ gather fan-out on the
                       fleet's object read path (default 1; hedge=0 is
                       the A/B control run)
``noisy=M``            tenant-isolation mix: object/GET traffic splits
                       into a "noisy" tenant submitting M× the "quiet"
                       tenant's share (default 0 = single "fleet"
                       tenant); the report then carries per-tenant GET
                       latency so the QoS-lane isolation bar is
                       checkable
"""

from __future__ import annotations

from dataclasses import dataclass, field

from noise_ec_tpu_torch.resilience.chaos import ChaosProfile

__all__ = ["NAMED_CHAOS", "FleetProfile"]

# Curated, named fault mixes (docs/fleet.md): the acceptance scenarios
# compose "a named chaos profile" instead of ad-hoc token soup, so two
# runs claiming "lossy" mean the same thing.
NAMED_CHAOS: dict[str, str] = {
    "clean": "",
    "lossy": "drop=0.01,corrupt=0.005",
    "flaky": "drop=0.05,corrupt=0.01,duplicate=0.01",
    "storm": "drop=0.08,corrupt=0.02,duplicate=0.02,reorder=0.02",
}

_INT_KEYS = (
    "peers", "fanout", "msgs", "senders", "drivers",
    "chat_bytes", "object_bytes", "stripe_bytes", "k", "n", "churn_peers",
    "hedge",
)
_FLOAT_KEYS = ("chat", "object", "get", "repair", "rate", "zipf_s",
               "noisy")
_CHAOS_PASSTHROUGH = ("churn@", "partition@", "reset@", "kill@")


@dataclass(frozen=True)
class FleetProfile:
    """One declarative fleet run (module docstring for the grammar)."""

    peers: int = 64
    fanout: int = 6
    msgs: int = 200
    senders: int = 0       # 0 = every peer sends
    drivers: int = 0       # 0 = auto (min(4, senders))
    rate: float = 0.0      # per-driver submissions/s; 0 = unpaced
    chat: float = 1.0
    object: float = 0.0
    get: float = 0.0
    zipf_s: float = 1.1
    repair: float = 0.0
    chat_bytes: int = 64
    object_bytes: int = 8192
    stripe_bytes: int = 4096
    # Fleet default geometry carries FOUR parity shards (vs the node
    # default RS(4,6)): Berlekamp–Welch corrects e errors only when
    # m - k >= 2e, so with two parity shards a single link dropping one
    # frame AND corrupting another loses the codeword outright (m=5,
    # e=1 is detect-only) — measured ~1.4e-3 per delivery under the
    # "lossy" profile, an order of magnitude over the 99.9% bar. With
    # n=8 the same codeword survives any (2 drops + 1 corrupt) or
    # (2 corrupt) combination.
    k: int = 4
    n: int = 8
    # LRC local-group count for the repair mix (the ``lrc@G`` token);
    # 0 = repair storms run on plain RS stripes.
    lrc_groups: int = 0
    # Failure domains (the ``domains@D`` token): 0 = no placement ring,
    # broadcast delivery exactly as before. D > 0 partitions peers
    # round-robin into domains "d0".."d{D-1}" and routes object stripes
    # through the placement ring (docs/placement.md).
    domains: int = 0
    # (at_seconds, domain_name) whole-domain kills (``killdomain@``).
    domain_kills: tuple = ()
    # (peer_idx, delay_s, jitter_s) per-peer straggler links (``slow@``,
    # milliseconds in the grammar, seconds here).
    slow_peers: tuple = ()
    # Hedged k+Δ gather fan-out on the object read path (``hedge=0``
    # is the A/B control run with the fan-out disabled).
    hedge: int = 1
    # Noisy-tenant multiplier (``noisy=M``): 0 = single "fleet" tenant;
    # M > 0 splits object/GET traffic into "noisy" (share M/(M+1)) and
    # "quiet" tenants for the QoS-isolation scenario.
    noisy: float = 0.0
    chaos_name: str = "clean"
    churn_peers: int = 0   # 0 = ~5% of the fleet when churn is scheduled
    chaos: ChaosProfile = field(default_factory=ChaosProfile)

    @classmethod
    def parse(cls, text: str) -> "FleetProfile":
        """Parse the CLI grammar (module docstring). Example::

            peers=200,fanout=6,msgs=500,chat=0.8,object=0.2,
            chaos=lossy,churn@2:4:0.5
        """
        kwargs: dict = {}
        chaos_tokens: list[str] = []
        chaos_name = "clean"
        for raw in text.split(","):
            tok = raw.strip()
            if not tok:
                continue
            if tok.startswith(_CHAOS_PASSTHROUGH):
                chaos_tokens.append(tok)
                continue
            if tok.startswith("lrc@"):
                g = int(tok[len("lrc@"):])
                if g < 1:
                    raise ValueError(
                        f"lrc@ group count must be >= 1, got {g}"
                    )
                kwargs["lrc_groups"] = g
                continue
            if tok.startswith("domains@"):
                d = int(tok[len("domains@"):])
                if d < 1:
                    raise ValueError(
                        f"domains@ count must be >= 1, got {d}"
                    )
                kwargs["domains"] = d
                continue
            if tok.startswith("killdomain@"):
                spec = tok[len("killdomain@"):]
                at_text, sep, name = spec.partition(":")
                if not sep or not name:
                    raise ValueError(
                        f"killdomain@ wants T:NAME, got {spec!r}"
                    )
                kills = kwargs.setdefault("domain_kills", [])
                kills.append((float(at_text), name.strip()))
                continue
            if tok.startswith("slow@"):
                parts = tok[len("slow@"):].split(":")
                if len(parts) not in (2, 3):
                    raise ValueError(
                        f"slow@ wants PEER:MS[:JITTER], got {tok!r}"
                    )
                idx = int(parts[0])
                delay_ms = float(parts[1])
                jitter_ms = float(parts[2]) if len(parts) == 3 else 0.0
                if idx < 0:
                    raise ValueError(
                        f"slow@ peer index must be >= 0, got {idx}"
                    )
                if delay_ms < 0 or jitter_ms < 0:
                    raise ValueError(
                        f"slow@ delay/jitter must be >= 0 ms, got {tok!r}"
                    )
                slows = kwargs.setdefault("slow_peers", [])
                slows.append((idx, delay_ms / 1000.0, jitter_ms / 1000.0))
                continue
            if "=" not in tok:
                raise ValueError(f"unparseable fleet token {tok!r}")
            key, _, val = tok.partition("=")
            key = key.strip()
            val = val.strip()
            if key == "chaos":
                if val not in NAMED_CHAOS:
                    raise ValueError(
                        f"unknown chaos profile {val!r}; named profiles: "
                        f"{sorted(NAMED_CHAOS)}"
                    )
                chaos_name = val
            elif key in _INT_KEYS:
                kwargs[key] = int(val)
            elif key in _FLOAT_KEYS:
                kwargs[key] = float(val)
            else:
                raise ValueError(f"unknown fleet knob {key!r}")
        base = NAMED_CHAOS[chaos_name]
        chaos_text = ",".join(
            ([base] if base else []) + chaos_tokens
        )
        chaos = (
            ChaosProfile.parse(chaos_text) if chaos_text else ChaosProfile()
        )
        if "domain_kills" in kwargs:
            kwargs["domain_kills"] = tuple(kwargs["domain_kills"])
        if "slow_peers" in kwargs:
            kwargs["slow_peers"] = tuple(kwargs["slow_peers"])
        prof = cls(chaos_name=chaos_name, chaos=chaos, **kwargs)
        prof.validate()
        return prof

    def validate(self) -> None:
        if self.peers < 2:
            raise ValueError(f"a fleet needs >= 2 peers, got {self.peers}")
        if not 1 <= self.fanout <= self.peers - 1:
            raise ValueError(
                f"fanout {self.fanout} outside [1, peers-1={self.peers - 1}]"
            )
        if min(self.chat, self.object, self.get, self.repair) < 0:
            raise ValueError("traffic weights must be non-negative")
        if self.chat + self.object + self.get + self.repair <= 0:
            raise ValueError("at least one traffic weight must be positive")
        if self.zipf_s <= 1.0:
            raise ValueError(f"zipf_s must be > 1, got {self.zipf_s}")
        if not 1 <= self.k <= self.n <= 256:
            raise ValueError(f"invalid fleet geometry k={self.k} n={self.n}")
        if self.lrc_groups:
            # The same parse-time contract service/tenants.py enforces:
            # groups divide k, and >= 1 global parity remains.
            if self.lrc_groups < 1 or self.k % self.lrc_groups:
                raise ValueError(
                    f"lrc@{self.lrc_groups} must divide k={self.k}"
                )
            if self.n - self.k - self.lrc_groups < 1:
                raise ValueError(
                    f"lrc@{self.lrc_groups} leaves no global parity "
                    f"(k={self.k}, n={self.n})"
                )
        if self.domains:
            # Parse-time geometry cover (the tenant-grammar pattern):
            # the ring places each stripe's shards on DISTINCT domains,
            # so fewer domains than the geometry needs can never place.
            from noise_ec_tpu_torch.placement.ring import required_domains

            code = f"lrc:{self.lrc_groups}" if self.lrc_groups else "rs"
            need = required_domains(self.k, self.n, code)
            if self.domains < need:
                raise ValueError(
                    f"domains@{self.domains} cannot cover the active "
                    f"geometry (k={self.k}, n={self.n}, code={code}: "
                    f"needs >= {need} failure domains)"
                )
            if self.domains > self.peers:
                raise ValueError(
                    f"domains@{self.domains} exceeds peers={self.peers}"
                )
        valid_domains = {f"d{i}" for i in range(self.domains)}
        for at, name in self.domain_kills:
            if not self.domains:
                raise ValueError(
                    "killdomain@ requires a domains@D token"
                )
            if at < 0:
                raise ValueError(
                    f"killdomain@ time must be >= 0, got {at}"
                )
            if name not in valid_domains:
                raise ValueError(
                    f"killdomain@ names unknown domain {name!r} "
                    f"(domains@{self.domains} declares d0..d{self.domains - 1})"
                )
        for idx, delay_s, jitter_s in self.slow_peers:
            if not 0 <= idx < self.peers:
                raise ValueError(
                    f"slow@ peer index {idx} outside [0, peers-1="
                    f"{self.peers - 1}]"
                )
            if delay_s < 0 or jitter_s < 0:
                raise ValueError("slow@ delay/jitter must be >= 0")
        if self.hedge not in (0, 1):
            raise ValueError(f"hedge must be 0 or 1, got {self.hedge}")
        if self.noisy < 0:
            raise ValueError(f"noisy must be >= 0, got {self.noisy}")
        if self.msgs < 1:
            raise ValueError(f"msgs must be >= 1, got {self.msgs}")
        if self.stripe_bytes < self.k:
            raise ValueError(
                f"stripe_bytes {self.stripe_bytes} below k={self.k}"
            )

    def weights(self) -> dict[str, float]:
        """Normalized traffic-mix weights by kind."""
        total = self.chat + self.object + self.get + self.repair
        return {
            "chat": self.chat / total,
            "object": self.object / total,
            "get": self.get / total,
            "repair": self.repair / total,
        }

    def needs_stores(self) -> bool:
        """Object, GET or repair traffic requires per-peer stripe stores
        and the service layer."""
        return self.object > 0 or self.get > 0 or self.repair > 0
