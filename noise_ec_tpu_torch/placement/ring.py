"""The placement ring: topology grammar + deterministic shard→peer maps.

``Topology.parse`` declares the fleet's failure domains (racks, zones —
whatever the operator wants a whole-unit failure to cost at most one
shard of):

    domain=rack1:peerA,peerB;domain=rack2:peerC,peerD*2

Each ``domain=NAME:...`` declaration lists the peer tokens living in
that domain; a ``*W`` suffix gives a peer a CRUSH-style selection
weight (default 1.0). Peer tokens are the transport's peer addresses
(``tcp://host:port`` on the wire, ``fleet://idx`` in the lab) — colons
inside tokens are fine because only the FIRST colon after the domain
name splits.

:class:`PlacementRing` maps a stripe key onto owners in two stages,
both pure blake2b keyed by the ring seed (no RNG state, so any two
processes with the same topology + seed compute identical maps):

1. **domain stage** — a rendezvous draw over the (static) domain set
   orders domains per stripe; shard ``i`` of an RS stripe lands in the
   ``i``-th domain, so the n shards occupy n DISTINCT domains and a
   whole-domain failure costs one shard. For ``lrc:<g>`` geometries the
   constraint is Azure-LRC-shaped instead: each local group's cell
   (data shards + its local parity, codec/lrc.py) lands inside ONE
   domain — a group heal never leaves the rack — and the global
   parities spread across further distinct domains.
2. **peer stage** — a pluggable selector picks the owner inside the
   chosen domain: ``"ring"`` walks a per-domain consistent-hash ring of
   ``vnodes`` virtual nodes per peer; ``"straw2"`` is the CRUSH
   weighted draw (Weil et al.): each candidate scores
   ``ln(u) / weight`` from its own keyed hash and the best score wins.
   Both move ≤ ~1/|peers| of assignments when one peer joins or
   leaves — the consistent-hashing bound the placement tests pin.

``alive`` filtering (the rebalancer's view of membership) excludes
down peers from the peer stage and dead domains from the domain
stage deterministically: every node with the same alive set computes
the same re-homed owners, which is what lets the rebalancer move only
the delta.
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from noise_ec_tpu_torch.codec.lrc import parse_code

__all__ = ["PlacementRing", "Topology", "required_domains"]

_SEED_NS = b"noise-ec-placement\0"


def _h64(*parts: bytes) -> int:
    """64-bit keyed draw: one blake2b over the length-delimited parts
    (length-delimited so no byte can migrate between fields)."""
    h = hashlib.blake2b(_SEED_NS, digest_size=8)
    for p in parts:
        h.update(struct.pack("<I", len(p)))
        h.update(p)
    return struct.unpack("<Q", h.digest())[0]


def required_domains(k: int, n: int, code: str = "rs") -> int:
    """Distinct failure domains the geometry needs: ``n`` for plain RS
    (one shard per domain); ``g + (n - k - g)`` for ``lrc:<g>`` (one
    domain per local group cell + one per global parity)."""
    g = parse_code(code)
    if g is None:
        return n
    return g + (n - k - g)


@dataclass(frozen=True)
class Topology:
    """Parsed failure-domain declaration (module docstring grammar).

    ``domains`` preserves declaration order: ``(name, (peer, ...))``
    pairs; ``weights`` maps peer token → CRUSH selection weight."""

    domains: tuple = ()
    weights: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "Topology":
        """``domain=rack1:peerA,peerB;domain=rack2:peerC*2`` →
        :class:`Topology`. Rejects empty domains, duplicate domain
        names, peers claimed by two domains, and non-positive weights."""
        domains: list = []
        weights: dict = {}
        seen_domains: set = set()
        seen_peers: set = set()
        for raw in text.split(";"):
            decl = raw.strip()
            if not decl:
                continue
            if not decl.startswith("domain="):
                raise ValueError(
                    f"bad topology declaration {decl!r} "
                    "(want domain=NAME:peer,peer)"
                )
            name, sep, peer_text = decl[len("domain="):].partition(":")
            name = name.strip()
            if not sep or not name:
                raise ValueError(
                    f"topology declaration {decl!r} is missing its "
                    "NAME: part"
                )
            if name in seen_domains:
                raise ValueError(f"duplicate domain {name!r} in topology")
            seen_domains.add(name)
            peers: list = []
            for ptok in peer_text.split(","):
                ptok = ptok.strip()
                if not ptok:
                    continue
                token, star, wtext = ptok.rpartition("*")
                if star and token:
                    try:
                        weight = float(wtext)
                    except ValueError:
                        # A '*' inside the token itself (no numeric
                        # suffix): treat the whole thing as the token.
                        token, weight = ptok, 1.0
                else:
                    token, weight = ptok, 1.0
                if weight <= 0:
                    raise ValueError(
                        f"peer {token!r} weight must be > 0, got {weight}"
                    )
                if token in seen_peers:
                    raise ValueError(
                        f"peer {token!r} appears in two domains"
                    )
                seen_peers.add(token)
                peers.append(token)
                weights[token] = weight
            if not peers:
                raise ValueError(f"domain {name!r} declares no peers")
            domains.append((name, tuple(peers)))
        if not domains:
            raise ValueError("topology declares no domains")
        return cls(domains=tuple(domains), weights=weights)

    def names(self) -> tuple:
        return tuple(name for name, _ in self.domains)

    def peers_of(self, name: str) -> tuple:
        for dname, peers in self.domains:
            if dname == name:
                return peers
        raise KeyError(f"unknown domain {name!r}")

    def domain_of(self, token: str) -> Optional[str]:
        for dname, peers in self.domains:
            if token in peers:
                return dname
        return None

    def all_peers(self) -> tuple:
        return tuple(p for _, peers in self.domains for p in peers)


# ------------------------------------------------------------- selectors


def _select_ring(ring_points, key: str, slot: int, candidates,
                 weights, seed: int) -> str:
    """Consistent-hash walk: the first virtual node clockwise of the
    stripe's draw whose peer is a live candidate owns the slot."""
    h = _h64(struct.pack("<Q", seed & (2**64 - 1)), b"slot",
             key.encode(), struct.pack("<I", slot))
    lo, hi = 0, len(ring_points)
    while lo < hi:  # successor of h (wrapping)
        mid = (lo + hi) // 2
        if ring_points[mid][0] < h:
            lo = mid + 1
        else:
            hi = mid
    for off in range(len(ring_points)):
        peer = ring_points[(lo + off) % len(ring_points)][1]
        if peer in candidates:
            return peer
    raise AssertionError("unreachable: candidates is non-empty")


def _select_straw2(ring_points, key: str, slot: int, candidates,
                   weights, seed: int) -> str:
    """CRUSH straw2: each candidate draws its own u ∈ (0, 1] keyed by
    (seed, key, slot, peer) and scores ``ln(u) / weight``; the highest
    score wins. Removing a peer only re-homes the slots it was winning
    (rendezvous property — the same ≤ 1/|peers| movement bound)."""
    del ring_points
    best, best_score = None, -math.inf
    for peer in candidates:
        draw = _h64(struct.pack("<Q", seed & (2**64 - 1)), b"straw",
                    key.encode(), struct.pack("<I", slot), peer.encode())
        u = (draw + 1) / 2.0**64  # (0, 1]
        score = math.log(u) / weights.get(peer, 1.0)
        if score > best_score or (score == best_score and peer < best):
            best, best_score = peer, score
    return best


SELECTORS: dict[str, Callable] = {
    "ring": _select_ring,
    "straw2": _select_straw2,
}


# ------------------------------------------------------------------ ring


class PlacementRing:
    """Deterministic shard→peer assignment over a :class:`Topology`
    (module docstring). Stateless after construction — ``owners`` is a
    pure function of (topology, seed, key, geometry, alive)."""

    def __init__(
        self,
        topology: Topology,
        *,
        seed: int = 0,
        vnodes: int = 64,
        selector: str = "ring",
    ):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        try:
            self._select = SELECTORS[selector]
        except KeyError:
            raise ValueError(
                f"unknown selector {selector!r}; have {sorted(SELECTORS)}"
            )
        self.topology = topology
        self.seed = int(seed)
        self.vnodes = vnodes
        self.selector = selector
        # Per-domain vnode rings, built once: sorted (point, peer) pairs.
        # Weighted peers get proportionally more virtual nodes so the
        # "ring" selector honours CRUSH weights too.
        self._rings: dict[str, list] = {}
        for name, peers in topology.domains:
            points = []
            for peer in peers:
                count = max(1, round(vnodes * topology.weights.get(peer, 1.0)))
                for v in range(count):
                    points.append((
                        _h64(struct.pack("<Q", self.seed & (2**64 - 1)),
                             b"vnode", name.encode(), peer.encode(),
                             struct.pack("<I", v)),
                        peer,
                    ))
            points.sort()
            self._rings[name] = points

    # ------------------------------------------------------------ domains

    def _domain_order(self, key: str, alive: Optional[set]) -> list:
        """Per-stripe rendezvous ordering of the live domains. The
        domain SET is topology-static, so the order is stable under
        peer churn inside a domain; a domain only drops out of the
        order when every one of its peers is dead."""
        scored = []
        for name, peers in self.topology.domains:
            if alive is not None and not any(p in alive for p in peers):
                continue
            scored.append((
                _h64(struct.pack("<Q", self.seed & (2**64 - 1)),
                     b"domain", key.encode(), name.encode()),
                name,
            ))
        scored.sort()
        return [name for _, name in scored]

    def _pick(self, key: str, slot: int, domain: str,
              alive: Optional[set]) -> Optional[str]:
        peers = self.topology.peers_of(domain)
        candidates = (
            peers if alive is None
            else tuple(p for p in peers if p in alive)
        )
        if not candidates:
            return None
        return self._select(
            self._rings[domain], key, slot, candidates,
            self.topology.weights, self.seed,
        )

    # ------------------------------------------------------------- owners

    def owners(
        self,
        key: str,
        n: int,
        *,
        k: Optional[int] = None,
        code: str = "rs",
        alive: Optional[Iterable[str]] = None,
    ) -> list:
        """Owner token per shard slot, length ``n``. A slot whose
        assigned domain has no live peer maps to ``None`` (unplaceable
        until the domain heals — the erasure code's parity budget is
        exactly what absorbs that). ``k`` is required for ``lrc:<g>``
        codes (the group layout depends on it)."""
        alive_set = set(alive) if alive is not None else None
        order = self._domain_order(key, alive_set)
        if not order:
            return [None] * n
        g = parse_code(code)
        if g is None:
            # RS: shard i → i-th domain of the stripe's order. Fewer
            # live domains than n leaves the tail slots unplaced rather
            # than doubling a domain up — the distinctness invariant is
            # the whole point of the ring.
            out = []
            for slot in range(n):
                if slot >= len(order):
                    out.append(None)
                    continue
                out.append(self._pick(key, slot, order[slot], alive_set))
            return out
        if k is None:
            raise ValueError(f"code {code!r} needs k to lay out groups")
        if k % g or n - k - g < 1:
            raise ValueError(
                f"bad LRC geometry k={k} n={n} code={code!r}"
            )
        # LRC layout (codec/lrc.py): [0..k) data in g cells, [k..k+g)
        # local parities (parity j closes cell j), [k+g..n) globals.
        # Cell j → domain order[j]; global parity t → order[g + t].
        group_size = k // g
        out: list = []
        for slot in range(n):
            if slot < k:
                didx = slot // group_size
            elif slot < k + g:
                didx = slot - k
            else:
                didx = g + (slot - k - g)
            if didx >= len(order):
                out.append(None)
                continue
            out.append(self._pick(key, slot, order[didx], alive_set))
        return out

    def owner_domains(
        self, key: str, n: int, *, k: Optional[int] = None,
        code: str = "rs",
    ) -> list:
        """The assigned failure-domain name per slot (liveness-blind —
        the receive-side absorb gate and the census both work from the
        topology-static assignment)."""
        order = self._domain_order(key, None)
        g = parse_code(code)
        if g is None:
            return [
                order[slot] if slot < len(order) else None
                for slot in range(n)
            ]
        if k is None:
            raise ValueError(f"code {code!r} needs k to lay out groups")
        group_size = k // g
        out = []
        for slot in range(n):
            if slot < k:
                didx = slot // group_size
            elif slot < k + g:
                didx = slot - k
            else:
                didx = g + (slot - k - g)
            out.append(order[didx] if didx < len(order) else None)
        return out

    def moved(
        self,
        key: str,
        n: int,
        alive_before: Iterable[str],
        alive_after: Iterable[str],
        *,
        k: Optional[int] = None,
        code: str = "rs",
    ) -> list:
        """Ownership delta for one stripe across a membership change:
        ``[(slot, old_owner, new_owner), ...]`` for slots whose owner
        differs — the rebalancer moves exactly these."""
        before = self.owners(key, n, k=k, code=code, alive=alive_before)
        after = self.owners(key, n, k=k, code=code, alive=alive_after)
        return [
            (slot, b, a)
            for slot, (b, a) in enumerate(zip(before, after))
            if b != a
        ]
