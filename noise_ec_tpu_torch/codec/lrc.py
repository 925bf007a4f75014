"""Locally-repairable codes: cheap single-loss repair on top of the
generator-matrix machinery (docs/lrc.md).

Port of ``noise_ec_tpu.codec.lrc`` on the port's :class:`ReedSolomon`:
both constructors take ``device`` ("cuda" unless the caller asks for
"cpu") and pass it on, so both repair tiers run on the card's kernels.

Every RS repair reads k shards — at RS(200, 56) that is 200 fetches to
heal ONE lost shard, which the wide-geometry kernels make computationally
free and a fleet-scale network makes ruinous. An Azure-style local
reconstruction code (Huang et al., "Erasure Coding in Windows Azure
Storage") partitions the k data shards into ``g`` equal *local groups*,
adds one XOR parity per group, and keeps ``r`` global Cauchy parities:

- shard layout: ``[0..k)`` data, ``[k..k+g)`` local parities (one per
  group), ``[k+g..n)`` global parities — systematic, so the wire format,
  ``Split``/``Join`` and the ``ShardPlugin`` contract are untouched;
- a *group cell* is one group's k/g data shards plus its local parity:
  any single loss inside a cell heals from the cell's other members —
  ``k/g`` reads instead of ``k`` (the fetch-amplification win the
  repair-storm bench gates);
- losses past a cell's budget (two in one cell, or a global parity)
  fall back to the global reconstruct, which is the ordinary
  :class:`~noise_ec_tpu_torch.codec.rs.ReedSolomon` path — including the
  invertible-subset search, because an LRC is deliberately not MDS.

Both tiers ride the SAME device dispatch: the local heal is a
``(1, k/g)`` all-ones generator row (XOR over the surviving cell —
GF(2^m) addition IS XOR) batched through ``matmul_many``, so a repair
storm's local heals coalesce into one device call exactly like global
reconstructs do.

Encode/verify/reconstruct are inherited: the LRC generator is just one
more systematic matrix kind (``"lrc:<g>"``, matrix/generators.py), so
``FEC(k, n, matrix="lrc:<g>")`` works too (the error-correcting restore
path the repair engine uses — no GRS representation, so it corrects
through the support-enumeration/subset tiers like par1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from noise_ec_tpu_torch.codec.rs import Buffer, ReedSolomon
from noise_ec_tpu_torch.obs.registry import default_registry

__all__ = ["LocalReconstructionCode", "codec_for_code", "parse_code"]


def parse_code(code: str) -> Optional[int]:
    """Group count of an ``"lrc:<g>"`` code string; None for ``"rs"``.
    Raises on anything else (the stripe store's meta gate)."""
    if code in ("", "rs"):
        return None
    if code.startswith("lrc:"):
        g = int(code[len("lrc:"):])
        if g < 1:
            raise ValueError(f"bad LRC code {code!r}: groups must be >= 1")
        return g
    raise ValueError(f"unknown codec code {code!r} (want 'rs' or 'lrc:<g>')")


def codec_for_code(
    code: str, k: int, n: int, *, field: str = "gf256",
    backend: str = "device", device: str = "cuda",
) -> ReedSolomon:
    """Build the codec a stripe's ``code`` string names: plain RS for
    ``"rs"``, :class:`LocalReconstructionCode` for ``"lrc:<g>"`` — the
    one constructor the store, repair engine and converter share."""
    g = parse_code(code)
    if g is None:
        return ReedSolomon(k, n - k, field=field, backend=backend,
                           device=device)
    return LocalReconstructionCode(
        k, g, n - k - g, field=field, backend=backend, device=device
    )


class _LrcMetrics:
    """Cached registry children for the LRC repair-tier counters."""

    def __init__(self):
        reg = default_registry()
        self.repairs = {
            tier: reg.counter("noise_ec_lrc_repairs_total").labels(tier=tier)
            for tier in ("local", "global")
        }
        self.shards_read = {
            tier: reg.counter(
                "noise_ec_lrc_repair_shards_read_total"
            ).labels(tier=tier)
            for tier in ("local", "global")
        }

    def record(self, tier: str, heals: int, reads: int) -> None:
        if heals:
            self.repairs[tier].add(heals)
            self.shards_read[tier].add(reads)


class LocalReconstructionCode(ReedSolomon):
    """LRC(k data, g local groups, r global parities) — module docstring.

    ``n = k + g + r``; group size ``k // g``. The Encoder interface is
    inherited from :class:`ReedSolomon` over the ``"lrc:<g>"`` generator;
    this class adds the repair-tier policy (local-first reconstruct) and
    the per-tier fetch accounting the repair-storm bench gates."""

    def __init__(
        self,
        data_shards: int,
        local_groups: int,
        global_parities: int,
        *,
        field: str = "gf256",
        matrix: str = "cauchy",  # accepted for signature parity; unused
        backend: str = "device",
        device: str = "cuda",
    ):
        del matrix  # the LRC kind IS the matrix
        if local_groups < 1:
            raise ValueError(
                f"local_groups must be >= 1, got {local_groups}"
            )
        if data_shards % local_groups:
            raise ValueError(
                f"local_groups {local_groups} must divide "
                f"data_shards {data_shards}"
            )
        if global_parities < 1:
            raise ValueError(
                f"an LRC needs >= 1 global parity, got {global_parities}"
            )
        super().__init__(
            data_shards,
            local_groups + global_parities,
            field=field,
            matrix=f"lrc:{local_groups}",
            backend=backend,
            device=device,
        )
        self.g = local_groups
        self.r_global = global_parities
        self.group_size = data_shards // local_groups
        # The local heal IS this one tiny generator row: XOR over the
        # surviving cell members (all-ones coefficients). One shared
        # matrix means every local heal of this geometry lands in the
        # SAME coalescer bucket (rs._mul_key hashes the matrix bytes).
        self._local_row = np.ones((1, self.group_size), dtype=self.gf.dtype)
        self._metrics = _LrcMetrics()

    @property
    def code(self) -> str:
        """The stripe-store code string naming this geometry's kind."""
        return f"lrc:{self.g}"

    # ------------------------------------------------------------- layout

    def group_of(self, i: int) -> Optional[int]:
        """Group index of shard ``i`` (data or local parity); None for a
        global parity — global parities belong to no cell."""
        if not 0 <= i < self.n:
            raise ValueError(f"shard {i} out of range [0, {self.n})")
        if i < self.k:
            return i // self.group_size
        if i < self.k + self.g:
            return i - self.k
        return None

    def cell(self, group: int) -> List[int]:
        """One group cell: the group's data shards plus its local parity."""
        if not 0 <= group < self.g:
            raise ValueError(f"group {group} out of range [0, {self.g})")
        lo = group * self.group_size
        return list(range(lo, lo + self.group_size)) + [self.k + group]

    def local_basis(self, i: int, present) -> Optional[List[int]]:
        """The ``k/g``-shard read set healing shard ``i`` locally, or
        None when ``i`` is a global parity / its cell has another hole."""
        group = self.group_of(i)
        if group is None:
            return None
        basis = [m for m in self.cell(group) if m != i]
        if all(m in present for m in basis):
            return basis
        return None

    def repair_plan(self, present, missing) -> Optional[Dict[int, List[int]]]:
        """``{missing shard -> local basis}`` when EVERY missing shard
        heals inside its own cell; None means the loss pattern exceeds
        some group budget and the caller must reconstruct globally."""
        present = set(present) - set(missing)
        plan: Dict[int, List[int]] = {}
        for i in missing:
            basis = self.local_basis(i, present)
            if basis is None:
                return None
            plan[i] = basis
        return plan

    # ------------------------------------------------------------- repair

    def _reconstruct(
        self, shards: Sequence[Optional[Buffer]], wanted
    ) -> list:
        """Local-tier-first reconstruct: when every missing shard heals
        inside its cell, run ONE batched all-ones multiply over the
        surviving cell members (k/g reads per heal); otherwise fall back
        to the inherited global path (k reads per heal, subset search
        included). Per-tier heal/read counters feed the repair-storm
        bench's fetch-amplification stat."""
        arrs, _ = self._gather(shards, need_all=False)
        present = [i for i, a in enumerate(arrs) if a is not None]
        missing = [i for i in wanted if arrs[i] is None]
        if not missing:
            return [
                self._as_bytes_arr(a) if a is not None else None
                for a in arrs
            ]
        plan = self.repair_plan(present, missing)
        if plan is None:
            self._metrics.record(
                "global", len(missing),
                min(len(present), self.k) * len(missing),
            )
            return super()._reconstruct(shards, wanted)
        stacks = [
            np.stack([arrs[b] for b in plan[i]]) for i in missing
        ]
        filled = self.matmul_many(self._local_row, stacks)
        for i, rows in zip(missing, filled):
            arrs[i] = rows[0]
        self._metrics.record(
            "local", len(missing), sum(len(plan[i]) for i in missing)
        )
        return [
            self._as_bytes_arr(a) if a is not None else None for a in arrs
        ]

    def repair_many(
        self,
        members: Sequence[Sequence[Optional[bytes]]],
        trusted: Sequence[int],
        wanted: Sequence[int],
    ) -> list:
        """Batched repair for B same-pattern stripes (the repair
        engine's group drain): every (stripe, missing shard) pair whose
        cell survives rides ONE coalesced all-ones dispatch — B×|wanted|
        stacks through ``matmul_many``. Past-budget patterns take the
        per-stripe global reconstruct. Returns one ``{shard -> bytes}``
        dict per member."""
        trusted = sorted(set(trusted))
        wanted = [i for i in wanted if i not in trusted]
        dt = np.dtype("<u2") if self.gf.degree == 16 else np.dtype(np.uint8)
        plan = self.repair_plan(trusted, wanted)
        if plan is not None:
            order = [(b, i) for b in range(len(members)) for i in wanted]
            stacks = [
                np.stack([
                    np.frombuffer(members[b][m], dtype=np.uint8).view(dt)
                    for m in plan[i]
                ])
                for b, i in order
            ]
            filled = self.matmul_many(self._local_row, stacks)
            out: list = [dict() for _ in members]
            for (b, i), rows in zip(order, filled):
                out[b][i] = (
                    np.ascontiguousarray(rows[0]).view(np.uint8).tobytes()
                )
            self._metrics.record(
                "local",
                len(order),
                sum(len(plan[i]) for _, i in order),
            )
            return out
        out = []
        required = [i in wanted for i in range(self.n)]
        for shards in members:
            usable = [
                shards[i] if i in trusted else None for i in range(self.n)
            ]
            rows = self.reconstruct_some(usable, required)
            out.append({
                i: np.ascontiguousarray(rows[i]).view(np.uint8).tobytes()
                for i in wanted
            })
        return out
