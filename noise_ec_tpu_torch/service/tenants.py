"""Tenant namespaces for the object service: quotas, geometry, and
replication targets.

A *tenant* is one namespace of the object API (``/objects/<tenant>/...``,
service/http.py): its own name space of objects, its own byte/object
quotas enforced at PUT admission, optionally its own erasure geometry
and a replication target (``replicas > 1`` pins the namespace's stripes
into the repair engine's announce loop so peers keep being re-offered
them — docs/object-service.md).

Two admission modes:

- **open** (the default, no config file): unknown tenant names are
  admitted with unlimited quotas — the single-operator dev posture;
- **closed** (``open_admission: false`` in the config, or
  ``TenantRegistry(open_admission=False)``): only configured tenants
  exist; a PUT under any other name is rejected before any work.

Quota semantics: ``max_bytes`` / ``max_objects`` of 0 mean unlimited.
Usage is the sum of *logical object sizes* (manifest ``size``), not the
erasure-expanded shard bytes — the number a user can reason about; the
n/k expansion factor is the operator's to budget. Checks happen at PUT
admission against the declared upload size, so an over-quota PUT is
refused before a single stripe is encoded.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = [
    "QuotaExceededError",
    "Tenant",
    "TenantRegistry",
    "UnknownTenantError",
]

TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class UnknownTenantError(KeyError):
    """Closed admission and the tenant is not configured."""


class QuotaExceededError(RuntimeError):
    """A PUT would push the tenant past its byte or object quota.

    ``reason`` is the bounded label the rejection counter uses
    (``quota_bytes`` | ``quota_objects``)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclass(frozen=True)
class Tenant:
    """One namespace's policy (all limits 0 = unlimited / default)."""

    name: str
    max_bytes: int = 0
    max_objects: int = 0
    # Desired copy count across the fleet. 1 = broadcast-once (peers
    # that were up got it); > 1 = the namespace's stripes are pinned
    # into the announce loop so late/partitioned peers converge.
    replicas: int = 1
    # Per-tenant erasure geometry; 0 = the service default.
    k: int = 0
    n: int = 0
    # Tenant policy string (docs/lrc.md archival grammar + the QoS
    # lane/weight grammar, docs/object-service.md "QoS lanes"; empty =
    # never convert, live lane, weight 1): e.g.
    # "archive=lrc:20/4+6,age=600,lane=background,weight=2". Both halves
    # are validated at configure time — an unknown archival tier, an
    # invalid LRC geometry (group count must divide k, >= 1 global
    # parity), an unknown lane or an out-of-range weight all fail HERE
    # with a clear ValueError, not in a background loop.
    policy: str = ""

    @property
    def lane(self) -> str:
        """QoS lane of this tenant's device-gate traffic ("live" |
        "background"; the ``lane=`` policy token, default live)."""
        from noise_ec_tpu_torch.store.convert import split_qos

        return split_qos(self.policy)[0]

    @property
    def weight(self) -> int:
        """Deficit-round-robin weight of this tenant's queue inside its
        lane (the ``weight=`` policy token, default 1)."""
        from noise_ec_tpu_torch.store.convert import split_qos

        return split_qos(self.policy)[1]


class TenantRegistry:
    """The configured tenant set + admission policy (module docstring)."""

    def __init__(
        self,
        tenants: Optional[Iterable[Tenant]] = None,
        *,
        open_admission: bool = True,
    ):
        self.open_admission = open_admission
        self._tenants: dict[str, Tenant] = {}
        for tenant in tenants or ():
            self._tenants[tenant.name] = tenant

    @classmethod
    def from_file(cls, path: str) -> "TenantRegistry":
        """Load a JSON config::

            {"open_admission": false,
             "tenants": {"acme": {"max_bytes": 1073741824,
                                  "max_objects": 10000,
                                  "replicas": 2, "k": 10, "n": 14,
                                  "policy": "archive=lrc:20/4+6,age=600"}}}
        """
        with open(path, "rb") as f:
            doc = json.load(f)
        reg = cls(open_admission=bool(doc.get("open_admission", True)))
        for name, spec in (doc.get("tenants") or {}).items():
            reg.configure(
                name,
                max_bytes=int(spec.get("max_bytes", 0)),
                max_objects=int(spec.get("max_objects", 0)),
                replicas=int(spec.get("replicas", 1)),
                k=int(spec.get("k", 0)),
                n=int(spec.get("n", 0)),
                policy=str(spec.get("policy", "")),
            )
        return reg

    def configure(self, name: str, **kwargs) -> Tenant:
        if not TENANT_NAME_RE.match(name):
            raise ValueError(f"bad tenant name {name!r}")
        tenant = Tenant(name=name, **kwargs)
        if tenant.k or tenant.n:
            if not 1 <= tenant.k <= tenant.n:
                raise ValueError(
                    f"tenant {name!r} geometry k={tenant.k} n={tenant.n} "
                    "is invalid (set both, 1 <= k <= n)"
                )
        if tenant.replicas < 1:
            raise ValueError(f"tenant {name!r} replicas must be >= 1")
        if tenant.policy:
            # Parse-time policy validation (docs/lrc.md archival grammar
            # + the QoS lane/weight grammar): an unknown archival tier,
            # an invalid LRC geometry, an unknown lane or a bad weight
            # must fail the configure call, not a background loop.
            from noise_ec_tpu_torch.store.convert import (
                ConversionPolicy,
                split_qos,
            )

            try:
                archival = split_qos(tenant.policy)[2]
                if archival:
                    ConversionPolicy.parse(archival)
            except ValueError as exc:
                raise ValueError(
                    f"tenant {name!r} policy {tenant.policy!r}: {exc}"
                ) from exc
        self._tenants[name] = tenant
        return tenant

    def get(self, name: str) -> Tenant:
        tenant = self._tenants.get(name)
        if tenant is not None:
            return tenant
        if not TENANT_NAME_RE.match(name):
            raise UnknownTenantError(name)
        if not self.open_admission:
            raise UnknownTenantError(name)
        return Tenant(name=name)

    def names(self) -> list[str]:
        return sorted(self._tenants)

    @staticmethod
    def admit(
        tenant: Tenant, used_bytes: int, used_objects: int, add_bytes: int
    ) -> None:
        """Raise :class:`QuotaExceededError` if adding one ``add_bytes``
        object would breach the tenant's quota."""
        if tenant.max_bytes and used_bytes + add_bytes > tenant.max_bytes:
            raise QuotaExceededError(
                "quota_bytes",
                f"tenant {tenant.name!r}: {used_bytes} + {add_bytes} bytes "
                f"exceeds the {tenant.max_bytes}-byte quota",
            )
        if tenant.max_objects and used_objects + 1 > tenant.max_objects:
            raise QuotaExceededError(
                "quota_objects",
                f"tenant {tenant.name!r}: already at the "
                f"{tenant.max_objects}-object quota",
            )
