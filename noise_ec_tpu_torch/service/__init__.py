"""Erasure-coded object service: the user-facing storage surface.

The stripe store promoted to a service for many users:
tenant-scoped PUT / GET / range-GET / DELETE / LIST over objects of
arbitrary size, each chunked into signed erasure-coded stripes that
replicate to peers through the existing plugin broadcast path and read
back degraded from any k-of-n shards — with per-tenant quotas and
SLO/device-memory admission control shedding PUTs before the device queue feels
them. Three pieces:

- :class:`ObjectStore` (objects.py) — the object layer: chunking,
  manifests, ranged degraded reads, admission;
- :class:`ObjectAPI` (http.py) — the ``/objects`` HTTP tree, mounted on
  the stats server's route table alongside ``/metrics`` + ``/healthz``;
- :class:`TenantRegistry` (tenants.py) — namespaces, quotas, geometry
  and replication targets.

Wiring: ``host/cli.py`` exposes ``-object-port`` / ``-tenants``.
See docs/object-service.md.
"""

from noise_ec_tpu_torch.service.cache import (
    WARMSET_MAGIC,
    DecodedObjectCache,
    PeerCacheDirectory,
)
from noise_ec_tpu_torch.service.http import ObjectAPI
from noise_ec_tpu_torch.service.objects import (
    MANIFEST_MAGIC,
    ObjectStore,
    ObjectUnavailableError,
    ShedError,
    UnknownObjectError,
)
from noise_ec_tpu_torch.service.tenants import (
    QuotaExceededError,
    Tenant,
    TenantRegistry,
    UnknownTenantError,
)

__all__ = [
    "DecodedObjectCache",
    "MANIFEST_MAGIC",
    "ObjectAPI",
    "ObjectStore",
    "PeerCacheDirectory",
    "WARMSET_MAGIC",
    "ObjectUnavailableError",
    "QuotaExceededError",
    "ShedError",
    "Tenant",
    "TenantRegistry",
    "UnknownObjectError",
    "UnknownTenantError",
]
