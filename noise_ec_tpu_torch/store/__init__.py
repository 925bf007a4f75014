"""Stripe store: keep verified objects as erasure-coded stripes, scrub
them for rot, and repair lazily through batched device reconstructs.

The reference node throws verified objects away after reassembly
(main.go:90-93 logs and deletes the pool); a production erasure-coded
system keeps the stripes, detects corruption in the background, and
repairs at leisure — the scrub/repair role HDFS-EC and Ceph build around
their codecs. Three pieces:

- :class:`StripeStore` (stripe.py) — content-addressed stripe storage
  (keyed by the signature prefix obs tracing already uses), optional disk
  persistence, and the degraded-read API: an object is served
  byte-identically while only k..n-1 shards are present by reconstructing
  on demand.
- :class:`Scrubber` (scrub.py) — walks stripes at a configurable rate and
  runs the parity verify batched through the codec's device dispatch,
  flagging corrupt and missing shards into the repair queue.
- :class:`RepairEngine` (repair.py) — coalesces pending reconstructions
  by geometry into batched device dispatches (``parallel.batch``), writes
  repaired shards back, and falls back to anti-entropy shard fetch from
  peers over the existing SHARD transport opcode when local
  reconstruction is impossible (more than n-k shards lost). LRC stripes
  (codec/lrc.py, docs/lrc.md) heal single losses from ~k/g local group
  members instead of k.
- :class:`ConversionEngine` (convert.py) — the hot→archival policy loop
  (docs/lrc.md): merges cold narrow stripes into wide RS/LRC archival
  generations via device-side re-encode, swapping manifests atomically
  so degraded reads stay byte-identical across the boundary.

Wiring: ``host/plugin.py`` lands verified receives in the store and feeds
arriving shards to :meth:`StripeStore.note_shard`; ``host/cli.py`` exposes
``-store-dir`` / ``-scrub-interval``. See docs/store.md.
"""

from noise_ec_tpu_torch.store.convert import ConversionEngine, ConversionPolicy
from noise_ec_tpu_torch.store.repair import RepairEngine
from noise_ec_tpu_torch.store.scrub import Scrubber
from noise_ec_tpu_torch.store.stripe import (
    DegradedReadError,
    StripeMeta,
    StripeStore,
    UnknownStripeError,
)

__all__ = [
    "ConversionEngine",
    "ConversionPolicy",
    "DegradedReadError",
    "RepairEngine",
    "Scrubber",
    "StripeMeta",
    "StripeStore",
    "UnknownStripeError",
]
