"""Identity and signing: Ed25519 over BLAKE2b-256.

Port of ``noise_ec_tpu.host.crypto``. Ed25519 runs on the ``cryptography``
package where it is installed, else on the pure-Python RFC 8032 backend
(host/_ed25519.py), as in the reference; :data:`ED25519_BACKEND` names the
one in use. Whole-object hashes run on the port's native shim, and a shim
that cannot be built or loaded raises (the reference drops to
``hashlib``).

Reproduces the reference's L1 crypto contract (SURVEY.md §2.3 D3):

- ``KeyPair.random()`` — fresh identity per run (main.go:132), hex
  accessors for key logging (main.go:134-135);
- ``keys.sign(sig_policy, hash_policy, msg)`` — Ed25519 signature over
  ``blake2b_256(msg)`` (main.go:219-223);
- ``verify(sig_policy, hash_policy, pubkey, msg, sig)`` (main.go:82-89);
- ``serialize_message(peer_id, message)`` — the canonical signing preimage
  ``u32le(len(addr)) ‖ addr ‖ u32le(len(id)) ‖ id ‖ message``
  (main.go:276-302). Used for both signing and verification, so sender and
  receiver must agree on the peer's address string and node id.

Policies are small strategy objects so alternate algorithms can slot in,
matching the reference's SignaturePolicy/HashPolicy injection points
(main.go:38-41, 45-46).
"""

from __future__ import annotations

import functools
import hashlib
import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Optional

try:  # OpenSSL-backed Ed25519: fast and constant-time. Preferred.
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_CRYPTOGRAPHY = True
except ImportError:  # hermetic images: the pure-Python RFC 8032 backend
    _HAVE_CRYPTOGRAPHY = False
    from noise_ec_tpu_torch.host import _ed25519 as _pyed

    logging.getLogger("noise_ec_tpu_torch.host").warning(
        "the 'cryptography' package is unavailable; Ed25519 falls back to "
        "the pure-Python backend (correct but slow and not constant-time "
        "— install cryptography for production use)"
    )

# Which Ed25519 implementation signs and verifies in this process.
ED25519_BACKEND = "cryptography" if _HAVE_CRYPTOGRAPHY else "pure-python"

__all__ = [
    "ED25519_BACKEND",
    "Blake2bPolicy",
    "Ed25519Policy",
    "KeyPair",
    "PeerID",
    "serialize_message",
    "verify",
]


class Blake2bPolicy:
    """BLAKE2b-256 hash policy (noise/crypto/blake2b.New()).

    Large inputs hash on the native shim's streaming BLAKE2b (AVX512VL
    rotates in the compression function — bit-identical to hashlib by RFC
    7693, cross-checked in tests/test_torch_shim.py) because whole-object
    sign and verify hashes dominate the host node's large-object stream
    path; small ones on hashlib. A shim that cannot be built or loaded
    raises ``ShimBuildError``.
    """

    digest_size = 32

    # Below this input size hashlib wins: the native path pays a ctypes
    # context allocate/marshal/free per hash, which beats the ~10% faster
    # compression function only when the payload amortizes it.
    NATIVE_MIN_BYTES = 1 << 18

    def _hasher(self, approx_size: Optional[int] = None):
        if approx_size is not None and approx_size < self.NATIVE_MIN_BYTES:
            return hashlib.blake2b(digest_size=self.digest_size)
        from noise_ec_tpu_torch.shim import native_blake2b

        return native_blake2b(self.digest_size)

    def hash_bytes(self, data: bytes) -> bytes:
        h = self._hasher(len(data))
        h.update(data)
        return h.digest()

    def hash_parts(self, parts) -> bytes:
        """Hash the concatenation of ``parts`` without materializing it:
        bit-identical to ``hash_bytes(b"".join(parts))`` (BLAKE2b is a
        streaming hash), but skips the join copy — the signing preimage
        is header + full message (serialize_message), so on large objects
        the join is a whole-object memcpy."""
        approx = None
        if isinstance(parts, (tuple, list)):
            approx = sum(len(p) for p in parts)
        h = self._hasher(approx)
        for p in parts:
            h.update(p)
        return h.digest()


@functools.lru_cache(maxsize=1024)
def _parsed_public_key(public_key: bytes) -> "Ed25519PublicKey":
    """Parsed peer key, LRU-cached: reconstructing the object per verify
    cost ~35 us/message and a node talks to a small stable peer set."""
    return Ed25519PublicKey.from_public_bytes(public_key)


class Ed25519Policy:
    """Ed25519 signature policy (noise/crypto/ed25519.New())."""

    private_key_size = 32
    public_key_size = 32
    signature_size = 64

    def __init__(self) -> None:
        # Parsed signing keys cached PER POLICY INSTANCE, not in a module
        # global: a global cache keyed by the raw seed pins key material
        # beyond the owning KeyPair's lifetime and leaves it reachable via
        # cache introspection. Discarding the policy (the
        # plugin holds it) releases the parsed keys with it. Tiny bound:
        # a node signs with its own few identities. Locked: one policy
        # instance signs from the transport's asyncio thread AND the
        # dispatch worker pool concurrently, and the LRU re-append
        # mutates the dict on every call.
        self._parsed_priv: dict[bytes, Ed25519PrivateKey] = {}
        self._priv_lock = threading.Lock()

    def sign(self, private_key: bytes, message: bytes) -> bytes:
        seed = bytes(private_key)
        with self._priv_lock:
            pk = self._parsed_priv.pop(seed, None)
            if pk is None:
                if len(self._parsed_priv) >= 8:
                    # Evict the LEAST-recently-used entry (insertion
                    # order + re-append-on-hit), so churning transient
                    # seeds cannot push out the node's hot identity.
                    self._parsed_priv.pop(next(iter(self._parsed_priv)))
                pk = (
                    Ed25519PrivateKey.from_private_bytes(seed)
                    if _HAVE_CRYPTOGRAPHY
                    else _pyed.SigningKey(seed)
                )
            self._parsed_priv[seed] = pk
        return pk.sign(message)

    def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        if len(public_key) != self.public_key_size:
            return False
        if not _HAVE_CRYPTOGRAPHY:
            return _pyed.verify(bytes(public_key), message, signature)
        try:
            _parsed_public_key(bytes(public_key)).verify(signature, message)
            return True
        except (InvalidSignature, ValueError):
            return False

    def verify_batch(self, items) -> list[bool]:
        """Per-item verdicts for ``[(public_key, message, signature),
        ...]``, amortizing whatever the backend can share — the wire hot
        loop's drain-quantum verify stage (docs/design.md §15).

        The verdict list is identical to ``[self.verify(*it) for it in
        items]``: the pure-Python backend runs true batch verification
        (one random-linear-combination equation with shared doublings)
        and fans back to per-item checks when the combined equation
        fails, so one bad signature never poisons its cohort; the
        OpenSSL backend has no batch entry point, so its amortization is
        the parsed-key LRU plus one call boundary per cohort."""
        items = list(items)
        if not _HAVE_CRYPTOGRAPHY:
            return _pyed.verify_batch(items)
        return [self.verify(pk, msg, sig) for pk, msg, sig in items]


@dataclass(frozen=True)
class KeyPair:
    """An Ed25519 identity (noise/crypto.KeyPair)."""

    private_key: bytes  # 32-byte seed
    public_key: bytes

    @classmethod
    def random(cls) -> "KeyPair":
        """Fresh identity, regenerated per run like the reference
        (ed25519.RandomKeyPair(), main.go:132)."""
        return cls.from_seed(os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "KeyPair":
        if not _HAVE_CRYPTOGRAPHY:
            return cls(private_key=seed, public_key=_pyed.public_from_seed(seed))
        sk = Ed25519PrivateKey.from_private_bytes(seed)
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        return cls(
            private_key=seed,
            public_key=sk.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw),
        )

    def private_key_hex(self) -> str:
        return self.private_key.hex()

    def public_key_hex(self) -> str:
        return self.public_key.hex()

    def sign(
        self, sig_policy: Ed25519Policy, hash_policy: Blake2bPolicy, message: bytes
    ) -> bytes:
        """Sign ``hash(message)`` — keys.Sign(sigPolicy, hashPolicy, msg),
        main.go:219-223."""
        return sig_policy.sign(self.private_key, hash_policy.hash_bytes(message))

    def sign_parts(
        self, sig_policy: Ed25519Policy, hash_policy: Blake2bPolicy, parts
    ) -> bytes:
        """``sign`` over the concatenation of ``parts`` (same signature
        bytes, no join copy)."""
        return sig_policy.sign(self.private_key, hash_policy.hash_parts(parts))


def verify(
    sig_policy: Ed25519Policy,
    hash_policy: Blake2bPolicy,
    public_key: bytes,
    message: bytes,
    signature: bytes,
) -> bool:
    """crypto.Verify(sigPolicy, hashPolicy, pubkey, msg, sig) — main.go:82-89."""
    return sig_policy.verify(public_key, hash_policy.hash_bytes(message), signature)


def verify_parts(
    sig_policy: Ed25519Policy,
    hash_policy: Blake2bPolicy,
    public_key: bytes,
    parts,
    signature: bytes,
) -> bool:
    """``verify`` over the concatenation of ``parts`` (no join copy)."""
    return sig_policy.verify(public_key, hash_policy.hash_parts(parts), signature)


@dataclass(frozen=True)
class PeerID:
    """Node identity on the wire (noise peer.ID: Address, Id, PublicKey).

    ``node_id`` is the BLAKE2b-256 hash of the public key, as in noise's
    peer.CreateID.
    """

    address: str
    node_id: bytes
    public_key: bytes

    @classmethod
    def create(cls, address: str, public_key: bytes) -> "PeerID":
        return cls(
            address=address,
            node_id=Blake2bPolicy().hash_bytes(public_key),
            public_key=public_key,
        )


def serialize_message(peer_id: PeerID, message: bytes) -> bytes:
    """Canonical signing preimage (main.go:276-302):
    ``u32le(len(addr)) ‖ addr ‖ u32le(len(id)) ‖ id ‖ message``.

    The reference panics if the assembled buffer length mismatches the
    precomputed size (main.go:297-299); here the construction makes that
    impossible by design.
    """
    return b"".join(serialize_message_parts(peer_id, message))


def serialize_message_parts(peer_id: PeerID, message: bytes) -> tuple:
    """``serialize_message`` as (header, message) parts — lets callers
    hash/sign the preimage without the whole-message join copy
    (``hash_parts``); the digest is identical by BLAKE2b streaming."""
    addr = peer_id.address.encode("utf-8")
    header = b"".join(
        [
            struct.pack("<I", len(addr)),
            addr,
            struct.pack("<I", len(peer_id.node_id)),
            peer_id.node_id,
        ]
    )
    return (header, message)
