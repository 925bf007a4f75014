"""The port's locally-repairable code on the CPU against the JAX
package's ``LocalReconstructionCode(backend="numpy")``: encode, verify,
every single loss (local tier), past-budget losses (global tier), mixed
patterns and ``repair_many``, byte for byte in both fields, with the same
per-tier repair counters; and ``codec_for_code`` / ``parse_code``."""

import numpy as np
import pytest

import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu.codec.lrc import (
    LocalReconstructionCode as RefLRC,
    codec_for_code as ref_codec_for_code,
    parse_code as ref_parse_code,
)
from noise_ec_tpu_torch.codec import (
    LocalReconstructionCode,
    ReedSolomon,
    codec_for_code,
    parse_code,
)


@pytest.fixture(autouse=True)
def _isolate_port_registry():
    port_registry.default_registry().reset_values()
    yield


def _as_bytes(row) -> bytes:
    return bytes(np.ascontiguousarray(row).view(np.uint8))


def _tiers(registry) -> tuple:
    """(local heals, global heals, local reads, global reads)."""
    reg = registry.default_registry()
    rep = reg.counter("noise_ec_lrc_repairs_total")
    reads = reg.counter("noise_ec_lrc_repair_shards_read_total")
    return tuple(fam.labels(tier=t).value for fam in (rep, reads)
                 for t in ("local", "global"))


class _Pair:
    """The port's LRC (``backend``) beside the reference's numpy one, with
    each side's tier counters read as deltas."""

    def __init__(self, k, g, r, field, backend):
        kw = {"device": "cpu"} if backend == "device" else {}
        self.port = LocalReconstructionCode(k, g, r, field=field,
                                            backend=backend, **kw)
        self.ref = RefLRC(k, g, r, field=field, backend="numpy")
        self._p0 = _tiers(port_registry)
        self._r0 = _tiers(ref_registry)

    def deltas(self):
        p = tuple(a - b for a, b in zip(_tiers(port_registry), self._p0))
        r = tuple(a - b for a, b in zip(_tiers(ref_registry), self._r0))
        return p, r

    def encode(self, data):
        got = [_as_bytes(s) for s in self.port.encode(data)]
        want = [_as_bytes(s) for s in self.ref.encode(data)]
        assert got == want
        assert self.port.verify(got) and self.ref.verify(want)
        return got

    def reconstruct(self, shards, **kw):
        got = self.port.reconstruct(shards, **kw)
        want = self.ref.reconstruct(shards, **kw)
        assert [None if s is None else _as_bytes(s) for s in got] == \
            [None if s is None else _as_bytes(s) for s in want]
        return got


BACKENDS = ["device", "numpy"]
FIELDS = [("gf256", 1), ("gf65536", 2)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("field,scale", FIELDS)
def test_every_single_loss_matches_the_reference(rng, field, scale,
                                                 backend):
    pair = _Pair(8, 2, 3, field, backend)
    data = [bytes(rng.integers(0, 256, 32 * scale, dtype=np.uint8))
            for _ in range(8)]
    full = pair.encode(data)
    for lost in range(pair.port.n):
        shards = list(full)
        shards[lost] = None
        out = pair.reconstruct(shards)
        assert _as_bytes(out[lost]) == full[lost]
    p, r = pair.deltas()
    assert p == r
    # 10 cell members heal locally from 4 reads each; 3 globals globally.
    assert p == (10, 3, 40, 3 * 8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("field,scale", FIELDS)
def test_tier_fallbacks_match_the_reference(rng, field, scale, backend):
    """Two losses in one cell go global, losses in different cells stay
    local, and r_global + 1 arbitrary erasures recover, as in the
    reference (tests/test_lrc.py's cases)."""
    pair = _Pair(8, 2, 3, field, backend)
    data = [bytes(rng.integers(0, 256, 24 * scale, dtype=np.uint8))
            for _ in range(8)]
    full = pair.encode(data)
    lrc = pair.port
    assert lrc.repair_plan(set(range(lrc.n)) - {0, 8}, [0, 8]) is None
    assert lrc.repair_plan(set(range(lrc.n)) - {0, 8}, [0, 8]) == \
        pair.ref.repair_plan(set(range(lrc.n)) - {0, 8}, [0, 8])
    plan = lrc.repair_plan(set(range(lrc.n)) - {0, 5}, [0, 5])
    assert plan == pair.ref.repair_plan(set(range(lrc.n)) - {0, 5}, [0, 5])
    assert len(plan[0]) == len(plan[5]) == 4
    for lost in ({0, 8}, {0, 5}, {1, 2, 9, 10}, {3, 7, 11, 12}):
        shards = [None if i in lost else s for i, s in enumerate(full)]
        out = pair.reconstruct(shards)
        assert [_as_bytes(s) for s in out] == full
        out = pair.reconstruct(shards, data_only=True)
        assert [_as_bytes(s) for s in out[:8]] == full[:8]
    p, r = pair.deltas()
    assert p == r


@pytest.mark.parametrize("backend", BACKENDS)
def test_local_reads_are_group_sized(rng, backend):
    pair = _Pair(12, 3, 2, "gf256", backend)
    data = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(12)]
    full = pair.encode(data)
    shards = list(full)
    shards[5] = None
    pair.reconstruct(shards)
    p, r = pair.deltas()
    assert p == r == (1, 0, 4, 0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("field,scale", FIELDS)
def test_repair_many_matches_the_reference(rng, field, scale, backend):
    """A batch of same-pattern stripes through repair_many, on the local
    tier and past the budget, equals the reference's batch and the
    per-stripe truth."""
    pair = _Pair(8, 2, 2, field, backend)
    for lost in ((2, 6), (0, 8)):
        members, truths = [], []
        for _ in range(5):
            data = [bytes(rng.integers(0, 256, 16 * scale, dtype=np.uint8))
                    for _ in range(8)]
            full = pair.encode(data)
            truths.append(full)
            members.append([None if i in lost else s
                            for i, s in enumerate(full)])
        trusted = [i for i in range(pair.port.n) if i not in lost]
        got = pair.port.repair_many(members, trusted, list(lost))
        want = pair.ref.repair_many(members, trusted, list(lost))
        assert got == want
        for full, out in zip(truths, got):
            assert all(out[i] == full[i] for i in lost)
    p, r = pair.deltas()
    assert p == r
    assert p[0] == 10 and p[2] == 10 * 4  # the local batch: 5 x 2 heals


def test_constructor_validation_and_layout():
    for args, match in (((8, 3, 2), "divide"), ((8, 2, 0), "global parity"),
                        ((8, 0, 2), ">= 1")):
        with pytest.raises(ValueError, match=match):
            LocalReconstructionCode(*args, backend="numpy")
    lrc = LocalReconstructionCode(12, 3, 2, backend="numpy")
    ref = RefLRC(12, 3, 2, backend="numpy")
    assert np.array_equal(lrc.G, ref.G)
    assert lrc.code == ref.code == "lrc:3"
    assert [lrc.group_of(i) for i in range(lrc.n)] == \
        [ref.group_of(i) for i in range(ref.n)]
    assert [lrc.cell(g) for g in range(3)] == [ref.cell(g) for g in range(3)]


def test_device_is_the_default():
    """Both constructors default to the card: on a host without one they
    raise, as every entry point of the port does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalReconstructionCode(8, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec_for_code("lrc:2", 8, 12)
    assert isinstance(codec_for_code("lrc:2", 8, 12, device="cpu"),
                      LocalReconstructionCode)
    assert codec_for_code("lrc:2", 8, 12, device="cpu")._dev.device.type \
        == "cpu"


@pytest.mark.parametrize("code", ["", "rs", "lrc:1", "lrc:4", "lrc:0",
                                  "lrc:x", "zstd"])
def test_parse_code_matches_the_reference(code):
    try:
        want = ref_parse_code(code)
    except ValueError as exc:
        with pytest.raises(type(exc)):
            parse_code(code)
    else:
        assert parse_code(code) == want


@pytest.mark.parametrize("code,k,n", [("rs", 4, 6), ("lrc:2", 8, 12),
                                      ("lrc:4", 12, 18)])
def test_codec_for_code_matches_the_reference(rng, code, k, n):
    got = codec_for_code(code, k, n, backend="numpy")
    want = ref_codec_for_code(code, k, n, backend="numpy")
    assert type(got).__name__ == type(want).__name__
    assert (got.k, got.n) == (want.k, want.n)
    assert np.array_equal(got.G, want.G)
    assert isinstance(got, ReedSolomon)
    data = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(k)]
    assert [_as_bytes(s) for s in got.encode(data)] == \
        [_as_bytes(s) for s in want.encode(data)]
