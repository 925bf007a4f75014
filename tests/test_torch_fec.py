"""The port's infectious-style codec against the reference: ``GoldenCodec``
(the port's NumPy copy) against the reference's, ``FEC`` on
``device="cpu"`` with ``bw_route="device"`` (the decode's products through
``DeviceCodec``, its kernels' plain versions here) and ``bw_route="host"``
(NumPy) against the reference's ``FEC(backend="numpy")``, and the
``DeviceCodec`` decode entries (``syndrome_stripes``, ``decode1_words``,
``decode1_words_bytesliced``) against the reference's
``DeviceCodec(kernel="pallas_interpret")``. Tolerance: byte-identical
throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.codec.fec import FEC as RefFEC
from noise_ec_tpu.codec.fec import Share as RefShare
from noise_ec_tpu.golden.codec import GoldenCodec as RefGolden
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu_torch.codec import (
    FEC,
    NotEnoughShardsError,
    Share,
    TooManyErrorsError,
)
from noise_ec_tpu_torch.golden import GoldenCodec
from noise_ec_tpu_torch.matrix.bw import _syndrome
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec, decode1_fold_matrix
from noise_ec_tpu_torch.ops.pack import pack_u16_bytesliced

ROUTES = ("device", "host")


def _flip(shares, nums, byte=0x3C):
    """Each share in ``nums`` wholly corrupted (every byte XORed)."""
    return [
        Share(s.number, (np.frombuffer(s.data, np.uint8) ^ byte).tobytes())
        if s.number in nums else s
        for s in shares
    ]


def _scatter(rng, shares, cols, e):
    """Corrupt ``cols`` random byte columns, each in 1..e random shares
    (within the radius when e <= (m - k) // 2)."""
    rows = [bytearray(s.data) for s in shares]
    for c in rng.choice(len(rows[0]), size=cols, replace=False):
        for i in rng.choice(len(rows), size=int(rng.integers(1, e + 1)),
                            replace=False):
            rows[i][c] ^= int(rng.integers(1, 256))
    return [Share(s.number, bytes(r)) for s, r in zip(shares, rows)]


def _ref(shares):
    return [RefShare(s.number, s.data) for s in shares]


# ------------------------------------------------------------ golden codec


@pytest.mark.parametrize("field, matrix", [("gf256", "cauchy"),
                                           ("gf256", "par1"),
                                           ("gf65536", "cauchy")])
def test_golden_codec_matches_reference(rng, field, matrix):
    k, n, S = 5, 9, 64
    ours, ref = GoldenCodec(k, n, field, matrix), RefGolden(k, n, field, matrix)
    np.testing.assert_array_equal(ours.G, ref.G)
    hi = 256 if field == "gf256" else 1 << 16
    data = rng.integers(0, hi, size=(k, S)).astype(ours.gf.dtype)
    cw = ours.encode_all(data)
    np.testing.assert_array_equal(cw, ref.encode_all(data))
    np.testing.assert_array_equal(ours.encode(data), ref.encode(data))
    holes = [None if i in (0, 3, 7) else cw[i] for i in range(n)]
    for a, b in zip(ours.reconstruct(list(holes)), ref.reconstruct(list(holes))):
        np.testing.assert_array_equal(a, b)
    bad = [(i, cw[i] ^ 1 if i == 2 else cw[i]) for i in range(n)]
    np.testing.assert_array_equal(ours.decode_shares(bad), data)
    np.testing.assert_array_equal(ours.decode_shares(bad),
                                  ref.decode_shares(bad))
    with pytest.raises(NotEnoughShardsError):
        ours.decode_shares(bad[:k - 1])


# --------------------------------------------------------------------- FEC


@pytest.mark.parametrize("route", ROUTES)
def test_fec_decode_cases_match_reference(rng, route):
    """In-order k shares (the systematic shortcut), scattered corruption
    within the radius (the syndrome path), par1, and beyond the radius
    (raises), each against the reference's numpy codec."""
    fec = FEC(6, 10, bw_route=route, device="cpu")
    ref = RefFEC(6, 10, backend="numpy")
    data = rng.integers(0, 256, size=6 * 4096, dtype=np.uint8).tobytes()
    shares = fec.encode_shares(data)
    assert [s.data for s in shares] == [s.data for s in
                                        ref.encode_shares(data)]
    assert fec.decode(shares[:6]) == data
    assert fec.stats["fast_decodes"] == 1
    bad = _scatter(rng, shares, 300, 2)
    assert fec.decode(bad) == data == ref.decode(_ref(bad))
    assert fec.stats["bw_decodes"] == 1
    # Two wholly corrupt shares with only two to spare... and three.
    assert fec.decode(_flip(shares, {1, 7})) == data
    with pytest.raises(TooManyErrorsError):
        fec.decode(_flip(shares, {0, 4, 8}))
    with pytest.raises(NotEnoughShardsError):
        fec.decode(shares[:5])

    par1 = FEC(4, 8, matrix="par1", bw_route=route, device="cpu")
    ref1 = RefFEC(4, 8, matrix="par1", backend="numpy")
    data = rng.integers(0, 256, size=4 * 512, dtype=np.uint8).tobytes()
    shares = par1.encode_shares(data)
    bad = _flip(shares, {2})
    assert par1.decode(bad) == data == ref1.decode(_ref(bad))


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_fec_whole_share_corruption_at_speculation_width(rng, field):
    """One wholly corrupt share at 256 KiB shares arms the decode1
    speculation: the device route runs the fold as one product, the host
    route the generic syndrome path; both return the payload, as the
    reference does, with equal stats."""
    k, n = 10, 14
    data = rng.integers(0, 256, size=k * (256 << 10),
                        dtype=np.uint8).tobytes()
    fecs = {route: FEC(k, n, field=field, bw_route=route, device="cpu")
            for route in ROUTES}
    shares = fecs["host"].encode_shares(data)
    assert [s.data for s in shares] == [s.data for s in
                                        fecs["device"].encode_shares(data)]
    bad = _flip(shares, {3})
    for fec in fecs.values():
        assert fec.decode(bad) == data
    if field == "gf256":
        assert RefFEC(k, n, backend="numpy").decode(_ref(bad)) == data
    assert fecs["device"].stats == fecs["host"].stats == {
        "fast_decodes": 0, "bw_decodes": 1, "subset_decodes": 0}


def test_fec_device_route_runs_the_products_on_the_codec(rng, monkeypatch):
    """bw_route="device" sends the decode1 fold (whole-share corruption)
    and the [A | I] syndrome (scattered corruption) through the
    DeviceCodec; "host" sends no decode product there."""
    calls = []
    real = DeviceCodec.matmul_stripes

    def counted(self, M, D, **kw):
        calls.append(np.asarray(M).copy())
        return real(self, M, D, **kw)

    monkeypatch.setattr(DeviceCodec, "matmul_stripes", counted)
    data = rng.integers(0, 256, size=10 * (256 << 10),
                        dtype=np.uint8).tobytes()
    for route in ROUTES:
        fec = FEC(10, 14, bw_route=route, device="cpu")
        A = fec._golden.G[10:]  # the basis is the data rows
        want = [] if route == "host" else [
            decode1_fold_matrix(fec._rs._dev.gf, A, 2),
            np.concatenate([A, np.eye(4, dtype=np.uint8)], axis=1)]
        shares = fec.encode_shares(data)
        calls.clear()
        assert fec.decode(_flip(shares, {2})) == data
        assert fec.decode(_scatter(rng, shares, 50, 1)) == data
        assert len(calls) == len(want)
        for got, M in zip(calls, want):
            np.testing.assert_array_equal(got, M)


def test_fec_stats_equal_on_both_routes(rng):
    fecs = [FEC(6, 10, bw_route=route, device="cpu") for route in ROUTES]
    data = rng.integers(0, 256, size=6 * 2048, dtype=np.uint8).tobytes()
    shares = fecs[0].encode_shares(data)
    cases = [shares, shares[:6], shares[2:], _flip(shares, {5}),
             _scatter(rng, shares, 40, 2)]
    for fec in fecs:
        for case in cases:
            assert fec.decode(case) == data
    assert fecs[0].stats == fecs[1].stats
    assert fecs[0].stats["bw_decodes"] == 2


def test_fec_validation():
    with pytest.raises(ValueError, match="bw_route"):
        FEC(4, 6, bw_route="elsewhere", device="cpu")
    with pytest.raises(ValueError, match="requires backend"):
        FEC(4, 6, backend="numpy", bw_route="device")
    fec = FEC(4, 6, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        fec.encode_shares(b"abc")
    with pytest.raises(ValueError, match="conflicting"):
        fec.decode([Share(0, b"ab"), Share(0, b"ba"), Share(1, b"cd"),
                    Share(2, b"ef"), Share(3, b"gh")])


# ------------------------------------------- DeviceCodec decode entries


def _codeword(k, n, S, rng, field="gf256"):
    gold = GoldenCodec(k, n, field=field)
    hi = 256 if field == "gf256" else 1 << 16
    data = rng.integers(0, hi, size=(k, S)).astype(gold.gf.dtype)
    return gold, data, gold.encode_all(data)


def test_syndrome_stripes_matches_reference_and_host(rng):
    k, r2, S = 6, 4, 2048
    A = rng.integers(0, 256, size=(r2, k)).astype(np.uint8)
    rows = rng.integers(0, 256, size=(k + r2, S)).astype(np.uint8)
    dev = DeviceCodec(device="cpu")
    s, counts = dev.syndrome_stripes(A, rows)
    host_s, host_counts = _syndrome(dev.gf, A, list(rows), k)
    ref_s, ref_counts = RefDeviceCodec(
        field="gf256", kernel="pallas_interpret").syndrome_stripes(A, rows)
    for want_s, want_c in ((host_s, host_counts), (ref_s, ref_counts)):
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(counts, want_c)


def test_decode1_words_matches_reference_interpret(rng):
    k, n, S = 10, 14, 4096
    gold, data, cw = _codeword(k, n, S, rng)
    cw[2] ^= 0xA5  # whole-share corruption
    cw[7, rng.integers(0, S, 25)] ^= 0x11  # mixed columns
    A = np.ascontiguousarray(gold.G[k:])
    dev = DeviceCodec(device="cpu")
    words = np.ascontiguousarray(cw).view("<u4")
    c, bad = dev.decode1_words(A, 2, torch.from_numpy(words.view(np.int32)))
    ref_c, ref_bad = RefDeviceCodec(
        field="gf256", kernel="pallas_interpret").decode1_words(
            A, 2, jnp.asarray(words))
    np.testing.assert_array_equal(c.numpy().view(np.uint32),
                                  np.asarray(ref_c))
    np.testing.assert_array_equal(bad.numpy().view(np.uint32),
                                  np.asarray(ref_bad))
    ok = bad.numpy().view(np.uint8) == 0
    assert 0 < ok.sum() < S
    np.testing.assert_array_equal(c.numpy().view(np.uint8)[ok], data[2][ok])


def test_decode1_words_bytesliced_matches_reference_interpret(rng):
    k, n, S = 4, 8, 1024
    gold, data, cw = _codeword(k, n, S, rng, field="gf65536")
    cw[1] ^= 0x1234
    A = np.ascontiguousarray(gold.G[k:])
    words = pack_u16_bytesliced(cw).view("<u4")  # (2n, S/2) byte rows
    dev = DeviceCodec(field="gf65536", device="cpu")
    c, bad = dev.decode1_words_bytesliced(
        A, 1, torch.from_numpy(np.ascontiguousarray(words).view(np.int32)))
    ref_c, ref_bad = RefDeviceCodec(
        field="gf65536", kernel="pallas_interpret").decode1_words_bytesliced(
            A, 1, jnp.asarray(words))
    np.testing.assert_array_equal(c.numpy().view(np.uint32),
                                  np.asarray(ref_c))
    np.testing.assert_array_equal(bad.numpy().view(np.uint32),
                                  np.asarray(ref_bad))
    assert not bad.any()
    np.testing.assert_array_equal(
        c.numpy().view(np.uint8), pack_u16_bytesliced(data[1:2]))


def test_decode1_refuses_a_single_check_row(rng):
    """r2 = 1 leaves no consistency rows: an all-zero mask would falsely
    claim every column verified."""
    dev = DeviceCodec(device="cpu")
    A = rng.integers(1, 256, size=(1, 4)).astype(np.uint8)
    with pytest.raises(ValueError, match="check rows"):
        decode1_fold_matrix(dev.gf, A, 2)
    with pytest.raises(ValueError, match="check rows"):
        dev.decode1_words(A, 2, torch.zeros((5, 256), dtype=torch.int32))
