"""The frozen reference against the definitions and, at tiny sizes on the
CPU, against the port's words entries."""

import itertools

import numpy as np
import pytest
import torch

from ecbench import reference
from ecbench.reference.cauchy import generator as cauchy_generator
from ecbench.reference.gf256 import Field
from ecbench.reference.words import matmul_words, xtime


def _config(k, r, **kw):
    cfg = {"data_units": k, "parity_units": r, "field": "gf256",
           "field_poly": 0x11D, "generator": "cauchy"}
    cfg.update(kw)
    return cfg


def test_field_known_values():
    f = Field()
    assert f.mul(2, 0x80) == 0x1D
    assert f.inv(2) == 0x8E
    aes = Field(0x11B)
    assert aes.mul(0x57, 0x83) == 0xC1
    assert aes.inv(0x53) == 0xCA


@pytest.mark.parametrize("poly", [0x11D, 0x11B])
def test_field_axioms(poly):
    f = Field(poly)
    a = np.arange(1, 256)
    assert np.all(f.mul(a, f.inv(a)) == 1)
    rng = np.random.default_rng(0)
    x, y, z = rng.integers(0, 256, (3, 4096))
    assert np.array_equal(f.mul(x, y ^ z), f.mul(x, y) ^ f.mul(x, z))
    assert np.array_equal(f.mul(f.mul(x, y), z), f.mul(x, f.mul(y, z)))


def test_reducible_poly_refused():
    with pytest.raises(ValueError):
        Field(0x100)


@pytest.mark.parametrize("k,r", [(10, 4), (6, 3)])
def test_cauchy_code_is_mds(k, r):
    f = Field()
    G = cauchy_generator(f, k, r)
    assert np.array_equal(G[:k], np.eye(k, dtype=np.uint8))
    for rows in itertools.combinations(range(k + r), k):
        inv = f.inverse(G[list(rows)])
        assert np.array_equal(f.matmul(G[list(rows)], inv), np.eye(k))


def test_rebuild_matrix_round_trip():
    code = reference.load(_config(10, 4))
    f = code.field
    data = np.random.default_rng(1).integers(0, 256, (10, 64))
    cells = f.matmul(code.G, data)
    lost = (2, 7, 11)
    present = [i for i in range(14) if i not in lost]
    basis, R = code.rebuild_matrix(present, lost)
    assert np.array_equal(f.matmul(R, cells[basis]), cells[list(lost)])


def _patterns(n, most):
    return [lost for e in range(most + 1)
            for lost in itertools.combinations(range(n), e)]


@pytest.mark.parametrize("k,r,count", [(10, 4, 1471), (6, 3, 130)])
def test_mds_basis_and_least_read_are_the_first_k(k, r, count):
    """For the HDFS codes the basis of independent rows is the first k
    present cells, the rebuild matrix is the one worked out from them and
    a rebuild reads k cells, over every pattern of up to r losses: what the
    HDFS cells check and count is what it was before codes that are not
    MDS came in."""
    code = reference.load(_config(k, r))
    f = code.field
    patterns = _patterns(k + r, r)
    assert len(patterns) == count
    for lost in patterns:
        present = [i for i in range(k + r) if i not in lost]
        first = sorted(present)[:k]
        basis, R = code.rebuild_matrix(present, lost)
        assert basis == first, lost
        assert np.array_equal(R, f.matmul(code.G[list(lost)],
                                          f.inverse(code.G[first]))), lost
        assert code.least_read(lost) == k


def test_too_few_cells_are_an_undecodable_pattern():
    code = reference.load(_config(6, 3))
    with pytest.raises(reference.UndecodablePattern, match="undecodable"):
        code.rebuild_matrix([0, 1, 2, 3, 4], [5])


@pytest.mark.parametrize("key,value", [("field", "gf65536"),
                                       ("generator", "vandermonde"),
                                       ("generator", "../harness")])
def test_reference_refuses_what_it_does_not_implement(key, value):
    with pytest.raises(ValueError, match="implements no"):
        reference.load(_config(6, 3, **{key: value}))


def test_reference_takes_the_stated_field():
    aes = reference.load(_config(6, 3, field_poly=0x11B))
    assert aes.field.poly == 0x11B
    assert np.array_equal(aes.G, cauchy_generator(Field(0x11B), 6, 3))
    assert not np.array_equal(aes.G, reference.load(_config(6, 3)).G)


def test_xtime_on_words():
    x = torch.tensor([-1, 0x7FFFFFFF, 0x01020380], dtype=torch.int32)
    got = [v & 0xFFFFFFFF for v in xtime(x, 0x11D).tolist()]
    assert got == [0xE3E3E3E3, 0xFEE3E3E3, 0x0204061D]


def test_matmul_words_against_field():
    f = Field()
    rng = np.random.default_rng(2)
    M = rng.integers(0, 256, (3, 5))
    sym = rng.integers(0, 256, (2, 5, 64), dtype=np.uint8)
    words = torch.from_numpy(sym.copy()).view(torch.int32)
    out = matmul_words(f.poly, M, words, block=1).view(torch.uint8).numpy()
    for b in range(2):
        assert np.array_equal(out[b], f.matmul(M, sym[b]))


def _words(B, rows, tw, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B * rows * tw * 4,), dtype=torch.uint8,
                         generator=g).view(torch.int32).view(B, rows, tw)


@pytest.mark.parametrize("k,r", [(10, 4), (6, 3)])
def test_reference_against_port(k, r):
    from noise_ec_tpu_torch.parallel.batch import BatchCodec

    port = BatchCodec(k, r, device="cpu")
    ref = reference.load(_config(k, r))
    assert np.array_equal(port.G, ref.G)
    data = _words(2, k, 8192, seed=k)
    cw = ref.encode_batch_words(data)
    assert torch.equal(port.encode_batch_words(data), cw)
    lost_sets = [x for e in (1, 2) for x in itertools.combinations(range(k + r), e)]
    lost_sets = lost_sets[::3] + [tuple(range(k, k + r)), tuple(range(r))]
    for lost in lost_sets:
        present = [i for i in range(k + r) if i not in lost]
        got = port.reconstruct_batch_words(cw[:, present], present)
        assert torch.equal(got, cw), lost
        assert torch.equal(ref.reconstruct_batch_words(cw[:, present],
                                                       present), cw), lost
