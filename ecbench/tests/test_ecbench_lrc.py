"""A code that is not MDS: the reference's LRC(12,2,2) (``reference/lrc.py``)
against the port's generator and its own stored cells, its undecodable
patterns and its least read set, and a tiny LRC cell driven through the
closed loop on the CPU with the reference in the program's place."""

import collections
import itertools

import numpy as np
import pytest
import torch

from ecbench import control, harness, reference, roofline
from ecbench.reference import lrc
from ecbench.reference.gf256 import Field
from ecbench.tests.conftest import tiny_cell

K, R, G = 12, 4, 2
LRC = {"data_units": K, "parity_units": R, "field": "gf256",
       "field_poly": 0x11D, "generator": "lrc", "generator_args": {"groups": G},
       "program_matrix": "lrc:2"}


def _code():
    return reference.load(LRC)


def _patterns(e):
    return list(itertools.combinations(range(K + R), e))


@pytest.mark.parametrize("k,r,g", [(12, 4, 2), (4, 3, 2)])
def test_lrc_generator_equals_the_port(k, r, g):
    from noise_ec_tpu_torch.gf.field import GF256
    from noise_ec_tpu_torch.matrix.generators import generator_matrix

    ref = reference.load(dict(LRC, data_units=k, parity_units=r,
                              generator_args={"groups": g}))
    port = generator_matrix(GF256(), k, k + r, f"lrc:{g}")
    assert np.array_equal(ref.G, np.asarray(port))


def test_lrc_generator_from_its_definition():
    code = _code()
    Gm = code.G.astype(np.int64)
    assert np.array_equal(Gm[:K], np.eye(K))
    assert np.array_equal(Gm[K], [1] * 6 + [0] * 6)
    assert np.array_equal(Gm[K + 1], [0] * 6 + [1] * 6)
    f = Field()
    for i in range(R - G):
        for j in range(K):
            assert f.mul(Gm[K + G + i, j], (K + i) ^ j) == 1


@pytest.mark.parametrize("bad", [{"groups": 5}, {"groups": 4}, {"groups": 0},
                                 {"groups": "2"}, {"groups": True}])
def test_lrc_refuses_a_geometry_it_cannot_build(bad):
    with pytest.raises(ValueError):
        reference.load(dict(LRC, generator_args=bad))


def test_first_k_present_is_singular_where_the_basis_is_not():
    """The first k present cells, the basis of an MDS code, are singular
    on 6 of the 16 single losses and 54 of the 120 double losses; the basis
    of independent rows decodes each of them."""
    code = _code()
    f = code.field
    for e, singular in ((1, 6), (2, 54)):
        count = 0
        for lost in _patterns(e):
            present = [i for i in range(K + R) if i not in lost]
            try:
                f.inverse(code.G[present[:K]])
            except np.linalg.LinAlgError:
                count += 1
            code.basis(present)
        assert count == singular


def test_lrc_rebuilds_every_pattern_it_can():
    """Every pattern of up to 3 losses, and every decodable one of 4, is
    rebuilt bit-exact from its basis; 265 of the 1,820 patterns of 4 raise
    the named error."""
    code = _code()
    f = code.field
    data = np.random.default_rng(5).integers(0, 256, (K, 48))
    cells = f.matmul(code.G, data)
    undecodable = 0
    for e in range(R + 1):
        for lost in _patterns(e):
            present = [i for i in range(K + R) if i not in lost]
            try:
                basis, Rm = code.rebuild_matrix(present, lost)
            except reference.UndecodablePattern:
                assert e == R, lost
                undecodable += 1
                continue
            assert len(basis) == K and not set(basis) & set(lost)
            assert np.array_equal(f.matmul(Rm, cells[basis]),
                                  cells[list(lost)]), lost
    assert undecodable == 265


def _least_read(lost):
    """The least read set by hand: group j is data cells 6j..6j+5 and its
    local parity 12 + j."""
    group = {i: i // 6 for i in range(K)} | {K: 0, K + 1: 1}
    if lost and all(i in group for i in lost) and len(
            {group[i] for i in lost}) == len(lost):
        return min(K, 6 * len(lost))
    return K


@pytest.mark.parametrize("lost,read", [
    ((0,), 6), ((11,), 6), ((12,), 6), ((13,), 6), ((14,), 12), ((15,), 12),
    ((0, 6), 12), ((0, 13), 12), ((0, 1), 12), ((0, 12), 12),
    ((0, 14), 12), ((0, 7, 14), 12), ((), 12)])
def test_lrc_least_read(lost, read):
    assert _code().least_read(lost) == read == _least_read(lost)
    assert lrc.least_read(K, R, lost, groups=G) == read


# The tiny LRC cell: the HDFS cells' read and repair mixes over an LRC
# configuration built here, with the reference in the program's place (the
# port's words entries take the first k present cells as their basis, and
# no LRC cell is in BENCHMARK.json).

MIXES = {"read": "hdfs-rs-6-3.read", "repair": "hdfs-rs-10-4.repair"}
SEED = 2**31 + 11


def _lrc_cell(mix):
    cell = tiny_cell(MIXES[mix])
    cell.config = dict(LRC, name="lrc-12-2-2-tiny", cell_bytes=32768,
                       block_bytes=4 * 32768, resident_block_groups=2)
    return cell


def _reference_system(config, device):
    return reference.load(config)


@pytest.mark.parametrize("mix", MIXES)
def test_lrc_cell_with_the_reference_is_correct(mix):
    res = harness.run_cell(_lrc_cell(mix), SEED, 0.4, False, device="cpu",
                           system=_reference_system)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("mix", MIXES)
def test_lrc_cell_counts_the_least_read_set(mix):
    """Each request's least bytes read the code's least read set: 6 cells
    for a single loss in a whole group."""
    cell = _lrc_cell(mix)
    job = harness.Job(cell, SEED, 0.4, "cpu", _reference_system)
    driver = cell.driver.Driver(job)
    driver.setup()
    run = harness.Run(cell.name, cell.config, cell.traffic, "cpu")
    driver.window(run)
    assert not job.failures and len(run.done) == run.attempted
    unit = job.cell_bytes * job.stripes
    want = collections.Counter(
        (_least_read(job.mix.request(i).lost)
         + len(job.mix.request(i).lost)) * unit
        for i in range(run.attempted))
    assert collections.Counter(d.least_bytes for d in run.done) == want
    assert want[7 * unit] > 0
    assert roofline.rebuild_least_bytes(6, 1, 32768, 4) == 7 * unit


def test_the_field_control_leaves_a_local_heal_as_it_is():
    """A single loss in a group heals by the XOR of its group over 0x11B
    as over 0x11D: the field control cannot fail a cell whose answers are
    all local heals, as the read mix's nearly all are."""
    good = _code()
    aes = reference.load(LRC, field_poly=control.CONTROL_POLY)
    present = [i for i in range(K + R) if i != 3]
    assert good.rebuild_matrix(present, [3])[1].tolist() == \
        aes.rebuild_matrix(present, [3])[1].tolist() == [[1] * 5 + [0] * 6
                                                          + [1]]
    present = [i for i in range(K + R) if i != 14]
    assert not np.array_equal(good.rebuild_matrix(present, [14])[1],
                              aes.rebuild_matrix(present, [14])[1])


def test_lrc_cell_under_the_control_is_not_correct():
    """The repair mix under the control (the reference over 0x11B). A local
    row is the XOR of its group in every field of characteristic 2, so the
    control changes only answers that a global row rebuilds (a lost global
    parity, or two losses in one group); 40 answers checked hold some."""
    cell = _lrc_cell("repair")
    cell.traffic["check_answers"] = 40
    res = control.run(cell, SEED, 3.0, device="cpu")
    assert not res["correct"]
    assert res["checks"]["mismatched_bytes"]["value"] > 0
    assert res["checks"]["answers_checked"]["value"] == 40


def _broken_system(fault):
    def system(config, device):
        code = reference.load(config)
        real = code.rebuild

        def rebuild(survivors, Rm):
            out = real(survivors, Rm)
            if fault == "unchanged":
                return torch.zeros_like(out)
            if fault == "half":
                out[out.shape[0] // 2:] = 0
                return out
            out[0, 0].view(torch.uint8)[17] ^= 0x40
            return out

        code.rebuild = rebuild
        return code

    return system


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_lrc_cell_with_a_broken_product_is_not_correct(mix, fault):
    res = harness.run_cell(_lrc_cell(mix), SEED, 0.4, False, device="cpu",
                           system=_broken_system(fault))
    assert not res["correct"]
    assert res["checks"]["mismatched_bytes"]["value"] > 0
