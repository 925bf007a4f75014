"""The frozen roofline byte counts and the erasure-mix sampler."""

import numpy as np
import pytest

from ecbench import roofline, spec
from ecbench.traffic import BLOCK, Mix, class_counts

MIB = 1 << 20


def test_least_bytes_of_the_four_cells():
    # hdfs-rs-10-4.write and hdfs-rs-6-3.write: one call of 32 stripes.
    assert roofline.encode_least_bytes(10, 4, MIB, 32) == 14 * 32 * MIB
    assert roofline.encode_least_bytes(6, 3, MIB, 32) == 9 * 32 * MIB
    # hdfs-rs-6-3.read: a block group of 128 stripes, 1 to 3 cells lost.
    assert roofline.rebuild_least_bytes(6, 1, MIB, 128) == 7 * 128 * MIB
    assert roofline.rebuild_least_bytes(6, 3, MIB, 128) == 9 * 128 * MIB
    # hdfs-rs-10-4.repair.
    assert roofline.rebuild_least_bytes(10, 1, MIB, 128) == 11 * 128 * MIB
    assert roofline.rebuild_least_bytes(10, 2, MIB, 128) == 12 * 128 * MIB


def test_roofline_share():
    peak = roofline.PEAK_HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"]
    assert roofline.roofline_share(peak, 2.0, "NVIDIA H100 80GB HBM3") == 50.0
    assert roofline.roofline_share(1e9, 1.0, "cpu") is None
    assert roofline.roofline_share(1e9, 0.0, "NVIDIA H100 80GB HBM3") is None


def test_class_counts_sum_and_shares():
    counts = class_counts({1: 0.9808, 2: 0.0187, 3: 0.0005}, BLOCK)
    assert counts == {1: 9808, 2: 187, 3: 5}
    assert sum(class_counts({1: 0.5, 2: 0.25, 3: 0.25}, 7).values()) == 7


def _mix(cell: str, seed: int) -> Mix:
    c = spec.load_cell(cell)
    return Mix(c.traffic, c.config, seed)


@pytest.mark.parametrize("cell", ["hdfs-rs-6-3.read", "hdfs-rs-10-4.repair"])
def test_sampler_shares_over_many_draws(cell):
    mix = _mix(cell, 2**31 + 11)
    n = 3 * BLOCK
    sizes = np.array([len(mix.request(i).lost) for i in range(n)])
    shares = {1: 0.9808, 2: 0.0187, 3: 0.0005}
    for e, p in shares.items():
        assert (sizes == e).sum() == round(p * n)
        # Stratified: every prefix holds its share to within two requests.
        prefix = np.cumsum(sizes == e)
        expect = p * np.arange(1, n + 1)
        assert np.abs(prefix - expect).max() <= 2.0
    groups = np.array([mix.request(i).group for i in range(n)])
    assert np.bincount(groups, minlength=mix.groups).min() > 0.8 * n / mix.groups
    hits = np.zeros(mix.n)
    for i in range(n):
        hits[list(mix.request(i).lost)] += 1
    if mix.request_kind == "repair":
        assert hits.min() > 0.8 * hits.mean()
    else:
        assert hits[:mix.k].min() > 0.8 * hits[:mix.k].mean()


def test_reads_lose_a_data_cell_and_answer_it():
    mix = _mix("hdfs-rs-6-3.read", 5)
    for i in range(2000):
        req = mix.request(i)
        (j,) = req.answer_rows
        assert j < mix.k and j in req.lost


def test_repairs_answer_every_lost_cell():
    mix = _mix("hdfs-rs-10-4.repair", 5)
    for i in range(2000):
        req = mix.request(i)
        assert req.answer_rows == req.lost and len(set(req.lost)) == len(req.lost)


def test_encode_cycles_through_the_resident_set():
    c = spec.load_cell("hdfs-rs-10-4.write")
    c.config["resident_block_groups"] = 4
    mix = Mix(c.traffic, c.config, 5)
    assert [mix.request(i).group for i in range(20)] == [i % 16 for i in range(20)]


def test_seeded():
    a, b, c = (_mix("hdfs-rs-6-3.read", s) for s in (7, 7, 8))
    ra = [a.request(i) for i in range(500)]
    assert ra == [b.request(i) for i in range(500)]
    assert ra != [c.request(i) for i in range(500)]
    assert a.checked() == b.checked() != c.checked()
    big = _mix("hdfs-rs-6-3.read", 2**31 + 2**20)
    assert len(big.checked()) == big.check_answers


def test_warm_patterns():
    assert len(_mix("hdfs-rs-10-4.repair", 1).patterns(2)) == 14 + 91
    read = _mix("hdfs-rs-6-3.read", 1).patterns(2)
    assert len(read) == 6 + (36 - 3)
    assert [len(p) for p in read][-6:] == [1] * 6


@pytest.mark.parametrize("cell", ["hdfs-rs-6-3.read", "hdfs-rs-10-4.repair"])
def test_shape_requests_take_each_erasure_size_once(cell):
    mix = _mix(cell, 1)
    reqs = mix.shape_requests()
    assert [len(r.lost) for r in reqs] == sorted(mix.shares)
    for r in reqs:
        assert set(r.answer_rows) <= set(r.lost)
        assert len(r.answer_rows) == (1 if mix.request_kind == "read"
                                      else len(r.lost))
        if mix.request_kind == "read":
            assert r.answer_rows[0] < mix.k


def test_arrivals_are_one_set_of_gaps_in_another_order():
    c = spec.load_cell("hdfs-rs-6-3.read")
    c.traffic.update(rate_per_s=176.0, arrival_stratum=50)
    a, b = (Mix(c.traffic, c.config, s) for s in (2**31 + 1, 2**31 + 2))
    m = a.stratum
    ta = np.array([a.arrival(i) for i in range(2 * BLOCK + 1)])
    tb = np.array([b.arrival(i) for i in range(2 * BLOCK + 1)])
    ga, gb = np.diff(ta), np.diff(tb)
    assert not np.allclose(ga, gb)
    # Every stratum starts at the same time in every seed, and holds the
    # same set of gaps.
    assert np.allclose(ta[::m], tb[::m])
    for s0 in (0, m, BLOCK - m, BLOCK, 2 * BLOCK - m):
        assert np.allclose(np.sort(ga[s0:s0 + m]), np.sort(gb[s0:s0 + m]))
    assert ga.mean() == pytest.approx(1 / a.rate, rel=0.01)
