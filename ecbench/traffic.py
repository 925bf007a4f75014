"""The one generator of every traffic mix.

A mix is a JSON file under ``ecbench/traffic/``: ``driver`` names the code
that drives the window (``ecbench/drivers/<driver>.py``), and the other
keys are parameters that this module reads to draw the requests of a run
from ``--seed``. ``request`` says what a request is:

- ``encode``: ``stripes_per_call`` resident stripes encoded in one call,
  cycling through the resident set in order;
- ``read``: a whole-block read of one block group whose data cell j is
  lost, with the others that the erasure mix adds; the answer is block j,
  rebuilt;
- ``repair``: a rebuild of one block group whose lost cells all come from
  the erasure mix; the answer is every lost block.

Where a mix gives ``rate_per_s``, requests arrive open-loop at that rate
(``arrival``): in each stratum of ``arrival_stratum`` requests the gaps
between arrivals are the exponential distribution's quantiles, the same
set in every stratum of every seed, in an order drawn from the seed.

Erasure sizes (``erasure_mix``) are stratified: each run of ``BLOCK``
requests holds the mix's shares exactly (largest remainders), each rare
size once in each stretch of BLOCK / count requests, at a place drawn from
the seed. So every seed does the same work in another order. The block
group and the lost indices are drawn uniformly from the seed.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

REQUESTS = ("encode", "read", "repair")
BLOCK = 10_000


@dataclass(frozen=True)
class Request:
    index: int
    group: int          # block group; for encode, the chunk of stripes
    lost: tuple         # lost cell indices, sorted
    answer_rows: tuple  # codeword rows the answer holds (encode: all)


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def block_stripes(config: dict) -> int:
    """Stripes in one block group: the block's bytes over a cell's."""
    stripes, rest = divmod(int(config["block_bytes"]),
                           int(config["cell_bytes"]))
    if rest or stripes < 1:
        raise ValueError("block_bytes is not a multiple of cell_bytes")
    return stripes


def class_counts(shares: dict, total: int) -> dict:
    """Counts per erasure size summing to ``total``: largest remainders."""
    if any(p < 0 for p in shares.values()) or not shares:
        raise ValueError(f"bad shares {shares}")
    norm = sum(shares.values())
    exact = {e: total * p / norm for e, p in shares.items()}
    counts = {e: int(v) for e, v in exact.items()}
    left = total - sum(counts.values())
    for e in sorted(exact, key=lambda e: counts[e] - exact[e])[:left]:
        counts[e] += 1
    return counts


def erasure_sizes(shares: dict, seed: int, block: int) -> np.ndarray:
    """The erasure size of each request of stratification block ``block``."""
    rng = np.random.default_rng([_seed(seed), block, 1])
    counts = class_counts(shares, BLOCK)
    common = max(counts, key=counts.get)
    sizes = np.full(BLOCK, common, dtype=np.int64)
    taken = np.zeros(BLOCK, dtype=bool)
    for e in sorted(counts, key=counts.get):
        c = counts[e]
        if e == common or c == 0:
            continue
        for p in ((np.arange(c) + rng.random(c)) * BLOCK / c).astype(int):
            while taken[p]:
                p = (p + 1) % BLOCK
            taken[p] = True
            sizes[p] = e
    return sizes


class Mix:
    """The requests of one run: ``request(i)`` is the i-th, the same for
    the same seed, drawn in blocks as they are needed."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        self.request_kind = traffic["request"]
        if self.request_kind not in REQUESTS:
            raise ValueError(f"unknown request {self.request_kind!r}")
        self.seed = _seed(seed)
        self.k = int(config["data_units"])
        self.n = self.k + int(config["parity_units"])
        stripes = block_stripes(config)
        groups = int(config["resident_block_groups"])
        if self.request_kind == "encode":
            per_call = int(traffic["stripes_per_call"])
            if (stripes * groups) % per_call:
                raise ValueError("stripes_per_call must divide the "
                                 "resident stripes")
            self.groups = stripes * groups // per_call
            self.shares = {}
        else:
            self.groups = groups
            self.shares = {int(e): float(p)
                           for e, p in traffic["erasure_mix"].items()}
            if max(self.shares) > self.n - self.k or min(self.shares) < 1:
                raise ValueError(f"erasure sizes {sorted(self.shares)} "
                                 f"outside 1..{self.n - self.k}")
        # The most codeword rows an answer holds.
        self.answer_rows = (self.n if self.request_kind == "encode" else
                            1 if self.request_kind == "read" else
                            max(self.shares))
        self.check_answers = int(traffic["check_answers"])
        self.check_within = int(traffic["check_within"])
        # Open-loop arrivals: each stratum of ``arrival_stratum`` requests
        # takes the gaps at the exponential distribution's quantiles of that
        # count at ``rate_per_s``, the same set in every stratum of every
        # seed, in an order drawn from the seed; so every stratum spans the
        # same time and a window holds the same arrivals whatever the seed.
        self.rate = float(traffic.get("rate_per_s", 0.0))
        if self.rate > 0:
            self.stratum = int(traffic["arrival_stratum"])
            if BLOCK % self.stratum:
                raise ValueError(f"arrival_stratum must divide {BLOCK}")
            u = (np.arange(self.stratum) + 0.5) / self.stratum
            self._gaps = -np.log1p(-u) / self.rate
            self._span = float(self._gaps.sum())
        self._blocks: dict[int, list] = {}
        self._arrivals: dict[int, np.ndarray] = {}

    def arrival(self, i: int) -> float:
        """Seconds from the mix's origin to request i's arrival."""
        b, off = divmod(i, BLOCK)
        at = self._arrivals.get(b)
        if at is None:
            rng = np.random.default_rng([self.seed, b, 4])
            strata = BLOCK // self.stratum
            gaps = rng.permuted(np.tile(self._gaps, (strata, 1)), axis=1)
            starts = (b * strata + np.arange(strata)) * self._span
            at = self._arrivals[b] = (starts[:, None] + np.concatenate(
                [np.zeros((strata, 1)), np.cumsum(gaps[:, :-1], axis=1)],
                axis=1)).reshape(-1)
        return float(at[off])

    def request(self, i: int) -> Request:
        if self.request_kind == "encode":
            return Request(i, i % self.groups, (), tuple(range(self.n)))
        b, off = divmod(i, BLOCK)
        blk = self._blocks.get(b)
        if blk is None:
            blk = self._blocks[b] = self._draw(b)
        return blk[off]

    def _draw(self, b: int) -> list:
        base = b * BLOCK
        rng = np.random.default_rng([self.seed, b, 2])
        sizes = erasure_sizes(self.shares, self.seed, b)
        groups = rng.integers(0, self.groups, BLOCK)
        keys = rng.random((BLOCK, self.n))
        if self.request_kind == "read":
            j = rng.integers(0, self.k, BLOCK)
            keys[np.arange(BLOCK), j] = -1.0
        order = keys.argsort(axis=1)
        out = []
        for i in range(BLOCK):
            e = int(sizes[i])
            lost = tuple(sorted(int(x) for x in order[i, :e]))
            rows = (int(order[i, 0]),) if self.request_kind == "read" else lost
            out.append(Request(base + i, int(groups[i]), lost, rows))
        return out

    def patterns(self, max_erasures: int) -> list:
        """Every lost set of at most ``max_erasures`` cells this mix can
        draw, the smallest last."""
        out = []
        for e in sorted((e for e in self.shares if e <= max_erasures),
                        reverse=True):
            for lost in itertools.combinations(range(self.n), e):
                if self.request_kind == "read" and min(lost) >= self.k:
                    continue
                out.append(lost)
        return out

    def shape_requests(self) -> list:
        """One request of each erasure size the mix draws, on block group 0:
        together they hold every size of buffer that its requests take."""
        out = []
        for e in sorted(self.shares):
            lost = self.patterns(e)[0]
            rows = (lost[0],) if self.request_kind == "read" else lost
            out.append(Request(-1, 0, lost, rows))
        return out

    def checked(self) -> list:
        """Indices of the requests whose answers are compared, drawn from
        the seed among the first ``check_within``."""
        rng = np.random.default_rng([self.seed, 0, 3])
        size = min(self.check_answers, self.check_within)
        return sorted(int(i) for i in rng.choice(self.check_within, size,
                                                 replace=False))
