"""The systematic local reconstruction code of Huang et al., "Erasure
Coding in Windows Azure Storage" (USENIX ATC 2012), worked out from its
definition, which configurations name as ``lrc`` with
``generator_args: {"groups": g}``.

The k data cells fall into g local groups of k/g contiguous cells. Below
the identity come g local rows, each all ones over one group's columns
(the XOR of the group: the same in every field of characteristic 2), then
r - g global rows P[i, j] = 1 / ((k + i) xor j), the Cauchy rows of
``cauchy.py``, in place of Azure's alpha and beta coefficients. Cell k + j
is group j's local parity; cells k + g and on belong to no group.

The code is not MDS: some sets of k cells have rank below k.
"""

from __future__ import annotations

import numpy as np

from ecbench.reference import cauchy


def _check(k: int, r: int, groups: int) -> None:
    if groups < 1 or k % groups or r - groups < 1:
        raise ValueError(f"no LRC with k={k}, r={r}, groups={groups}: the "
                         "groups divide k and leave a global row")


def generator(field, k: int, r: int, groups: int) -> np.ndarray:
    """(k + r, k) systematic generator over ``field``."""
    _check(k, r, groups)
    G = cauchy.generator(field, k, r - groups)
    size = k // groups
    local = np.zeros((groups, k), dtype=np.uint8)
    for j in range(groups):
        local[j, j * size:(j + 1) * size] = 1
    return np.concatenate([G[:k], local, G[k:]])


def least_read(k: int, r: int, lost, groups: int) -> int:
    """Cells the smallest set that rebuilds ``lost`` reads: k/g a lost
    cell where every lost cell is the only loss of its local group, at
    most k; else (a global cell lost, two losses in one group, or none)
    k."""
    _check(k, r, groups)
    size = k // groups
    group = [i // size if i < k else i - k if i < k + groups else None
             for i in lost]
    if not group or None in group or len(set(group)) < len(group):
        return k
    return min(k, size * len(group))
