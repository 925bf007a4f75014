"""The benchmark's plain reference. It imports nothing of the program, of
the JAX package or of ``jax``.

:func:`load` builds the code that a configuration states, by the names it
gives: the field from ``ecbench/reference/<field>.py`` (a ``Field`` built
from ``field_poly``, with field arithmetic in NumPy and a product on int32
words) and the generator from ``ecbench/reference/<generator>.py``
(``generator(field, k, r, **generator_args)``, the configuration's
``generator_args`` an object of integers, empty where absent). A name with
no such file is refused: the reference implements ``gf256``, ``cauchy``
and ``lrc``.

A code need not be MDS. Its basis for a rebuild is the first k present
cells, in index order, whose generator rows raise the rank (for an MDS code
the first k present); a pattern whose present cells have rank below k
raises :class:`UndecodablePattern`. A generator module whose code repairs
from fewer than k cells states how many with ``least_read(k, r, lost,
**generator_args)``; without it a rebuild reads k.
"""

from __future__ import annotations

import functools
import importlib
import re
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def _module(what: str, name: str):
    if not _NAME.match(str(name)) or not (HERE / f"{name}.py").is_file():
        raise ValueError(f"the reference implements no {what} {name!r} "
                         f"(no ecbench/reference/{name}.py)")
    return importlib.import_module(f"ecbench.reference.{name}")


class UndecodablePattern(ValueError):
    """The present cells of an erasure pattern have rank below k: no set of
    them rebuilds the lost ones."""


class Code:
    """A systematic (k + r, k) code: its field, generator G, the parity of
    data words, the basis and matrix that rebuild cells from survivors,
    and the cells the smallest rebuild reads (``least_read``, module
    doc)."""

    def __init__(self, field, k: int, r: int, G: np.ndarray,
                 least_read=None):
        self.field, self.k, self.r, self.n = field, k, r, k + r
        self.G = G
        self._least_read = least_read
        if not np.array_equal(G[:k], np.eye(k, dtype=G.dtype)):
            raise ValueError("the generator is not systematic")

    def parity(self, data: torch.Tensor) -> torch.Tensor:
        """(B, k, TW) data words -> (B, r, TW) parity words."""
        return self.field.matmul_words(self.G[self.k:], data)

    def basis(self, present) -> list:
        """The first k present cells, in index order, whose generator rows
        raise the rank; raises :class:`UndecodablePattern` where the
        present cells have rank below k."""
        f = self.field
        basis, pivots = [], []  # pivots: (column, row scaled to 1 there)
        for i in sorted(present):
            v = np.asarray(self.G[i], np.int64)
            for col, row in pivots:
                if v[col]:
                    v = v ^ f.mul(v[col], row)
            nz = np.nonzero(v)[0]
            if nz.size == 0:
                continue
            pivots.append((int(nz[0]), f.mul(v, f.inv(v[nz[0]]))))
            basis.append(i)
            if len(basis) == self.k:
                return basis
        raise UndecodablePattern(
            f"cells {sorted(present)} have rank {len(basis)}, {self.k} "
            "needed: the pattern is undecodable")

    def rebuild_matrix(self, present, wanted):
        """(basis, R): :meth:`basis`, and R with ``cells[wanted] = R x
        cells[basis]``, R = G[wanted] inv(G[basis])."""
        basis = self.basis(present)
        R = self.field.matmul(self.G[list(wanted)],
                              self.field.inverse(self.G[basis]))
        return basis, R

    def least_read(self, lost) -> int:
        """Present cells the smallest set that rebuilds ``lost`` reads:
        the generator module's count, else k."""
        if self._least_read is None:
            return self.k
        return self._least_read(self.k, self.r, tuple(lost))

    def rebuild(self, survivors: torch.Tensor, R) -> torch.Tensor:
        """(B, k, TW) words of the basis cells -> (B, len(R), TW)."""
        return self.field.matmul_words(R, survivors)

    # The program's words entries, so that the code can stand in the
    # program's place (the control, ``ecbench/control.py``).

    def encode_batch_words(self, words: torch.Tensor) -> torch.Tensor:
        return torch.cat([words, self.parity(words)], dim=1)

    def reconstruct_batch_words(self, words_present: torch.Tensor,
                                present: list) -> torch.Tensor:
        pos = {p: i for i, p in enumerate(present)}
        missing = [i for i in range(self.n) if i not in pos]
        basis, R = self.rebuild_matrix(present, missing)
        out = torch.empty(words_present.shape[0], self.n,
                          words_present.shape[2], dtype=torch.int32,
                          device=words_present.device)
        out[:, list(present)] = words_present
        if missing:
            out[:, missing] = self.rebuild(
                words_present[:, [pos[i] for i in basis]], R)
        return out


def _generator_args(config: dict) -> dict:
    args = config.get("generator_args", {})
    if not isinstance(args, dict) or not all(
            isinstance(v, int) and not isinstance(v, bool)
            for v in args.values()):
        raise ValueError(f"generator_args {args!r} is not an object of "
                         "integers")
    return args


def load(config: dict, field_poly: int | None = None) -> Code:
    """The code of ``config``; ``field_poly`` puts another polynomial in
    the stated one's place (the control)."""
    field_mod = _module("field", config["field"])
    gen_mod = _module("generator", config["generator"])
    args = _generator_args(config)
    poly = int(config["field_poly"] if field_poly is None else field_poly)
    field = field_mod.Field(poly)
    k, r = int(config["data_units"]), int(config["parity_units"])
    least = getattr(gen_mod, "least_read", None)
    return Code(field, k, r, gen_mod.generator(field, k, r, **args),
                None if least is None
                else functools.partial(least, **args))
