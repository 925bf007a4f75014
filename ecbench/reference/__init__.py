"""The benchmark's plain reference. It imports nothing of the program, of
the JAX package or of ``jax``.

:func:`load` builds the code that a configuration states, by the names it
gives: the field from ``ecbench/reference/<field>.py`` (a ``Field`` built
from ``field_poly``, with field arithmetic in NumPy and a product on int32
words) and the generator from ``ecbench/reference/<generator>.py``
(``generator(field, k, r)``). A name with no such file is refused: the
reference implements ``gf256`` and ``cauchy``.
"""

from __future__ import annotations

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


class Code:
    """A systematic (k + r, k) code: its field, generator G, the parity of
    data words and the matrix that rebuilds cells from k survivors."""

    def __init__(self, field, k: int, r: int, G: np.ndarray):
        self.field, self.k, self.r, self.n = field, k, r, k + r
        self.G = G
        if not np.array_equal(G[:k], np.eye(k, dtype=G.dtype)):
            raise ValueError("the generator is not systematic")

    def parity(self, data: torch.Tensor) -> torch.Tensor:
        """(B, k, TW) data words -> (B, r, TW) parity words."""
        return self.field.matmul_words(self.G[self.k:], data)

    def rebuild_matrix(self, present, wanted):
        """(basis, R): the first k present cells in index order, and R with
        ``cells[wanted] = R x cells[basis]``, R = G[wanted] inv(G[basis])."""
        basis = sorted(present)[:self.k]
        if len(basis) < self.k:
            raise ValueError(f"{len(basis)} cells present, {self.k} needed")
        R = self.field.matmul(self.G[list(wanted)],
                              self.field.inverse(self.G[basis]))
        return basis, R

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


def load(config: dict, field_poly: int | None = None) -> Code:
    """The code of ``config``; ``field_poly`` puts another polynomial in
    the stated one's place (the control)."""
    field_mod = _module("field", config["field"])
    gen_mod = _module("generator", config["generator"])
    poly = int(config["field_poly"] if field_poly is None else field_poly)
    field = field_mod.Field(poly)
    k, r = int(config["data_units"]), int(config["parity_units"])
    return Code(field, k, r, gen_mod.generator(field, k, r))
