"""The operand of the GF(2) product core (``csrc/gf2tile.cuh``) that K5
(ops/fused.py) and K7 (ops/panel.py) run, its shared-memory fit, the block
shape of K11/K12 (ops/gf2mm.py, the third user, whose masks the kernel
stages itself), and the plain masked product K5's and K7's plain versions
compute.

The operand is the matrix's bit expansion as int32 select masks (-1 where
bit (row, plane) is set, else 0), built on the CPU once per matrix and
uploaded with ``.to(device)``; ``DeviceCodec`` caches it per matrix. No
network is factored: the core applies every (row, plane) pair with one
``acc ^= mask & plane``.

The masks are tiled as the kernels stage them: ``(NRG, NT, KT, RGR)``,
row group g (RGR = WR * ROW_BLOCK rows, one warp per ROW_BLOCK), K tile t
(KT planes), plane, row — so one tile of one row group is one contiguous
copy. Rows past R and planes past C are zero, so the kernels need no edge
test on either.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from noise_ec_tpu_torch.ops.network import SMEM_BYTES

# csrc/gf2tile.cuh: kRowBlock, kStages, kMaxThreads / 32, kCols, kMaskPad.
ROW_BLOCK = 32
STAGES = 2
MAX_WARPS = 16
COLS = 2
MASK_PAD = 4

# K11/K12 (csrc/gf2tile.cuh RowMajorMasks): its ring's depth; its K tiles
# (multiples of 8: a warp stages masks 8 planes at a time); most column
# warps a block; a K tile's fixed cost in planes' products (its barrier and
# ring turn), which ranks the K tiles; the warps an SM under which a block
# takes two warps along K (chip_smoke.py --dense-sweep, PERF.md).
DENSE_STAGES = 3
DENSE_KT = (32, 24, 16, 8)
DENSE_WC = 4
DENSE_TILE_COST = 4
DENSE_MIN_WARPS = 8


def ring_bytes(KT: int, ncol: int, rgr: int, stages: int = STAGES) -> int:
    """Shared memory of one block's ring: ``stages`` K tiles, each KT
    planes of ncol words and KT planes' masks, rgr words a plane."""
    return stages * KT * (ncol + rgr) * 4


def dense_smem_bytes(KT: int, WR: int, WC: int, WK: int) -> int:
    """Shared memory of one K11/K12 block: its ring, reused after the last
    tile for the sums of the WK - 1 warps along K past the first
    (``Shape::smem_bytes``)."""
    ring = ring_bytes(KT, 32 * COLS * WC, ROW_BLOCK * WR + MASK_PAD,
                      DENSE_STAGES)
    return max(ring, (WK - 1) * WR * WC * COLS * ROW_BLOCK * 32 * 4)


def row_groups(R: int, WR: Optional[int] = None) -> tuple[int, int]:
    """(NRG, WR) for R output rows: WR warps of ROW_BLOCK rows a block
    (default the fewest row groups of at most MAX_WARPS warps, even)."""
    nrb = max(1, -(-R // ROW_BLOCK))
    if WR is None:
        NRG = -(-nrb // MAX_WARPS)
        WR = -(-nrb // NRG)
    return -(-nrb // WR), WR


@functools.lru_cache(maxsize=1024)
def dense_shape(R: int, C: int, W: int,
                sms: int) -> tuple[int, int, int, int, int]:
    """(KT, WR, WC, WK, ksplit) of K11/K12 for (R, C) masks over (C, W)
    planes on a card of ``sms`` SMs.

    The row groups are :func:`row_groups`'s. KT is the K tile of
    :data:`DENSE_KT` with the fewest padded planes plus
    :data:`DENSE_TILE_COST` a tile (ties to the larger): padded planes'
    zero masks still cost their LOP3s, and each tile its barrier. The
    column warps WC (at most :data:`DENSE_WC`, and whose block fits
    ``SMEM_BYTES``) minimise the columns the busiest SM computes,
    ceil(blocks / sms) x ncol, and among those the shapes whose blocks
    give every SM one come first, then the widest. Where no WC gives every
    SM a block, the K tiles are split over enough blocks a column tile
    that they do (at most one a tile): a split costs a zeroed output and
    atomic stores, so it is taken only where columns alone leave SMs idle.
    A launch that would leave the SMs under :data:`DENSE_MIN_WARPS` warps
    each takes WK = 2 warps along K, where the block has room."""
    if min(R, C, W, sms) < 1:
        raise ValueError(f"no K11 shape for R={R}, C={C}, W={W}, sms={sms}")
    NRG, WR = row_groups(R)
    KT = min(DENSE_KT, key=lambda kt: (
        -(-C // kt) * (kt + DENSE_TILE_COST), -kt))
    best = None
    for WC in range(1, min(DENSE_WC, MAX_WARPS // WR) + 1):
        if dense_smem_bytes(KT, WR, WC, 1) > SMEM_BYTES:
            break
        ncol = 32 * COLS * WC
        blocks = -(-W // ncol) * NRG
        key = (-(-blocks // sms) * ncol, blocks < sms, -WC)
        if best is None or key < best[0]:
            best = (key, WC, blocks)
    if best is None:
        raise ValueError(f"no K11 block of {WR} row warps fits shared "
                         f"memory at KT={KT}")
    _, WC, blocks = best
    ksplit = 1
    if blocks < sms:
        ksplit = max(1, min(-(-C // KT), -(-sms // blocks)))
    WK = 1
    if (blocks * ksplit * WR * WC < DENSE_MIN_WARPS * sms
            and 2 * WR * WC <= MAX_WARPS
            and dense_smem_bytes(KT, WR, WC, 2) <= SMEM_BYTES):
        WK = 2
    return KT, WR, WC, WK, ksplit


@dataclass(frozen=True)
class MaskTiles:
    """An (R x C) GF(2) matrix as the core's mask operand (module doc),
    with the block shape the kernels launch it at."""

    masks: torch.Tensor  # (NRG, NT, KT, RGR) int32 -1 or 0
    n_inputs: int  # C
    n_rows: int  # R
    KT: int  # planes a K tile
    WR: int  # warps along the rows
    WC: int  # warps along the columns

    @property
    def NRG(self) -> int:
        return self.masks.shape[0]

    @property
    def NT(self) -> int:
        return self.masks.shape[1]

    @property
    def RGR(self) -> int:
        return ROW_BLOCK * self.WR

    @property
    def ncol(self) -> int:
        return 32 * COLS * self.WC

    @property
    def threads(self) -> int:
        return 32 * self.WR * self.WC

    @property
    def ring_bytes(self) -> int:
        return ring_bytes(self.KT, self.ncol, self.RGR)

    def to(self, device) -> "MaskTiles":
        """The same operand with its masks on ``device``."""
        return dataclasses.replace(self, masks=self.masks.to(device))

    def matrix(self) -> torch.Tensor:
        """The (R, C) int32 masks, untiled (a view where possible)."""
        m = self.masks.permute(0, 3, 1, 2).reshape(self.NRG * self.RGR,
                                          self.NT * self.KT)
        return m[:self.n_rows, :self.n_inputs]


def rows_to_bits(bits_rows: tuple, C: int) -> np.ndarray:
    """Per-row term tuples (``DeviceCodec.bits_rows_for``) -> the (R, C)
    0/1 matrix."""
    R = len(bits_rows)
    bits = np.zeros((R, C), dtype=np.uint8)
    lens = [len(row) for row in bits_rows]
    if sum(lens):
        rows = np.repeat(np.arange(R), lens)
        cols = np.fromiter((c for row in bits_rows for c in row),
                           dtype=np.int64, count=sum(lens))
        bits[rows, cols] = 1
    return bits


def build_tiles(bits_rows: tuple, C: int, KT: int, *,
                WR: Optional[int] = None, WC: int = 1) -> MaskTiles:
    """The mask operand of ``bits_rows`` (R rows over C planes) at K tile
    KT and block shape (WR, WC), on the CPU."""
    if KT < 1 or WC < 1:
        raise ValueError(f"bad tile shape KT={KT}, WC={WC}")
    R = len(bits_rows)
    NRG, WR = row_groups(R, WR)
    if WR * WC > MAX_WARPS:
        raise ValueError(f"{WR} x {WC} warps exceed {MAX_WARPS} a block")
    NT = max(1, -(-C // KT))
    full = np.zeros((NRG * ROW_BLOCK * WR, NT * KT), dtype=np.int32)
    full[:R, :C] = -rows_to_bits(bits_rows, C).astype(np.int32)
    masks = full.reshape(NRG, ROW_BLOCK * WR, NT, KT).transpose(0, 2, 3, 1)
    return MaskTiles(torch.from_numpy(np.ascontiguousarray(masks)), C, R,
                     KT, WR, WC)


def masked_product_plain(tiles: MaskTiles, planes: torch.Tensor,
                         k_tiles: Optional[tuple[int, int]] = None,
                         acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch core: planes (C, ...) -> (R, ...), out[r] = XOR over
    the planes c of K tiles ``k_tiles`` (default all) of mask[r, c] &
    planes[c]; with ``acc`` (R, ...) the sum is XORed into it in place and
    it is returned. A mask is -1 or 0, so each term is the plane itself
    where the mask is set and nothing where it is not: one XOR of one
    plane a set mask (tensors of one plane's size, which PyTorch runs
    without spreading them over threads)."""
    C, R = tiles.n_inputs, tiles.n_rows
    if planes.shape[0] != C:
        raise ValueError(f"operand takes {C} planes, got {planes.shape[0]}")
    lo, hi = (0, tiles.NT) if k_tiles is None else k_tiles
    c0, c1 = lo * tiles.KT, min(hi * tiles.KT, C)
    out = acc if acc is not None else planes.new_zeros((R,) + planes.shape[1:])
    selected = (tiles.matrix()[:, c0:c1] != 0).cpu().numpy()
    for r in range(R):
        for c in np.flatnonzero(selected[r]):
            out[r] ^= planes[c0 + c]
    return out


def k_split(blocks: int, n_tiles: int, device) -> int:
    """The K split of a launch of ``blocks`` blocks over ``n_tiles`` K
    tiles: 1 where the blocks fill the card's SMs, else enough parts (at
    most one a tile) that they do."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if blocks >= sms:
        return 1
    return max(1, min(n_tiles, -(-sms // blocks)))


def check_aligned(*tensors: torch.Tensor) -> None:
    """The core stages 16-byte chunks: every tensor it reads must start on
    a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the product core needs 16-byte aligned tensors")
