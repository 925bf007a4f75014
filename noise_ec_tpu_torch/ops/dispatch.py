"""Geometry-cached device codec: the bridge from GF matrices to the kernels.

Port of ``noise_ec_tpu.ops.dispatch.DeviceCodec`` for GF(2^8) and
GF(2^16). One primitive carries both reference hot loops: encode is
``parity_rows @ data`` (main.go:262), reconstruct is
``inverted_submatrix_rows @ survivors`` (main.go:77). Per matrix the codec
caches its plan, with the operand uploaded to the card once, on one of
three routes (:meth:`DeviceCodec.route_for`):

- "baked": the K-sliced fused kernel K5 (ops/fused.py) when its ring
  fits shared memory, else the fused kernel K1 (ops/fused.py) when its
  slots fit, else the K2 -> K4 -> K3 pipeline (ops/pack.py, ops/gf2mm.py).
  The reference tries K1 first; K5 runs each measured matrix faster on
  the H100 (PERF.md), so the port tries it first, and the default plan
  factors no network;
- "panel" (wide codes): the row-blocked pack K6 -> the block-panel matmul
  K7 (ops/panel.py) -> the row-blocked unpack;
- "mxu" (past every XOR-network budget): the dense int8 product K8
  (ops/mxu.py).

GF(2^16) runs byte-sliced: each u16 symbol row splits into adjacent lo/hi
byte rows, and the m=8 routes above run over 2k byte rows with the
matrix's unpermuted (16r, 16k) bit expansion (flat plane index
16j + b == (2j + b//8)*8 + b%8). The interleaved-u16 words entry
(:meth:`DeviceCodec.matmul_words` on a GF(2^16) codec) runs the same bits,
and the same plan, over 16 planes a shard instead, routed as the
reference's ``_fused_words16_fn`` and ``_panel_words_fn(r, 16, ...)``:
baked, K5 or K1 at m = 16, else the lane pipeline at m = 16 (K2 -> K4 ->
K3), or the sublane one (K10 -> K4 -> K10, the reference's tier 3) where
the reference's lane tile would not fit its rows (max(k, r) > 48); panel,
K6 at m = 16 -> K7 -> K6.

The codec runs on ``device`` ("cuda" unless the caller asks for "cpu").
On the CPU every wrapper takes its kernel's plain PyTorch version; on the
card it launches the kernel or raises. Nothing falls back: a build or
launch error raises, and so does the one route the reference has no kernel
for either, an "mxu" matrix on the interleaved GF(2^16) words entry.

The error-correcting decode (matrix/bw.py, codec/fec.py) reaches the card
through :meth:`DeviceCodec.syndrome_stripes` and the decode1 fold
(:func:`decode1_fold_matrix`, :meth:`DeviceCodec.decode1_words` and its
byte-sliced GF(2^16) twin): each is one generator-shaped product on the
routes above.

Left out for now (ROADMAP queue 1): the codec breaker and its prober, the
``DeviceGate`` admission queue, ``obs/device.py`` telemetry, the mesh tier,
and buffer donation
(``matmul_words_batch(donate=True)``: the streaming window keeps a ring of
device buffers instead, parallel/streaming.py).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.ops.fused import (
    fused_encode_words,
    fused_plan,
    fused_split_encode_words,
    fused_split_plan,
)
from noise_ec_tpu_torch.ops.gf2mm import (
    bits_to_rows,
    gf2_matmul_sparse,
    sparse_plan,
)
from noise_ec_tpu_torch.ops.mxu import (
    MXU_TILE_WORDS,
    build_mxu_tiles,
    mxu_encode_tiles,
)
from noise_ec_tpu_torch.ops.network import SMEM_BYTES
from noise_ec_tpu_torch.ops.pack import (
    lane_quantum,
    lane_tl,
    pack_u16_bytesliced,
    pack_words16,
    pack_words_lanes,
    pack_words_lanes_blocked,
    reference_lane_tl,
    unpack_u16_bytesliced,
    unpack_words16,
    unpack_words_lanes,
    unpack_words_lanes_blocked,
)
from noise_ec_tpu_torch.ops.panel import gf2_matmul_panel_chain, panel_plan

_FIELDS = {"gf256": GF256, "gf65536": GF65536}

# Whole-network factoring is super-linear in the network's terms and runs
# on the host once per matrix (RS(50,20), ~32k raw XORs, takes seconds in
# Python). Past this raw-XOR budget a matrix leaves the baked
# route, as in the reference; the budget bounds host planning time and
# does not depend on the card.
_BAKED_XOR_BUDGET = 60_000

# The fused kernel parks all 8K input planes of its column tile in shared
# memory before its network runs, so a warp's 32-column tile needs
# 8 * K * 32 * 4 B <= 227 KB over K byte rows: K <= 227 (k for GF(2^8), 2k
# for GF(2^16)). Output rows take no slots, and the pipeline's kernels hold
# no whole rows at all. The reference's bound (96, on max(k, r) byte rows)
# models its TPU pack stage's VMEM tiles instead.
_BAKED_MAX_ROWS = SMEM_BYTES // (8 * 32 * 4)

# Past this raw-XOR budget the reference leaves the XOR-network kernels for
# the dense MXU product (pallas_gf2mm.PANEL_XOR_BUDGET), and so does the
# port, for K8. No RS parity matrix with k + r <= 256 reaches it over
# GF(2^8) (RS(128,128)'s, the widest, has 533,504 raw XORs); a denser
# GF(2^8) matrix can, and so do GF(2^16)'s wide codes, from RS(200,56) on.
PANEL_XOR_BUDGET = 600_000

# Pad-to multiples of the words entries: the lane-pack grouping unit at
# TL = 128 (8*8*128 words, 32 KiB per GF(2^8) shard), and the reference's
# interleaved-u16 unit (64 KiB per GF(2^16) shard), as in the reference.
# K8 pads only to its own tile.
WORD_QUANTUM = lane_quantum(8)
WORD_QUANTUM16 = lane_quantum(16)

_TIERS = (None, "fused", "split", "pipeline")

# Expansions kept per codec: a GF(2^16) RS(200,56) parity matrix's is
# 2.9 MB; what each plan needs is cached beside it.
_BITS_CACHE = 16


def decode1_fold_matrix(gf: GF, A: np.ndarray, j: int) -> np.ndarray:
    """(r2, m) matrix folding the single-corrupt-row decode into ONE
    generator-shaped product (same per-column guarantee as matrix/bw.py).

    With aug = [A | I] the parity check over the m received rows and
    p0 the first check row seeing basis column j:

    - row 0 = e_j ^ inv(A[p0,j]) * aug[p0]  — applied to the received
      rows this is rows[j] ^ inv(A[p0,j]) * s_p0, i.e. row j with the
      single-support correction applied (the e_j and aug terms cancel
      at column j, so the corrupted row is reconstructed from the
      others — correcting a fully-corrupt row IS reconstruction);
    - rows 1.. = aug[q] ^ (A[q,j]/A[p0,j]) * aug[p0] for q != p0 —
      each is s_q ^ c_q * s_p0, zero exactly where check row q is
      consistent with the hypothesis "only row j is in error". A
      column with ANY nonzero verify symbol must be re-decoded by the
      general host path; columns that verify (including clean columns,
      where s_p0 = 0 makes the correction a no-op) are exact.

    Raises ValueError for fewer than two check rows (one parity row leaves
    no consistency rows, so a mask would claim every column verified with
    nothing behind it), a ``j`` outside the basis, or an all-zero check
    column.
    """
    A = np.asarray(A, dtype=gf.dtype)
    r2, k = A.shape
    if r2 < 2:
        raise ValueError(
            f"single-support decode needs >= 2 check rows, got {r2}"
        )
    if not 0 <= j < k:
        raise ValueError(f"j must index a basis row, got {j}")
    nz = np.flatnonzero(A[:, j])
    if nz.size == 0:
        raise ValueError(f"check column {j} is identically zero")
    p0 = int(nz[0])
    aug = np.concatenate([A, np.eye(r2, dtype=gf.dtype)], axis=1)
    inv_c = int(gf.inv(int(A[p0, j])))
    D = np.zeros((r2, k + r2), dtype=gf.dtype)
    D[0, j] = 1
    D[0] ^= gf.mul(inv_c, aug[p0].astype(np.int64)).astype(gf.dtype)
    out_i = 1
    for q in range(r2):
        if q == p0:
            continue
        c_q = int(gf.mul(int(A[q, j]), inv_c))
        D[out_i] = aug[q] ^ gf.mul(
            c_q, aug[p0].astype(np.int64)
        ).astype(gf.dtype)
        out_i += 1
    return D


def _or_rows(rows: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the leading axis of a (n >= 1, ...) int tensor."""
    out = rows[0].clone()
    for q in range(1, rows.shape[0]):
        out |= rows[q]
    return out


def pad_words(TW: int, quantum: int = WORD_QUANTUM) -> int:
    return -(-TW // quantum) * quantum


def _quantum(kind: str) -> int:
    return MXU_TILE_WORDS if kind == "mxu" else WORD_QUANTUM


class StagingPool:
    """Reusable host staging buffers per shape, pinned when the codec runs
    on the card (the counterpart of the reference's ``DeviceBufferPool``),
    so a call pays the payload copy and not a pinned allocation.

    The pad columns past a payload are not zeroed: the product is
    positionwise, and their output columns are dropped. A buffer backs an
    asynchronous host-to-device copy, so release it only after that
    dispatch's output has come back.
    """

    def __init__(self, pin: bool, max_per_key: int = 8):
        self.pin = pin
        self.max_per_key = max_per_key
        self._lock = threading.Lock()
        self._free: dict[tuple[int, int], list[torch.Tensor]] = {}

    def acquire(self, rows: int, cols: int) -> torch.Tensor:
        with self._lock:
            stack = self._free.get((rows, cols))
            if stack:
                return stack.pop()
        return torch.empty((rows, cols), dtype=torch.uint8,
                           pin_memory=self.pin)

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            stack = self._free.setdefault(tuple(buf.shape), [])
            if len(stack) < self.max_per_key:
                stack.append(buf)


class DeviceCodec:
    """Runs GF(2^8) or GF(2^16) matrix x stripes products on ``device``
    (module doc)."""

    def __init__(self, field: str = "gf256", device: str = "cuda"):
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceCodec(device='cuda') needs a CUDA device and none "
                    "is available; pass device='cpu' to run on the host"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        self.field = field
        self.gf: GF = _FIELDS[field]()
        # Byte rows a symbol row spans: the byte-sliced GF(2^16) route runs
        # the m=8 kernels over two per shard.
        self.sym_bytes = self.gf.degree // 8
        self._bits_cache: dict[bytes, np.ndarray] = {}
        self._rows_cache: dict[bytes, tuple] = {}
        self._cost_cache: dict[bytes, int] = {}
        self._plan_cache: dict[tuple, tuple] = {}
        self._pool = StagingPool(pin=self.device.type == "cuda")

    def _key(self, M: np.ndarray) -> bytes:
        return M.tobytes() + M.shape[1].to_bytes(4, "little")

    def _bits_for(self, M: np.ndarray) -> np.ndarray:
        """M's (m*r, m*k) GF(2) expansion, cached: the one expansion the
        XOR cost, the network's terms and K8's operand all derive from."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._bits_cache.get(key)
        if hit is None:
            hit = expand_generator_bits(self.gf, M)
            if len(self._bits_cache) >= _BITS_CACHE:
                self._bits_cache.clear()
            self._bits_cache[key] = hit
        return hit

    def bits_rows_for(self, M: np.ndarray) -> tuple:
        """(r, k) GF matrix -> hashable per-row term tuples of its (m*r,
        m*k) bit matrix (cached). A network past the panel tier's XOR
        budget never reaches factoring: the stripes and byte-rows entries
        run it on K8 instead."""
        if self._xor_cost_for(M) > PANEL_XOR_BUDGET:
            raise NotImplementedError(
                "matrix exceeds the panel-tier XOR budget: its route is "
                "'mxu' (K8), which takes no XOR network"
            )
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = bits_to_rows(self._bits_for(M))
            if len(self._rows_cache) > 4096:
                self._rows_cache.clear()
            self._rows_cache[key] = hit
        return hit

    def _xor_cost_for(self, M: np.ndarray) -> int:
        """Raw two-input XOR count of M's GF(2) bit network (set bits minus
        output rows), cached — the route_for decision input."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._cost_cache.get(key)
        if hit is None:
            bits = self._bits_for(M)
            hit = int(np.count_nonzero(bits)) - bits.shape[0]
            if len(self._cost_cache) > 4096:
                self._cost_cache.clear()
            self._cost_cache[key] = hit
        return hit

    def route_for(self, M: np.ndarray) -> str:
        """Which kernel family runs this matrix: "baked" (K1, K5, or K2 ->
        K4 -> K3), "panel" (wide geometries: K6 -> K7) or "mxu" (past every
        XOR-network budget: K8) — the reference's three-way answer, with
        the port's thresholds (module constants). The row bound counts
        input byte rows: k for GF(2^8), 2k for GF(2^16)."""
        rows = self.sym_bytes * np.asarray(M).shape[1]
        cost = self._xor_cost_for(M)
        if cost > PANEL_XOR_BUDGET:
            return "mxu"
        if rows > _BAKED_MAX_ROWS or cost > _BAKED_XOR_BUDGET:
            return "panel"
        return "baked"

    def plan_for(self, M: np.ndarray, tier: Optional[str] = None) -> tuple:
        """(kind, threads, operand on the codec's device, G) for ``M``,
        cached per matrix, over C = 8 * (input byte rows) bit planes: G is
        the number of launches the product's K axis is split into.

        On the baked route, ``tier`` None takes the planner's choice:
        "split" when K5's ring fits (its operand a :class:`~noise_ec_tpu_
        torch.ops.gf2tile.MaskTiles`), else "fused" when K1's slots do
        (ops/fused.py), else "pipeline"; G is 1. Passing "fused", "split"
        or "pipeline" forces one, as the reference's plan override does;
        forcing "fused" or "split" on a matrix its kernel cannot hold
        raises. A panel-routed matrix plans kind "panel" with a
        :class:`~noise_ec_tpu_torch.ops.gf2tile.MaskTiles` and the
        planner's G (ops/panel.py :func:`panel_plan`); an "mxu" matrix
        plans kind "mxu" with K8's tiled bit matrix (an
        :class:`~noise_ec_tpu_torch.ops.mxu.MxuTiles`; threads None, G 1).
        Neither takes a tier."""
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        route = self.route_for(M)
        if route != "baked" and tier is not None:
            raise ValueError(
                f"tier {tier!r} forces a baked-route kernel; this matrix "
                f"routes {route!r}"
            )
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = (self._key(M), tier)
        hit = self._plan_cache.get(key)
        if hit is None:
            if route == "mxu":
                bits = torch.from_numpy(self._bits_for(M).view(np.int8))
                hit = ("mxu", None, build_mxu_tiles(
                    bits, self.sym_bytes * M.shape[0],
                    self.sym_bytes * M.shape[1]), 1)
            else:
                bits_rows = self.bits_rows_for(M)
                C = 8 * self.sym_bytes * M.shape[1]
                if route == "panel":
                    threads, prog, G = panel_plan(bits_rows, C)
                    hit = ("panel", threads, prog, G)
                else:
                    hit = self._baked_plan(bits_rows, C, tier,
                                           8 * self.sym_bytes)
            hit = hit[:2] + (hit[2].to(self.device), hit[3])
            if len(self._plan_cache) > 1024:
                self._plan_cache.clear()
            self._plan_cache[key] = hit
        return hit

    @staticmethod
    def _baked_plan(bits_rows: tuple, C: int, tier: Optional[str],
                    m: int) -> tuple:
        """The baked route's (kind, threads, operand, 1) on the CPU: the
        first of K5, K1 and the pipeline that ``tier`` allows and whose
        plan fits (:meth:`plan_for`). K5's phases are whole symbol rows of
        m planes, so one GF(2^16) plan serves K5 at m = 8 over byte rows
        and at m = 16 over the interleaved words."""
        if tier in (None, "split"):
            plan = fused_split_plan(bits_rows, C // m, len(bits_rows) // m, m)
            if plan is not None:
                threads, _, tiles = plan
                return ("split", threads, tiles, 1)
            if tier == "split":
                raise ValueError("no split-kernel plan fits this matrix")
        if tier in (None, "fused"):
            plan = fused_plan(bits_rows, C)
            if plan is not None:
                return ("fused",) + plan + (1,)
            if tier == "fused":
                raise ValueError("no fused-kernel plan fits this matrix")
        return ("pipeline",) + sparse_plan(bits_rows, C) + (1,)

    # -- words entries (device-resident) ----------------------------------

    def _check_words(self, words: torch.Tensor, rows: int) -> None:
        if (words.dtype != torch.int32 or words.dim() != 3
                or words.shape[1] != rows):
            raise ValueError(
                f"expected int32 (B, {rows}, TW) words, got {words.dtype} "
                f"{tuple(words.shape)}"
            )
        if words.device != self.device:
            raise ValueError(
                f"words on {words.device}, codec on {self.device}"
            )

    def matmul_words(self, M: np.ndarray, words: torch.Tensor, *,
                     tier: Optional[str] = None) -> torch.Tensor:
        """(k, TW) int32 words on the codec's device -> (r, TW) int32.

        The words ARE the shard bytes (little-endian int32 view: 4 GF(2^8)
        or 2 GF(2^16) symbols a word). Any TW is accepted: it is
        zero-padded on the device to the route's quantum and the product
        sliced back (symbols are positionwise, so padding is inert)."""
        return self.matmul_words_batch(M, words[None], tier=tier)[0]

    def matmul_words_batch(self, M: np.ndarray, words: torch.Tensor, *,
                           tier: Optional[str] = None) -> torch.Tensor:
        """(B, k, TW) int32 words -> (B, r, TW): one launch per kernel for
        the whole batch (the kernels take the batch as a grid axis).

        On a GF(2^16) codec the words hold interleaved u16 symbols and run
        the kernels at 16 planes a symbol (module doc), ``tier`` as on byte
        rows; an "mxu" matrix raises NotImplementedError there, as in the
        reference: K8 takes byte rows (:meth:`matmul_words_bytesliced`)."""
        M = np.asarray(M)
        self._check_words(words, M.shape[1])
        if self.sym_bytes == 1:
            return self._byte_rows(M, words, tier)
        return self._words16(M, words, tier)

    def matmul_words_bytesliced(self, M: np.ndarray,
                                words: torch.Tensor) -> torch.Tensor:
        """GF(2^16) only: (2k, TW) int32 words over byte rows (shard j's lo
        bytes at row 2j, its hi bytes at 2j+1: the device-resident form of
        the byte-sliced route, ``words16_to_bytesliced``) -> (2r, TW), on
        whichever route the matrix takes."""
        if self.sym_bytes != 2:
            raise ValueError("matmul_words_bytesliced is gf65536-only")
        M = np.asarray(M)
        if words.dim() != 2:
            raise ValueError(f"expected (2k, TW) words, got "
                             f"{tuple(words.shape)}")
        self._check_words(words[None], 2 * M.shape[1])
        return self._byte_rows(M, words[None], None)[0]

    def _byte_rows(self, M: np.ndarray, words: torch.Tensor,
                   tier: Optional[str]) -> torch.Tensor:
        """(B, K, TW) int32 words over K = sym_bytes * k byte rows -> (B,
        R, TW), R = sym_bytes * r, through M's plan."""
        kind, threads, prog, G = self.plan_for(M, tier)
        R = self.sym_bytes * M.shape[0]
        B, K, TW = words.shape
        TWp = pad_words(TW, _quantum(kind))
        if TWp != TW:
            words = F.pad(words, (0, TWp - TW))
        words = words.contiguous()
        if kind == "mxu":
            out = mxu_encode_tiles(prog, words)
        elif kind == "fused":
            out = fused_encode_words(prog, words, R, threads, lane_tl(TWp))
        elif kind == "split":
            out = fused_split_encode_words(prog, words, R, threads,
                                           lane_tl(TWp))
        elif kind == "panel":
            # Pack and unpack share the blocked TL by construction.
            W8 = TWp // 64
            planes = pack_words_lanes_blocked(words.reshape(B * K, TWp))
            out = gf2_matmul_panel_chain(
                prog, planes.reshape(B, 8 * K, 8, W8), threads, G)
            out = unpack_words_lanes_blocked(out.reshape(B * R, 8, 8, W8))
            out = out.reshape(B, R, TWp)
        else:
            W8 = TWp // 64
            tl = lane_tl(TWp)
            planes = pack_words_lanes(words.reshape(B * K, TWp), tl)
            out = gf2_matmul_sparse(prog, planes.reshape(B, 8 * K, 8, W8),
                                    threads)
            out = unpack_words_lanes(out.reshape(B * R, 8, 8, W8), tl)
            out = out.reshape(B, R, TWp)
        return out[:, :, :TW] if TWp != TW else out

    def _words16(self, M: np.ndarray, words: torch.Tensor,
                 tier: Optional[str]) -> torch.Tensor:
        """Interleaved-u16 (B, k, TW) words -> (B, r, TW) over 16 planes a
        shard, through M's plan (:meth:`plan_for`, the byte-sliced entry's
        plan: its operands are the same planes) on the m = 16 kernels."""
        if self.route_for(M) == "mxu":
            raise NotImplementedError(
                "over-budget GF(2^16) matrices run K8 on the byte-sliced "
                "entries (matmul_words_bytesliced / matmul_stripes), not "
                "the interleaved words entry"
            )
        kind, threads, prog, G = self.plan_for(M, tier)
        r, k = M.shape
        B, _, TW = words.shape
        TWp = pad_words(TW, WORD_QUANTUM16)
        if TWp != TW:
            words = F.pad(words, (0, TWp - TW))
        words = words.contiguous()
        W8 = TWp // 128
        if kind == "split":
            out = fused_split_encode_words(prog, words, r, threads,
                                           lane_tl(TWp, 16), m=16)
        elif kind == "fused":
            out = fused_encode_words(prog, words, r, threads,
                                     lane_tl(TWp, 16), m=16)
        elif kind == "panel":
            planes = pack_words_lanes_blocked(words.reshape(B * k, TWp), 16)
            out = gf2_matmul_panel_chain(
                prog, planes.reshape(B, 16 * k, 8, W8), threads, G)
            out = unpack_words_lanes_blocked(out.reshape(B * r, 16, 8, W8))
            out = out.reshape(B, r, TWp)
        elif reference_lane_tl(TWp, 16, max(k, r)) is not None:
            tl = lane_tl(TWp, 16)
            planes = pack_words_lanes(words.reshape(B * k, TWp), tl, 16)
            out = gf2_matmul_sparse(prog, planes.reshape(B, 16 * k, 8, W8),
                                    threads)
            out = unpack_words_lanes(out.reshape(B * r, 16, 8, W8), tl)
            out = out.reshape(B, r, TWp)
        else:
            planes = pack_words16(words.reshape(B * k, TWp))
            out = gf2_matmul_sparse(prog, planes.reshape(B, 16 * k, 8, W8),
                                    threads)
            out = unpack_words16(out.reshape(B * r, 16, TWp // 16))
            out = out.reshape(B, r, TWp)
        return out[:, :, :TW] if TWp != TW else out

    # -- the error-correcting decode's entries (matrix/bw.py) -------------

    def syndrome_stripes(
        self, A: np.ndarray, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode syndrome on the card: s = A @ rows[:k] ^ rows[k:].

        ``A`` is the (m-k, k) basis-prediction matrix of the
        error-correcting decode (matrix/bw.py); ``rows`` the full (m, S)
        received stripes. XOR is addition in the field, so this is ONE
        generator-shaped product with the augmented matrix [A | I] over
        all m rows, on the same kernels as encode. Returns (s, per-column
        nonzero-row counts); the counts are taken on the host."""
        A = np.asarray(A, dtype=self.gf.dtype)
        r2, k = A.shape
        rows = np.asarray(rows, dtype=self.gf.dtype)
        if rows.shape[0] != k + r2:
            raise ValueError(f"expected {k + r2} rows, got {rows.shape[0]}")
        aug = np.concatenate([A, np.eye(r2, dtype=self.gf.dtype)], axis=1)
        s = self.matmul_stripes(aug, rows)
        return s, np.count_nonzero(s, axis=0)

    def decode1_words(self, A: np.ndarray, j: int,
                      rows_words: torch.Tensor) -> tuple:
        """Device-resident single-corrupt-row decode step (GF(2^8)).

        ``rows_words``: (m, TW) int32 words of all m received stripes on
        the codec's device, any TW. Returns (corrected row j (TW,), the
        OR-fold of the consistency rows (TW,)): a nonzero byte of the
        second means that byte column defeated the single-support
        hypothesis and must go through the general path. One
        generator-shaped product (:meth:`matmul_words`) and an OR."""
        D = decode1_fold_matrix(self.gf, A, j)  # raises for r2 < 2
        out = self.matmul_words(D, rows_words)
        return out[0], _or_rows(out[1:])

    def decode1_words_bytesliced(self, A: np.ndarray, j: int,
                                 rows_words: torch.Tensor) -> tuple:
        """The GF(2^16) twin of :meth:`decode1_words` on byte-sliced words.

        ``rows_words``: (2m, TW) int32 byte-sliced words of all m received
        stripes (share i's lo-byte row at 2i, its hi-byte row at 2i + 1:
        ``ops.pack.words16_to_bytesliced``). Returns (the corrected row j
        as its two byte rows (2, TW), the OR-fold of every consistency
        byte row (TW,)): a u16 column is bad where either of its byte
        columns is nonzero. One byte-sliced product
        (:meth:`matmul_words_bytesliced`)."""
        D = decode1_fold_matrix(self.gf, A, j)  # raises for r2 < 2
        out = self.matmul_words_bytesliced(D, rows_words)
        return out[:2], _or_rows(out[2:])

    # -- stripes entries (host arrays) -------------------------------------

    def matmul_stripes(self, M: np.ndarray, D, *,
                       tier: Optional[str] = None) -> np.ndarray:
        """(r, k) GF matrix x (k, S) symbol stripes (uint8 for GF(2^8),
        uint16 for GF(2^16)) -> (r, S), computed on the codec's device and
        returned as a host array."""
        M = np.asarray(M)
        D = np.asarray(D, dtype=self.gf.dtype)
        if D.shape[0] != M.shape[1]:
            raise ValueError(
                f"matrix cols {M.shape[1]} != stripe rows {D.shape[0]}"
            )
        return self._stripes(M, [D], tier)[0]

    def matmul_stripes_many(self, M: np.ndarray, Ds: list) -> list:
        """B same-shape stripes products through one batched dispatch (the
        CoalescingDispatcher's batch entry), byte-identical to B
        :meth:`matmul_stripes` calls. The reference rounds B up a
        power-of-two ladder to bound JAX recompiles; these kernels are
        shape-generic, so the batch runs at its own size."""
        Ds = [np.asarray(D, dtype=self.gf.dtype) for D in Ds]
        if not Ds:
            return []
        M = np.asarray(M)
        k = M.shape[1]
        S = Ds[0].shape[1]
        for D in Ds:
            if D.shape != (k, S):
                raise ValueError(
                    "matmul_stripes_many requires same-shape stripes "
                    f"(got {D.shape} vs {(k, S)})"
                )
        return self._stripes(M, Ds, None)

    def _stripes(self, M: np.ndarray, Ds: list,
                 tier: Optional[str]) -> list:
        kind = self.plan_for(M, tier)[0]
        B = len(Ds)
        k, S = Ds[0].shape
        K = self.sym_bytes * k  # byte rows a member, S bytes each
        TWp = pad_words(-(-S // 4), _quantum(kind))
        buf = self._pool.acquire(B * K, 4 * TWp)
        host = buf.numpy()
        for b, D in enumerate(Ds):
            rows = host[b * K:(b + 1) * K]
            if self.sym_bytes == 2:
                pack_u16_bytesliced(D, out=rows)
            else:
                rows[:, :S] = D
        words = buf.view(torch.int32).reshape(B, K, TWp)
        words = words.to(self.device, non_blocking=True)
        out = self._byte_rows(M, words, tier).cpu()
        # The product is on the host, so the copy out of the staging page
        # has finished: the page may go to the next dispatch.
        self._pool.release(buf)
        res = out.numpy().view(np.uint8)  # (B, R, 4 * TWp) byte rows
        if self.sym_bytes == 2:
            return [unpack_u16_bytesliced(res[b, :, :S]) for b in range(B)]
        return [np.ascontiguousarray(res[b, :, :S]) for b in range(B)]
