"""Geometry-cached device codec: the bridge from GF matrices to the kernels.

Port of ``noise_ec_tpu.ops.dispatch.DeviceCodec`` for GF(2^8) on the
"baked" and "panel" routes. One primitive carries both reference hot
loops: encode is ``parity_rows @ data`` (main.go:262), reconstruct is
``inverted_submatrix_rows @ survivors`` (main.go:77). Per matrix the codec
caches the bit network's plan, with the program uploaded to the card once:
on the baked route the fused kernel K1 (ops/fused.py) when its
shared-memory slots fit, else the K2 -> K4 -> K3 pipeline (ops/pack.py,
ops/gf2mm.py); on the panel route (wide codes, :meth:`DeviceCodec.route_for`)
the row-blocked pack K6 -> the block-panel matmul K7 (ops/panel.py) ->
the row-blocked unpack.

The codec runs on ``device`` ("cuda" unless the caller asks for "cpu").
On the CPU every wrapper takes its kernel's plain PyTorch version; on the
card it launches the kernel or raises. Nothing falls back: an unported
route raises NotImplementedError, a build or launch error raises.

Left out for now (ROADMAP queue 1): the codec breaker and its prober, the
``DeviceGate`` admission queue, ``obs/device.py`` telemetry, the "mxu"
route (with GF(2^16), the only path that reaches it), and the mesh tier.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF, GF256
from noise_ec_tpu_torch.ops.fused import fused_encode_words, fused_plan
from noise_ec_tpu_torch.ops.gf2mm import (
    bits_to_rows,
    gf2_matmul_sparse,
    sparse_plan,
)
from noise_ec_tpu_torch.ops.network import BLOCK_SIZES, SMEM_BYTES
from noise_ec_tpu_torch.ops.pack import (
    lane_quantum,
    lane_tl,
    pack_words_lanes,
    pack_words_lanes_blocked,
    unpack_words_lanes,
    unpack_words_lanes_blocked,
)
from noise_ec_tpu_torch.ops.panel import gf2_matmul_panel_chain, panel_plan

# Whole-network factoring is super-linear in the network's terms and runs
# on the host once per matrix (RS(50,20), ~32k raw XORs, takes seconds in
# Python). Past this raw-XOR budget a matrix leaves the baked
# route, as in the reference; the budget bounds host planning time and
# does not depend on the card.
_BAKED_XOR_BUDGET = 60_000

# The fused kernel parks all 8k input planes of a thread in shared memory
# before its network runs, so even its smallest block (one warp) needs
# 8 * k * 32 * 4 B <= 227 KB: k <= 227. Output rows take no slots, and the
# pipeline's kernels hold no whole rows at all. The reference's bound (96,
# on max(k, r)) models its TPU pack stage's VMEM tiles instead.
_BAKED_MAX_ROWS = SMEM_BYTES // (8 * BLOCK_SIZES[-1] * 4)

# Past this raw-XOR budget the reference leaves the XOR-network kernels for
# the dense MXU product (pallas_gf2mm.PANEL_XOR_BUDGET). No GF(2^8) matrix
# of k + r <= 256 shards reaches it: RS(128,128)'s parity network, the
# widest, has 533,504.
PANEL_XOR_BUDGET = 600_000

_MXU_UNPORTED = (
    "matrix exceeds the panel-tier XOR budget: the MXU route is not ported "
    "yet (ROADMAP queue 1, item 4, with GF(2^16), its only other path)"
)

# Pad-to multiple of the words entries: the lane-pack grouping unit at
# TL = 128 (8*8*128 words, 32 KiB per GF(2^8) shard), as in the reference.
WORD_QUANTUM = lane_quantum(8)

_TIERS = (None, "fused", "pipeline")


def pad_words(TW: int) -> int:
    return -(-TW // WORD_QUANTUM) * WORD_QUANTUM


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
    """Runs GF(2^8) matrix x stripes products on ``device`` (module doc)."""

    def __init__(self, field: str = "gf256", device: str = "cuda"):
        if field == "gf65536":
            raise NotImplementedError(
                "GF(2^16) is not ported yet (ROADMAP queue 1, item 4)"
            )
        if field != "gf256":
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
        self.gf: GF = GF256()
        self._rows_cache: dict[bytes, tuple] = {}
        self._cost_cache: dict[bytes, int] = {}
        self._plan_cache: dict[tuple, tuple] = {}
        self._pool = StagingPool(pin=self.device.type == "cuda")

    def _key(self, M: np.ndarray) -> bytes:
        return M.tobytes() + M.shape[1].to_bytes(4, "little")

    def bits_rows_for(self, M: np.ndarray) -> tuple:
        """(r, k) GF matrix -> hashable per-row term tuples of its (8r, 8k)
        bit matrix (cached). A network past the panel tier's XOR budget
        never reaches factoring."""
        if self._xor_cost_for(M) > PANEL_XOR_BUDGET:
            raise NotImplementedError(_MXU_UNPORTED)
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = bits_to_rows(expand_generator_bits(self.gf, M))
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
            bits = expand_generator_bits(self.gf, M)
            hit = int(np.count_nonzero(bits)) - bits.shape[0]
            if len(self._cost_cache) > 4096:
                self._cost_cache.clear()
            self._cost_cache[key] = hit
        return hit

    def route_for(self, M: np.ndarray) -> str:
        """Which kernel family runs this matrix: "baked" (K1, or K2 -> K4
        -> K3), "panel" (wide geometries: K6 -> K7) or "mxu" (past every
        XOR-network budget) — the reference's three-way answer, with the
        port's thresholds (module constants)."""
        k = np.asarray(M).shape[1]
        cost = self._xor_cost_for(M)
        if cost > PANEL_XOR_BUDGET:
            return "mxu"
        if k > _BAKED_MAX_ROWS or cost > _BAKED_XOR_BUDGET:
            return "panel"
        return "baked"

    def plan_for(self, M: np.ndarray, tier: Optional[str] = None) -> tuple:
        """(kind, threads, program on the codec's device, G) for ``M``,
        cached per matrix: G is the number of launches the product's K axis
        is split into.

        On the baked route, ``tier`` None takes the planner's choice:
        "fused" when K1's slots fit (ops/fused.py), else "pipeline"; G is
        1. Passing "fused" or "pipeline" forces one, as the reference's
        plan override does; forcing "fused" on a matrix K1 cannot hold
        raises. A panel-routed matrix plans kind "panel" with a
        :class:`~noise_ec_tpu_torch.ops.network.PanelProgram` and the
        planner's G (ops/panel.py :func:`panel_plan`), and takes no tier.
        The "mxu" route raises NotImplementedError."""
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        route = self.route_for(M)
        if route == "mxu":
            raise NotImplementedError(_MXU_UNPORTED)
        if route == "panel" and tier is not None:
            raise ValueError(
                f"tier {tier!r} forces a baked-route kernel; this matrix "
                "routes 'panel'"
            )
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = (self._key(M), tier)
        hit = self._plan_cache.get(key)
        if hit is None:
            bits_rows = self.bits_rows_for(M)
            C = 8 * M.shape[1]
            if route == "panel":
                threads, prog, G = panel_plan(bits_rows, C)
                hit = ("panel", threads, prog, G)
            else:
                plan = fused_plan(bits_rows, C) if tier != "pipeline" else None
                if plan is not None:
                    kind = "fused"
                elif tier == "fused":
                    raise ValueError("no fused-kernel plan fits this matrix")
                else:
                    kind = "pipeline"
                    plan = sparse_plan(bits_rows, C)
                hit = (kind,) + tuple(plan) + (1,)
            hit = hit[:2] + (hit[2].to(self.device), hit[3])
            if len(self._plan_cache) > 1024:
                self._plan_cache.clear()
            self._plan_cache[key] = hit
        return hit

    # -- words entries (device-resident) ----------------------------------

    def matmul_words(self, M: np.ndarray, words: torch.Tensor, *,
                     tier: Optional[str] = None) -> torch.Tensor:
        """(k, TW) int32 words on the codec's device -> (r, TW) int32.

        The words ARE the shard bytes (little-endian int32 view, 4 symbols
        a word). Any TW is accepted: it is zero-padded on the device to
        :data:`WORD_QUANTUM` and the product sliced back (symbols are
        positionwise, so padding is inert)."""
        return self.matmul_words_batch(M, words[None], tier=tier)[0]

    def matmul_words_batch(self, M: np.ndarray, words: torch.Tensor, *,
                           tier: Optional[str] = None) -> torch.Tensor:
        """(B, k, TW) int32 words -> (B, r, TW): one launch per kernel for
        the whole batch (the kernels take the batch as a grid axis)."""
        M = np.asarray(M)
        r, k = M.shape
        if (words.dtype != torch.int32 or words.dim() != 3
                or words.shape[1] != k):
            raise ValueError(
                f"expected int32 (B, {k}, TW) words, got {words.dtype} "
                f"{tuple(words.shape)}"
            )
        if words.device != self.device:
            raise ValueError(
                f"words on {words.device}, codec on {self.device}"
            )
        kind, threads, prog, G = self.plan_for(M, tier)
        B, _, TW = words.shape
        TWp = pad_words(TW)
        if TWp != TW:
            words = F.pad(words, (0, TWp - TW))
        words = words.contiguous()
        tl = lane_tl(TWp)
        if kind == "fused":
            out = fused_encode_words(prog, words, r, threads, tl)
        elif kind == "panel":
            # Pack and unpack share the blocked TL by construction.
            W8 = TWp // 64
            planes = pack_words_lanes_blocked(words.reshape(B * k, TWp))
            out = gf2_matmul_panel_chain(
                prog, planes.reshape(B, 8 * k, 8, W8), threads, G)
            out = unpack_words_lanes_blocked(out.reshape(B * r, 8, 8, W8))
            out = out.reshape(B, r, TWp)
        else:
            W8 = TWp // 64
            planes = pack_words_lanes(words.reshape(B * k, TWp), tl)
            out = gf2_matmul_sparse(prog, planes.reshape(B, 8 * k, 8, W8),
                                    threads)
            out = unpack_words_lanes(out.reshape(B * r, 8, 8, W8), tl)
            out = out.reshape(B, r, TWp)
        return out[:, :, :TW] if TWp != TW else out

    # -- stripes entries (host arrays) -------------------------------------

    def matmul_stripes(self, M: np.ndarray, D, *,
                       tier: Optional[str] = None) -> np.ndarray:
        """(r, k) GF matrix x (k, S) uint8 stripes -> (r, S), computed on
        the codec's device and returned as a host array."""
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
        self.plan_for(M, tier)  # an unported route raises before staging
        B = len(Ds)
        k, S = Ds[0].shape
        TWp = pad_words(-(-S // 4))
        buf = self._pool.acquire(B * k, 4 * TWp)
        host = buf.numpy()
        for b, D in enumerate(Ds):
            host[b * k:(b + 1) * k, :S] = D
        words = buf.view(torch.int32).reshape(B, k, TWp)
        words = words.to(self.device, non_blocking=True)
        out = self.matmul_words_batch(M, words, tier=tier).cpu()
        # The product is on the host, so the copy out of the staging page
        # has finished: the page may go to the next dispatch.
        self._pool.release(buf)
        res = out.numpy().view(np.uint8)  # (B, r, 4 * TWp)
        return [np.ascontiguousarray(res[b, :, :S]) for b in range(B)]
