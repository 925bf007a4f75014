"""Time and trace the two kernels that run the factored XOR network, K1
(the fused encode, m = 8 and 16) and K4 (the sparse GF(2) matmul), on one
CUDA device.

    python3 -m noise_ec_tpu_torch.tools.xornet_profile [--out FILE]

For each case it prints one JSON line: the plan's numbers (block threads,
slots and XORs, and the schedule's tiles, levels and program bytes) and
the CUDA-event median with the L2 cache flushed before each launch; after
every case, one line a case with the kernels' device time from a
``torch.profiler`` trace of a few launches. The first line holds what
``ptxas`` printed for the kernels' sources (registers, spills), the last
the card's name and power limit. Cases: K1 on RS(10,4) at 1 MiB, 64 KiB
and 32 KiB shards, on RS(17,3), RS(30,10) and RS(40,12) at 1 MiB; K1@16
on GF(2^16) RS(10,4); K4 on RS(10,4)'s 80 planes and on GF(2^16)
RS(30,10)'s 480; and the GF(2^16) RS(30,10) interleaved entry forced onto
the pipeline (K2@16 -> K4 -> K3@16). ``--sweep`` times every K1 and K4
case again at each column tile its schedule fits and each block size the
kernels take (``sweep`` lines), the planner's choice among them. Without
a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

MIB = 1 << 20
REPS = 20


def _words(rng, shape, device) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


class _Timer:
    """CUDA-event median with a 256 MiB write (five times the L2) before
    each launch."""

    def __init__(self, device):
        self.flush = torch.empty(256 * MIB, dtype=torch.uint8, device=device)

    def median_ms(self, fn, reps: int = REPS) -> float:
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def _device_us(fn, reps: int = 5) -> dict:
    """Device time per kernel name over ``reps`` calls of ``fn``, from a
    torch.profiler trace (microseconds a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and "kernel" in ev.key:
            out[ev.key[:80]] = {"count": ev.count, "us_per_call": t / reps}
    return out


def _tile(tile) -> dict:
    """The wrappers' tile argument: none for the plan's own."""
    return {} if tile is None else {"tile": tile}


def _plan_info(threads, prog) -> dict:
    info = {"threads": threads, "slots": prog.n_slots, "xors": prog.cost}
    for key in ("n_levels", "n_ops", "program_bytes", "n_chunks", "tiles",
                "reload"):
        if hasattr(prog, key):
            info[key] = getattr(prog, key)
    return info


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also write every JSON line here")
    parser.add_argument("--sweep", action="store_true",
                        help="also time each case at every tile and block")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("xornet_profile: no CUDA device", file=sys.stderr)
        return 1
    from noise_ec_tpu_torch.gf import GF256, GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix
    from noise_ec_tpu_torch.ops import _build
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import fused_encode_words
    from noise_ec_tpu_torch.ops.gf2mm import gf2_matmul_sparse
    from noise_ec_tpu_torch.ops.network import BLOCKS

    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    _build.library()
    emit({"ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if re.search(r"registers|spill|Compiling", ln)]
                    for name, log in _build.build_log.items()
                    if name in ("fused", "gf2mm")}})
    timer = _Timer(device)
    codec = DeviceCodec(device=device)
    codec16 = DeviceCodec(field="gf65536", device=device)
    gf, gf16 = GF256(), GF65536()

    def parity(g, k, r):
        return generator_matrix(g, k, k + r, "cauchy")[k:]

    traces = []

    def run(name, threads, prog, fn, **extra):
        """Time ``fn(threads, tile)`` at the plan's block and tile; with
        --sweep also at every other tile and block. The trace comes after
        every timing: the profiler's teardown slows the host for a while,
        and a slow host shows in an event interval."""
        emit({"case": name, **_plan_info(threads, prog), **extra,
              "ms": timer.median_ms(lambda: fn(threads, None))})
        traces.append((name, lambda: fn(threads, None)))
        if not args.sweep or name.startswith("pipeline"):
            return
        emit({"sweep": name, "ms": {
            f"{tile}x{t}": timer.median_ms(lambda: fn(t, tile))
            for tile in prog.tiles for t in BLOCKS}})

    for (k, r), tws in (((10, 4), (MIB // 4, 16384, 8192)),
                        ((17, 3), (MIB // 4,)), ((30, 10), (MIB // 4,)),
                        ((40, 12), (MIB // 4,))):
        M = parity(gf, k, r)
        _, t1, p1, _ = codec.plan_for(M, "fused")
        for tw in tws:
            w = _words(rng, (k, tw), device)
            run(f"K1 RS({k},{r}) {4 * tw} B", t1, p1,
                lambda t, tile, p1=p1, w=w, r=r: fused_encode_words(
                    p1, w, r, t, **_tile(tile)))
    M = parity(gf16, 10, 4)
    _, t1, p1, _ = codec16.plan_for(M, "fused")
    w = _words(rng, (10, MIB // 4), device)
    run("K1@16 GF(2^16) RS(10,4) 1048576 B", t1, p1,
        lambda t, tile, p1=p1, w=w: fused_encode_words(
            p1, w, 4, t, m=16, **_tile(tile)))
    for name, cx, (k, r), m in (("K4 RS(10,4)", codec, (10, 4), 8),
                                ("K4 GF(2^16) RS(30,10)", codec16, (30, 10),
                                 16)):
        M = parity(gf if m == 8 else gf16, k, r)
        _, tp, pp, _ = cx.plan_for(M, "pipeline")
        cols = MIB // 4 // m
        x = _words(rng, (m * k, 8, cols // 8), device)
        run(f"{name} 1048576 B", tp, pp,
            lambda t, tile, pp=pp, x=x: gf2_matmul_sparse(
                pp, x, t, **_tile(tile)),
            planes=[m * k, m * r])
    M = parity(gf16, 30, 10)
    w = _words(rng, (30, MIB // 4), device)
    _, tp, pp, _ = codec16.plan_for(M, "pipeline")
    run("pipeline GF(2^16) RS(30,10) 1048576 B", tp, pp,
        lambda t, tile, M=M, w=w: codec16.matmul_words(M, w,
                                                        tier="pipeline"))
    for name, fn in traces:
        emit({"trace": name, "device_us": _device_us(fn)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
