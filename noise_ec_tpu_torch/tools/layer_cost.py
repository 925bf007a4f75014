"""Time ``ReedSolomon`` encode and reconstruct at the two sizes where the
host layers around the kernels weigh most and least, on one CUDA device,
for any checkout of the repository.

    python3 noise_ec_tpu_torch/tools/layer_cost.py [--repo DIR] [--out FILE]

``--repo`` names the checkout whose ``noise_ec_tpu_torch`` is imported
(default: the one holding this file), so one command can time two commits
on one card in turns (parent, change, change, parent): run by path, the
script puts ``DIR`` first on the import path. Cases: RS(4,2) on a 64 KiB
message (16 KiB shards, the reference's default geometry, main.go:34-35),
reconstruct at 2 erasures; RS(10,4) at 1 MiB shards, reconstruct at 3.
Each is a host-clock p50 (and p10, p90) over ``--reps`` calls after a warm
up, the clock read around calls that return host arrays. Then the
device-resident ``matmul_words`` at RS(10,4), 1 MiB shards, by CUDA events
behind an L2-flushing write (as ``chip_smoke.py`` times it) and by the
host clock with a synchronise. Where the
checkout has the device gate, the codec breaker and ``device_op``
(``noise_ec_tpu_torch.obs``), one more line times those layers alone
around an empty body: ``record_kernel`` + the route lookup in the plan
cache + the gate + ``device_op``, and the breaker's ``allow`` +
``record_success``, in µs a call, and each of the first four alone; and
two more lines time those layers end to end in one process, free of the
spread between processes: encode and reconstruct with the layers and
without them (:class:`_Bypass`), in ten alternating pairs, at RS(4,2) on
64 KiB and RS(10,4) at 1 MiB. The last line is the card's name and power
limit. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

KIB = 1 << 10
MIB = 1 << 20


def _p(times: list) -> dict:
    q = statistics.quantiles(times, n=10)
    return {"p50_ms": statistics.median(times), "p10_ms": q[0],
            "p90_ms": q[-1], "n": len(times)}


def codec_times(rng, k: int, r: int, shard: int, lost: tuple,
                reps: int) -> dict:
    """encode and reconstruct p50 of ``ReedSolomon(k, r)`` (the default
    device) on k shards of ``shard`` bytes, host clock, in ms."""
    import numpy as np
    import torch

    from noise_ec_tpu_torch.codec import ReedSolomon

    rs = ReedSolomon(k, r)
    data = [rng.integers(0, 256, size=shard, dtype=np.uint8)
            for _ in range(k)]
    enc = rs.encode(data)
    want = ReedSolomon(k, r, backend="numpy").encode(data)
    if not all(np.array_equal(a, b) for a, b in zip(enc, want)):
        raise RuntimeError(f"RS({k},{r}) encode differs from the host")
    damaged = [None if i in lost else s for i, s in enumerate(enc)]
    rec = rs.reconstruct(damaged)
    if not all(np.array_equal(a, b) for a, b in zip(rec, enc)):
        raise RuntimeError(f"RS({k},{r}) reconstruct differs")
    out = {}
    for name, fn in (("encode", lambda: rs.encode(data)),
                     ("reconstruct", lambda: rs.reconstruct(damaged))):
        for _ in range(max(5, reps // 10)):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = _p(times)
    return out


def words_times(rng, reps: int) -> dict:
    """``DeviceCodec.matmul_words`` on RS(10,4)'s parity at 1 MiB shards,
    device-resident: the median CUDA-event interval of one call after a
    256 MiB write (``chip_smoke.py``'s ``Timer``: the write leads the host
    by ~80 µs of device time, and a call whose host work outlasts the lead
    is timed with it), and the host-clock median of one call followed by
    a synchronise."""
    import numpy as np
    import torch

    from noise_ec_tpu_torch.matrix import generator_matrix
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    codec = DeviceCodec()
    M = generator_matrix(codec.gf, 10, 14, "cauchy")[10:]
    w = rng.integers(0, 1 << 32, size=(10, MIB // 4), dtype=np.uint64)
    words = torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda()
    flush = torch.empty(256 * MIB, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        codec.matmul_words(M, words)
    events, host = [], []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        codec.matmul_words(M, words)
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.matmul_words(M, words)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return {"events_ms": statistics.median(events),
            "host_sync_ms": statistics.median(host), "n": reps}


def layers_us(reps: int = 20000) -> dict:
    """The new layers alone, around an empty body, µs a call (an empty
    dict where the checkout has none of them)."""
    try:
        from noise_ec_tpu_torch.obs.device import device_op
        from noise_ec_tpu_torch.obs.profiling import record_kernel
        from noise_ec_tpu_torch.ops.dispatch import codec_breaker, device_gate
    except ImportError:
        return {}
    from noise_ec_tpu_torch.matrix import generator_matrix
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    codec = DeviceCodec()
    M = generator_matrix(codec.gf, 4, 6, "cauchy")[4:]
    codec.plan_for(M)
    br = codec_breaker()

    def per_call(fn) -> float:
        for _ in range(reps // 10):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    gate = device_gate()
    # The record_kernel and device_op parts run the same number of times
    # on one entry of their own, so its calls equal its observations.
    def entry():
        route = codec._admit("layer_cost", M, None, 64 * KIB)
        with device_gate(), device_op("layer_cost", route, 64 * KIB):
            pass

    def admit():
        with gate:
            pass

    def timed():
        with device_op("layer_cost_part", "execute", 64 * KIB):
            pass

    def breaker():
        if br.allow():
            br.record_success()

    out = {"entry_wrap_us": per_call(entry), "breaker_us": per_call(breaker),
           "parts_us": {
               "record_kernel": per_call(
                   lambda: record_kernel("layer_cost_part", 64 * KIB)),
               "route": per_call(lambda: codec._route(M, None)),
               "gate": per_call(admit),
               "device_op": per_call(timed),
           }, "reps": reps}
    out["total_us"] = out["entry_wrap_us"] + out["breaker_us"]
    return out


class _Bypass:
    """Within the block, the codec's calls skip the layers: no
    ``record_kernel``, plan-cache route, gate, ``device_op`` or breaker
    (a stub that always allows). The kernels and the host work around
    them are unchanged."""

    def __enter__(self):
        from noise_ec_tpu_torch.ops import dispatch

        class Timer:
            route, entry = "execute", ""

        class Breaker:
            closed = True

            @staticmethod
            def allow():
                return True

            @staticmethod
            def record_success():
                pass

        breaker = Breaker()
        self._saved = [(dispatch, name, getattr(dispatch, name)) for name in
                       ("device_gate", "device_op", "codec_breaker")]
        self._saved.append((dispatch.DeviceCodec, "_admit",
                            dispatch.DeviceCodec.__dict__["_admit"]))
        dispatch.device_gate = contextlib.nullcontext
        dispatch.device_op = lambda *a, **k: contextlib.nullcontext(Timer)
        dispatch.codec_breaker = lambda: breaker
        dispatch.DeviceCodec._admit = lambda *a, **k: "execute"
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return False


def layers_ab(rng, k: int, r: int, shard: int, lost: tuple,
              pairs: int = 10, reps: int = 100) -> dict:
    """The layers' end-to-end cost in one process: ``pairs`` pairs of
    blocks of ``reps`` encodes and reconstructs of ``ReedSolomon(k, r)``,
    one block with the layers and one without (:class:`_Bypass`), the
    order alternating pair by pair. Per pair the p50 of each side, in
    ms; the change is "on" less "off". An empty dict where the checkout
    has no layers."""
    import numpy as np
    import torch

    try:
        from noise_ec_tpu_torch.ops.dispatch import codec_breaker  # noqa: F401
    except ImportError:
        return {}
    from noise_ec_tpu_torch.codec import ReedSolomon

    rs = ReedSolomon(k, r)
    data = [rng.integers(0, 256, size=shard, dtype=np.uint8)
            for _ in range(k)]
    enc = rs.encode(data)
    damaged = [None if i in lost else s for i, s in enumerate(enc)]
    out = {}
    for name, fn in (("encode", lambda: rs.encode(data)),
                     ("reconstruct", lambda: rs.reconstruct(damaged))):
        for _ in range(max(5, reps // 10)):
            fn()
        with _Bypass():
            got = fn()
        if not all(np.array_equal(a, b) for a, b in zip(got, fn())):
            raise RuntimeError("the bypassed call differs")
        sides = {"on": [], "off": []}
        for i in range(pairs):
            for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
                torch.cuda.synchronize()
                times = []
                with (_Bypass() if side == "off"
                      else contextlib.nullcontext()):
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        fn()
                        times.append((time.perf_counter() - t0) * 1e3)
                sides[side].append(statistics.median(times))
        diffs = [a - b for a, b in zip(sides["on"], sides["off"])]
        out[name] = {
            "on_p50_ms": sides["on"], "off_p50_ms": sides["off"],
            "median_on_ms": statistics.median(sides["on"]),
            "median_off_ms": statistics.median(sides["off"]),
            "median_diff_us": statistics.median(diffs) * 1e3,
            "on_slower_pairs": sum(d > 0 for d in diffs), "pairs": pairs,
        }
    return out


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        here)), help="checkout whose noise_ec_tpu_torch is timed")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="also append every JSON line here")
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("layer_cost: no CUDA device", file=sys.stderr)
        return 1
    import noise_ec_tpu_torch

    if not noise_ec_tpu_torch.__file__.startswith(repo + os.sep):
        print(f"layer_cost: imported {noise_ec_tpu_torch.__file__}, not "
              f"from {repo}", file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    emit({"tree": repo, "case": "RS(4,2) 64 KiB message",
          **codec_times(rng, 4, 2, 16 * KIB, (1, 4), args.reps)})
    emit({"tree": repo, "case": "RS(10,4) 1 MiB shards",
          **codec_times(rng, 10, 4, MIB, (0, 5, 11),
                        max(20, args.reps // 4))})
    emit({"tree": repo, "case": "RS(10,4) matmul_words 1 MiB shards",
          **words_times(rng, 50)})
    emit({"tree": repo, "case": "layers alone", **layers_us()})
    emit({"tree": repo, "case": "RS(4,2) 64 KiB, layers on and off in turn",
          **layers_ab(rng, 4, 2, 16 * KIB, (1, 4))})
    emit({"tree": repo, "case": "RS(10,4) 1 MiB, layers on and off in turn",
          **layers_ab(rng, 10, 4, MIB, (0, 5, 11), reps=20)})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    emit({"tree": repo, "seconds": time.monotonic() - t0,
          "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip()})
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
