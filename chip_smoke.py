"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; without a device it exits non-zero
before printing any result. Phases (one JSON line each):

1. build — build the CUDA kernels from ``noise_ec_tpu_torch/csrc``, check
   that no K8 kernel and no K9/K10 instantiation spills (ptxas; K9/K10's
   registers are listed) and, where the toolkit has
   ``cuobjdump``, that the library's SASS holds wgmma (IGMMA) and no
   mma.sync (IMMA), and name the card (and its power limit, from
   nvidia-smi);
2. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes (1 MiB shards), byte for byte, and the fused
   kernel K1 (on every matrix of :func:`matrices`) and the sparse matmul K4
   (RS(10,4)'s parity and {0, 5, 11} recovery matrix) also against the
   NumPy field arithmetic, each with its schedule's block (tile, warps,
   slots, levels, program bytes);
   panel_kernels — the row-blocked pack and unpack (200 and 56 rows) at
   RS(200,56), and the panel matmul K7 on every matrix the panel route
   runs it on (RS(200,56)'s parity and (56,200) recovery matrix, RS(100,30),
   RS(229,6) at 64 KiB, GF(2^16) RS(60,20) byte-sliced and interleaved),
   each against its plain version and the NumPy field arithmetic on a 64
   KiB slice; at RS(200,56) also in the reference's three sub-launches,
   with the K tiles split over four blocks, as an accumulating launch split
   over three, and on a ragged width;
   gf16_kernels — the dense GF(2) product K8 against its plain version at
   full width (1 MiB shards) on the four matrices the main path runs it
   on: RS(200,56)'s GF(2^16) parity and its (56, 200) and (28, 200)
   recovery matrices over 400 byte rows, and a dense (200, 200) GF(2^8)
   matrix (each also against the NumPy field arithmetic on a 64 KiB
   slice), RS(200,56) in a batch of two, and an odd K (random (3, 5) bits)
   at a ragged width in a batch of two; and the 16-plane pack and unpack
   K10 at RS(10,4)'s GF(2^16) shapes, with their round trip, and at the
   shapes each lanes-a-thread width covers (:func:`check_groups`);
   split_kernels — the K-sliced fused encode K5 against its plain version,
   at its plan and with its phases split over three blocks, on RS(50,20)'s
   parity and (20, 50) recovery matrix, RS(30,10), RS(40,12), GF(2^16)
   RS(30,10) and RS(10,4) (each also against the NumPy field arithmetic
   on a 64 KiB slice, RS(10,4) also against K1), on a batch of three and
   on ragged words through the codec; and through its row maps at the
   benchmark's rebuild geometry (6+3 and 10+4 at m = 8, 6+3 at m = 16;
   survivors out of order, the product stored into a sentinel-filled
   codeword), against the plain version under the same maps and the
   gathered call, with ``reconstruct_batch_words`` on the in-place path;
   dense_kernels — the sublane pack and unpack K9 at RS(10,4)'s 1 MiB
   shards and at TW = 3,072 (TL = 384), and at TL = 129, 130, 384 and
   512, 4 bytes off a 16-byte boundary and through both stride loops
   (:func:`check_groups`), and the dense-mask products K11
   and K12 on RS(10,4)'s (32, 80) select masks, random-word masks of that
   shape and RS(50,20)'s (160, 400) masks, at W = 32,767 and 1,001, on
   planes 4 bytes off a 16-byte boundary, with sliced masks, at R = 20 and
   at a width that takes the K split, each against its plain version and
   K12 also against K11 and the sparse K4;
   words16_kernels — the m = 16 forms (16 bit-planes a GF(2^16) symbol on
   the interleaved words entry): K5@16 at its plan and with its phases
   split over three blocks on GF(2^16) RS(10,4), RS(17,3) and RS(30,10)'s
   parity and RS(30,10)'s (10, 30) recovery matrix (each also against the
   NumPy field arithmetic on a 64 KiB slice), K1@16 forced on RS(10,4)
   and RS(17,3) (also against K5@16), the lane pack and unpack at m = 16
   at TL = 128 and 512 on those words and at the blocked TL on RS(50,20)'s
   shapes, a batch of three and ragged words through the codec, the
   forced tier 3 at RS(49,2) kernel by kernel, and K4 alone on GF(2^16)
   RS(30,10)'s 160 x 480 pipeline program (also against the NumPy field
   arithmetic);
3. main_path — ``ReedSolomon(10, 4)`` on the card: split a 10 MiB object,
   encode, verify, lose shards {0, 5, 11}, reconstruct, join; a batch of
   five 1 MiB stripes through the coalescer; RS(4,2) on a 64 KiB message;
   one product forced through the pack -> sparse matmul -> unpack
   pipeline and one forced through the fused kernel K1 (the planner takes
   K5 first). Then the panel route: ``ReedSolomon(200, 56)`` on a 200 MiB
   object (encode, verify, lose 28 data and 28 parity shards, reconstruct,
   reconstruct_data, join; the NumPy codec checks a 64 KiB column slice),
   and ``ReedSolomon(229, 6)`` at 64 KiB shards. Launch counts are zeroed
   just before each path and read just after, and every kernel of a path
   must have launched (the accumulating panel launch is on no path: the
   planner splits no K axis). Then GF(2^16): ``ReedSolomon(10, 4,
   field="gf65536")`` on a 10 MiB object (K5 over 20 byte rows) and
   ``ReedSolomon(200, 56, field="gf65536")`` on a 200 MiB object (K8 on
   encode and on the 56-erasure reconstruct), each through encode, verify,
   reconstruct, reconstruct_data and join; the interleaved-u16
   ``matmul_words`` (K10 around K4 at RS(10,4), around K7 at RS(60,20)),
   equal to the byte-sliced entry's result; and a dense (200, 200) GF(2^8)
   matrix through ``matmul_stripes`` (K8). The interleaved words entry
   runs K5@16 at RS(10,4), K6@16 -> K7 -> K6@16 at RS(60,20), and, forced
   onto the pipeline past the reference's 48 lane-tile rows, K10 -> K4 ->
   K10 at RS(49,2). Then the GF(2^16) streams at 1 MiB shards:
   ``StreamingEncoder(30, 10, field="gf65536")`` on 240 MiB in 30 MiB
   chunks, decoded at ten data erasures (K5@16 both ways), and
   ``StreamingEncoder(50, 20, field="gf65536")`` on 400 MiB, decoded at 10
   data + 10 parity erasures (K6@16 -> K7 -> K6@16), neither launching
   K10; and ``BatchCodec(10, 4, field="gf65536")`` on a batch of four
   under the planner's tier and each forced one. Then the streams (BASELINE
   config 3): ``StreamingEncoder(50, 20)`` on 400 MiB in 50 MiB chunks,
   decoded by ``StreamingDecoder`` at 10 data + 10 parity erasures (K5
   both ways); RS(17,3) on 272 MiB in 17 MiB chunks, decoded at 3 (K5);
   64 MiB in 4 MiB chunks at RS(50,20) with a short tail, through
   ``decode_stream``; and ``ReedSolomon(30, 10, field="gf65536")`` on a
   30 MiB object, encode and a 10-erasure reconstruct (K5). Then the
   dense-mask ops API (RS(10,4) parity of 1 MiB shards through K9 -> K11
   or K12 -> K9); the port's hardware check
   (``noise_ec_tpu_torch.tools.hwcheck``, its 51 checks on the card, which
   run K9 on its tier 3); and ``FEC(10, 14)`` with 1 MiB shares on both
   decode routes: encode, then decode of the first k shares, of all 14
   with one wholly corrupt (the device route's decode1 fold), and of all
   14 with scattered corruption (the syndrome), and GF(2^16) ``FEC(10,
   14)`` with one wholly corrupt share (the byte-sliced fold);
   resilience — the codec breaker on the card: RS(10,4) at 1 MiB shards
   with ``DeviceCodec.matmul_stripes_many`` patched to raise (two
   attempts, the trip, ``CodecUnavailableError`` with
   ``noise_ec_codec_refused_total`` reason "error", then encode and
   reconstruct refused with reason "open", and no product run on the
   host), the prober's canary re-closing the breaker on the card within
   30 s and the next encode (K5) and reconstruct on the card, equal to
   the host arithmetic; a launch patched to raise ``KernelLaunchError``,
   which propagates with the breaker closed and the counters unchanged;
   8 threads of RS(10,4) encodes, 4 in the live lane and 4 in the
   background lane, through a capacity-2 gate, byte-equal, each lane's
   grants counted; then the breaker and the gate are reset;
   lrc — ``LocalReconstructionCode`` LRC(12,2,2), LRC(40,8,8) and
   LRC(200,10,46) at 1 MiB shards: encode, every single loss of every
   group cell healed locally (k/g reads), two losses in one cell through
   the global reconstruct, ``repair_many`` of three stripes, each held
   byte-equal to the NumPy LRC with the same tier counters; each matrix's
   ``route_for``, and encode GB/s, local-heal p50 and global-reconstruct
   p50. These two phases, ``node`` and ``store`` (5 and 6 below) print their paths'
   launches on their own lines (``by_path``, ``launches``, ``by_run``);
   the kernels line keeps the main path's;
4. times — CUDA-event medians with the L2 cache flushed between launches:
   each kernel and its plain version beside the least time the card could
   take, the codec's RS(10,4) encode rate (device-resident words and end
   to end from host arrays) and reconstruct p50 at 3 erasures, and the
   same three numbers for RS(200,56) at 1 MiB shards; the panel matmul
   beside its own operation floor, also on the (56,200) recovery matrix
   and on RS(229,6)'s parity;
   gf16_times — K8 beside its bound on RS(200,56)'s GF(2^16) parity, its
   (28, 200) recovery matrix and the dense (200, 200) GF(2^8) matrix, and
   beside ``torch._int_mm`` on the pre-expanded bits, row-major and
   transposed (a yardstick for the dot alone), K10 beside its byte
   bounds, ``matmul_words_bytesliced`` and the interleaved ``matmul_words``,
   ``encode`` GB/s and ``reconstruct`` p50 at 3 and at 56 erasures over
   GF(2^16), and the seconds to plan a new recovery matrix;
   split_times — K5 at RS(50,20) beside its bound, its own operation
   floor, its plain version and the K9 -> K11 -> K9 chain on the same
   matrix, and on the recovery matrix; ``matmul_words`` there through K5
   and through the forced pipeline; K1 against K5 from RS(4,2) to
   RS(50,20) at 1 MiB shards, and on RS(4,2), RS(10,4) and RS(17,3) at the
   main path's small shards (16 to 64 KiB); the seconds to plan a new RS(50,20) recovery matrix; stream
   encode and decode GB/s from host bytes at RS(17,3) and RS(50,20) with
   the device's share of the wall time;
   words16_times — K5@16, K1@16 and the lane and blocked packs at m = 16
   beside their bounds and plain versions; the interleaved entry per tier
   at GF(2^16) RS(10,4) and RS(30,10) beside the byte-sliced entry and the
   matrix's bound, and at RS(10,4) beside K10 -> K4 -> K10 (its route
   before the m = 16 forms); GF(2^16) stream encode and decode GB/s with
   the device's share;
   dense_times — K9, K11 and K12 beside their bounds and plain versions
   at RS(10,4)'s shapes, and K11 on RS(50,20)'s masks, with K11's block
   shape and K split;
   fec_times — the FEC decode p50 per case and route on the host clock
   (the host route on the native shim, its calls counted per case),
   beside the CUDA-event time of the device route's product;
   layer_cost — RS(4,2) on a 64 KiB message and RS(10,4) at 1 MiB
   shards, encode and reconstruct p50, the gate, ``device_op``,
   ``record_kernel`` and the breaker alone, and the two cases with those
   layers on and off in turn in one process
   (``noise_ec_tpu_torch/tools/layer_cost.py``);
   mesh — the mesh tier on the one card: the default router disabled
   (``noise_ec_mesh_devices`` reads 1); a router over ``cuda:0`` listed
   four times, each position on its own stream, running RS(10,4) and
   RS(50,20) words batches at 1 MiB shards (B = 5 and 8, K5 on every
   shard), an RS(229,6) panel batch (K6 -> K7, tile-labelled), a GF(2^16)
   RS(10,4) byte-sliced batch, a chained encode -> decode1 (the decode
   reshards nothing) and ``make_sharded_encoder_words`` over a (2, 2) mesh
   at RS(10,4) (K5) and the near-limit RS(200,56) (K8), each byte-equal
   to the single-device route and the host on a 64 KiB slice, with each
   run's launches a shard (``by_run``); ``multihost.initialize`` as a
   world of one over NCCL in a child process, with one sharded encode;
   the peak memory over 50 donated steady-state batch encodes (no growth
   after the first); and RS(10,4) B = 8 sharded against unsharded
   (four positions of one card show the split's overhead, not multi-GPU
   speed);
5. node, after every timed phase (its threads, sockets and objects stay
   out of their process state) — the reference's program on the port
   (``noise_ec_tpu_torch.host``, with the Ed25519 backend named): 4
   senders x 24 distinct 64 KiB messages at the reference's RS(4,2) over
   TCP on 127.0.0.1 into one receiver with ``recv_shards=2``, in one
   process (msg/s, MB/s, p50/p99 of ``noise_ec_e2e_latency_seconds``,
   every payload byte-equal, the span stages' host milliseconds), and one
   64 MiB object at RS(10,14) in 4 MiB chunks between two loopback nodes
   (best of 3 MB/s, byte-equal, delivered once), each on the device
   backend (K5 launched; the K5 product timed alone times the products,
   over the wall time) and on the numpy backend (the native shim; no
   launch); no geometry rate-limited and no host-only codec; then two CLI
   processes on the card (``-device cuda``): a line and a ``/send`` of a
   64 MiB file, each received byte-equal, a ceiling on every wait, both
   processes stopped;
6. store, after node — the stripe store, placement and the object
   service on the card, at ``bench.py``'s on-card sizes: RS(10,4), 16
   stripes of 10 x 1 MiB with shards 0 and 1 of each dropped, healed by
   one scrub cycle and one repair drain in one batched dispatch (best of
   3 GB/s, byte-equal, K5's launches and its product's device time over
   the window); a clean scrub cycle (one (4,10) x (10, 16 MiB) product),
   then one flipped parity byte flagged once and restored; the LRC
   repair storm, RS(40,16) then LRC(40,8,8) over 8 stripes of 8 KiB
   shards, one data loss a stripe (``repair_fetch_amplification`` exactly
   0.125, each code's heal time and routes); a 32 MiB object converted
   from RS(10,4) to LRC(40,8,8) by a tenant policy (byte-equal, also
   degraded); ``ObjectStore`` PUT and degraded GET of 32 MiB (best of 3
   MB/s) and a zipfian hot-read mix over the decoded cache (hit rate, MB/s);
   six loopback nodes in six failure domains, an 8 MiB targeted PUT (each
   shard sent once, to its ring owner) and a GET through the gather
   tier; two CLI processes with ``-store-dir``, ``-object-port 0`` and
   ``-scrub-interval 1``: a 32 MiB PUT over HTTP to one, a GET from the
   other, and again after it restarts from its store directory. Each
   run's launches are on the phase's line (``by_run``); every engine is
   closed and its thread joined;
7. chaos_obs, after store — the failure and observability layers through
   the reference's own CLI flags: two CLI processes on the card at
   RS(4,2); B dials A through ``-chaos-profile`` (5% drop, 1% corrupt, a
   reset 2 s and a 2 s partition of A's payloads 4 s into the send, a
   fixed ``-chaos-seed``), pulls A's spans (``-trace-peers``,
   ``-collect-traces``), federates both nodes' ``/metrics``
   (``-federate``) and saves what it receives (``-recv-dir``); both keep
   a stripe store and a flight recorder (``-incident-dir``) and A
   announces its stripes. A broadcasts 200 lines of 64 KiB: all 200 must
   arrive byte-equal (reconnect, NACK repair, announce), B's ``/healthz``
   must go 503 and back to 200, exactly one bundle must be written (on
   the flip), the merged trace must hold both nodes, ``/fleet/metrics``
   must sum both nodes' ``noise_ec_kernel_calls_total`` and
   ``/diagnose`` answer; each node must launch K5 (its
   ``noise_ec_kernel_launches`` gauge on ``/metrics``) and refuse
   nothing;
8. fleet, last — a 200-peer ``FleetLab`` (fanout 6, 500 messages, 90%
   chat, ``lossy``) with every peer's plugin and store on the card:
   delivery >= 0.999, sheds apart from losses, msgs/s, object MB/s, e2e
   p50/p99, K5's launches and its device time over the run from a
   torch.profiler trace of the run (and the share of the wall it and all
   device work take), the gate's peak depth, the process's threads and
   the peers' pinned staging bytes, the report JSON and its Perfetto
   trace, no device failure among the lab's errors; then the straggler
   drill (24 peers, a slow owner, hedged GETs through
   ``placement_fetch``), on the card and then on numpy peers with the
   same seed: its hedge counters, the tenant GET p99, and the GET
   outcomes: the run's hot GETs (a read of an object whose manifest never
   reached the reader is "missing", by the lab's traffic; none may fail
   after it resolves or return wrong bytes) and the post-run reads of
   every put object from every expected receiver, which must all return
   its bytes.

Each phase's line carries its seconds and its ``health``, checked after
the phase as differences across it: no product fell back to the host
(the reference's ``noise_ec_codec_fallback_total``, which the port never
records, reads 0 for "error" and "open"), the breaker refused no product
(``noise_ec_codec_refused_total``; the resilience phase, the ones it
provokes), the codec breaker is closed, the device gate is idle, every
public-entry call of the phase was timed by ``device_op`` (less the one
launch the resilience phase makes fail), each entry it used has
execute-route observations, every tile label names a K7 plan, the
main path's and the mesh's panel dispatches carry one, and their warm
stripes calls reused staging pages. A miss fails the run.

Then a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
``--panel-sweep`` adds, before those two lines, K7's time under other
tile shapes than the planner's, on the three panel matrices that
``panel_times`` times, and K5's on RS(50,20); ``--mxu-sweep`` K8's at
every wgmma width it is built for on RS(200,56)'s GF(2^16) parity and the
dense GF(2^8) matrix, and the timing probes of ``csrc/mxu_probe.cu`` (K8
with parts of its work taken away, and the bare wgmma rate);
``--dense-sweep`` K11's under other launch shapes than ``dense_shape``'s
and the probes of ``csrc/dense_probe.cu`` (K11 with its product or its
copies left out), by CUDA events and torch.profiler's device time;
``--pack-sweep`` every pack by events and device time beside a copy of its
input's bytes, and K9/K10 at every lanes-a-thread width and block size.
``--out FILE`` also writes every JSON line to FILE.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MIB = 1 << 20
SHARD = MIB  # bytes per shard on the main path
TW = SHARD // 4  # int32 words per shard
REPS = 20
# The plain panel matmul runs one PyTorch op per XOR (~150k at RS(200,56)),
# seconds a call: it is timed on fewer reps, and host-array codec calls at
# RS(200,56) likewise.
PLAIN_PANEL_REPS = 2
WIDE_REPS = 5
# RS(200,56) parity and recovery are checked against the NumPy codec on
# this many leading bytes of every shard: host arithmetic at full width
# takes minutes, and the product is positionwise.
HOST_SLICE = 64 << 10
# 28 data and 28 parity shards lost (every other one of each).
WIDE_LOST = tuple(range(0, 56, 2)) + tuple(range(200, 256, 2))
# H100 SXM peaks: HBM bandwidth, and 32-bit logic ops (64 LOP3 lanes per
# SM per clock x 132 SMs x 1.98 GHz — a quarter of the 67 TFLOP/s fp32
# figure, which counts 128 FMA lanes at 2 flops each).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
# Dense int8 tensor-core operations (multiply and add each count one).
INT8_OPS_PER_S = 1.979e15
# 3 delta-swap rounds x 4 pairs x 6 ops per 8-word group transpose; 4
# rounds x 8 pairs x 6 ops per 16-word group.
TRANSPOSE_OPS = 72
TRANSPOSE16_OPS = 192
# Int32 words a GF(2^16) shard's byte row holds in the byte-sliced layout.
TWB = SHARD // 8
# A panel matmul's bound charges the XORs of the network cut into the
# reference's 128 x 32 panels (pallas_gf2mm's panel plan), each factored
# uncapped, whatever panels the planner picks: a plan that factors worse
# does not loosen its own bound.
REF_PANEL_KB, REF_PANEL_RB = 128, 32
LIBRARY_NOTE = ("no single PyTorch call computes a GF(2^8) or GF(2^16) "
                "matrix product, a GF(2) product that unpacks, takes parity "
                "and repacks, or these bit transposes")


# Where --out copies every line emit() prints.
_OUT: list = []


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for f in _OUT:
        f.write(line + "\n")
        f.flush()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rand_words(rng, shape, device) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each.

    The flush writes 256 MiB (five times the 50 MB L2, ~80 us of device
    time), long enough for the host to have the timed call's launches
    queued before the start event fires, so the interval holds device
    time and not the wrapper's Python overhead.
    """

    def __init__(self, device):
        self.flush = torch.empty(256 * MIB, dtype=torch.uint8, device=device)

    def median_ms(self, fn, reps: int = REPS, warmup: bool = True) -> float:
        if warmup:
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


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xornet_plan(threads: int, sched, columns: int, batch: int = 1) -> dict:
    """A K1 or K4 plan's block for a call of ``batch`` x ``columns``
    columns: the column tile it takes, its warps, the schedule's slots,
    levels, program bytes, ring chunks and XORs."""
    from noise_ec_tpu_torch.ops.network import pick_tile

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"tile": pick_tile(sched, columns, batch, sms),
            "warps": threads // 32, "slots": sched.n_slots,
            "levels": sched.n_levels, "program_bytes": sched.program_bytes,
            "chunks": sched.n_chunks, "xors": sched.cost}


def phase_build() -> dict:
    from noise_ec_tpu_torch.ops import _build
    from noise_ec_tpu_torch.ops.mxu import N_MENU

    t0 = time.monotonic()
    _build.library()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if re.search(r"registers|spill", ln)]
        for name, log in _build.build_log.items()
    }
    # K8 builds one kernel a wgmma width: none may spill. A build read from
    # the checkout's cache brings its log back; a missing log fails here.
    k8_log = [ln for ln in ptxas.get("mxu", []) if "spill" in ln]
    check(len(k8_log) >= len(N_MENU),
          f"ptxas log of K8's {len(N_MENU)} kernels: {k8_log}")
    k8_spills = [ln for ln in k8_log if not re.search(
        r"0 bytes spill stores, 0 bytes spill loads", ln)]
    check(not k8_spills, f"K8 kernels spill: {k8_spills}")
    groups = groups_registers(_build.build_log.get("pack", ""))
    check(len(groups) == 12 and not any(g["spill"] for g in groups),
          f"K9/K10's 12 instantiations, none spilling: {groups}")
    sass = sass_counts(_build.build())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {
        "phase": "build", "seconds": round(time.monotonic() - t0, 3),
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "ptxas": ptxas, "sass": sass, "k9_k10_registers": groups,
    }


def groups_registers(log: str) -> list:
    """K9/K10's instantiations in ``pack.cu``'s ptxas log
    (``groups_kernel<N, V, kPack>``), each with its registers and whether
    it spills."""
    out = []
    for entry in log.split("Compiling entry function")[1:]:
        name = re.search(r"groups_kernelILi(\d+)ELi(\d+)ELb([01])E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        if name and regs:
            out.append({"N": int(name.group(1)), "V": int(name.group(2)),
                        "pack": name.group(3) == "1",
                        "registers": int(regs.group(1)),
                        "spill": bool(spill and (int(spill.group(1))
                                                 or int(spill.group(2))))})
    return out


def sass_counts(library) -> dict:
    """Tensor-core instructions in the built library's SASS (``cuobjdump
    -sass``, where the toolkit has it): K8 must run on wgmma (IGMMA, the
    integer warpgroup product), and no kernel on mma.sync (IMMA)."""
    from noise_ec_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", text))
              for op in ("IGMMA", "IMMA", "HGMMA")}
    check(counts["IGMMA"] > 0 and counts["IMMA"] == 0,
          f"K8 on wgmma and nothing on mma.sync: {counts}")
    return counts


def matrices():
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )

    gf = GF256()
    out = {}
    for k, r in ((4, 2), (10, 4), (17, 3), (50, 20)):
        out[f"RS({k},{r})"] = generator_matrix(gf, k, k + r, "cauchy")[k:]
    G = generator_matrix(gf, 10, 14, "cauchy")
    present = [i for i in range(14) if i not in (0, 5, 11)][:10]
    out["RS(10,4) reconstruct {0,5,11}"] = reconstruction_matrix(
        gf, G, present, [0, 5, 11]
    )
    return gf, out


def phase_kernels(rng, device, results: dict) -> dict:
    from noise_ec_tpu_torch.matrix import host_matvec
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_encode_words_plain,
        fused_plan,
    )
    from noise_ec_tpu_torch.ops.gf2mm import (
        gf2_matmul_sparse,
        gf2_matmul_sparse_plain,
        sparse_plan,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_lanes,
        pack_words_lanes_plain,
        unpack_words_lanes,
        unpack_words_lanes_plain,
    )

    report = {"phase": "kernels"}
    words = rand_words(rng, (10, TW), device)
    for tl in (128, 256, 512):
        planes = pack_words_lanes(words, tl)
        err_p = max_abs_err(planes, pack_words_lanes_plain(words, tl))
        back = unpack_words_lanes(planes, tl)
        err_u = max_abs_err(back, unpack_words_lanes_plain(planes, tl))
        torch.cuda.synchronize()
        check(err_p == 0 and err_u == 0, f"pack/unpack TL={tl} vs plain")
        check(torch.equal(back, words), f"pack/unpack TL={tl} round trip")
        report[f"pack_unpack_tl{tl}"] = "equal"
        results["pack_lanes"]["max_abs_err"] = max(
            results["pack_lanes"]["max_abs_err"], err_p)
        results["unpack_lanes"]["max_abs_err"] = max(
            results["unpack_lanes"]["max_abs_err"], err_u)

    gf, mats = matrices()
    codec = DeviceCodec(device=device)
    # K4 on RS(10,4)'s parity and {0, 5, 11} recovery matrix, against its
    # plain version and, unpacked, the NumPy field arithmetic.
    for name in ("RS(10,4)", "RS(10,4) reconstruct {0,5,11}"):
        M = mats[name]
        threads, prog = sparse_plan(codec.bits_rows_for(M), 80)
        prog = prog.to(device)
        planes = pack_words_lanes(words, 512).reshape(80, 8, TW // 64)
        out = gf2_matmul_sparse(prog, planes, threads)
        err = max_abs_err(out, gf2_matmul_sparse_plain(prog, planes))
        back = unpack_words_lanes(
            out.reshape(M.shape[0], 8, 8, TW // 64), 512)
        host = host_matvec(gf, M, words.cpu().numpy().view(np.uint8))
        torch.cuda.synchronize()
        check(err == 0, f"sparse matmul {name} vs plain")
        check(np.array_equal(back.cpu().numpy().view(np.uint8), host),
              f"sparse matmul {name} vs host_matvec")
        report[f"gf2mm_{name}"] = xornet_plan(threads, prog, TW // 8)
        results["gf2mm_sparse"]["max_abs_err"] = max(
            results["gf2mm_sparse"]["max_abs_err"], err)

    fused = {}
    for name, M in mats.items():
        r, k = M.shape
        bits_rows = codec.bits_rows_for(M)
        t0 = time.monotonic()
        plan = fused_plan(bits_rows, 8 * k)
        planner = codec.plan_for(M)[0]
        check(plan is not None, f"K1 holds {name}")
        plan_s = time.monotonic() - t0
        threads, prog = plan[0], plan[1].to(device)
        w = rand_words(rng, (k, TW), device)
        out = fused_encode_words(prog, w, r, threads)
        err = max_abs_err(out, fused_encode_words_plain(prog, w, r, 512))
        host = host_matvec(gf, M, w.cpu().numpy().view(np.uint8))
        torch.cuda.synchronize()
        check(err == 0, f"fused {name} vs plain")
        check(np.array_equal(out.cpu().numpy().view(np.uint8), host),
              f"fused {name} vs host_matvec")
        fused[name] = {"planner": planner, "threads": threads,
                       **xornet_plan(threads, prog, TW // 8),
                       "plan_seconds": round(plan_s, 3)}
        results["fused_encode"]["max_abs_err"] = max(
            results["fused_encode"]["max_abs_err"], err)
    report["fused"] = fused
    return report


def rs_200_56_parity():
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.matrix import generator_matrix

    gf = GF256()
    return gf, generator_matrix(gf, 200, 256, "cauchy")[200:]


def host_product_bytes(cx, M, w: torch.Tensor, cols: int) -> np.ndarray:
    """The NumPy field arithmetic's product of ``M`` and the byte rows of
    the words ``w`` over their first ``cols`` words, as byte rows; on a
    GF(2^16) codec ``w`` is byte-sliced (shard j's lo bytes at row 2j, its
    hi bytes at 2j+1) and so is the result."""
    from noise_ec_tpu_torch.matrix import host_matvec

    u8 = w[:, :cols].cpu().numpy().view(np.uint8)
    if cx.sym_bytes == 1:
        return host_matvec(cx.gf, M, u8)
    sym = u8[0::2].astype(np.uint16) | (u8[1::2].astype(np.uint16) << 8)
    want = host_matvec(cx.gf, M, sym)
    out = np.empty((2 * M.shape[0], u8.shape[1]), dtype=np.uint8)
    out[0::2] = want & 0xFF
    out[1::2] = want >> 8
    return out


def panel_cases(codec, codec16) -> dict:
    """Every matrix the panel route runs K7 on, with the int32 words a
    shard the main path gives it: RS(200,56)'s parity and (56,200)
    recovery matrix and RS(100,30)'s parity at 1 MiB shards, RS(229,6)'s
    parity at 64 KiB, and GF(2^16) RS(60,20)'s parity on the byte-sliced
    route (120 byte rows) and on the interleaved words entry (16 planes a
    shard). Values: (codec, matrix, words a shard, GF(2^16) interleaved)."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix

    M60 = generator_matrix(GF65536(), 60, 80, "cauchy")[60:]
    cases = {name: (codec, M, tw, False)
             for name, (M, tw) in panel_matrices(codec).items()}
    gf = codec.gf
    cases["RS(100,30) parity"] = (
        codec, generator_matrix(gf, 100, 130, "cauchy")[100:], TW, False)
    cases["GF(2^16) RS(60,20) parity, byte-sliced"] = (codec16, M60, TWB,
                                                       False)
    cases["GF(2^16) RS(60,20) parity, interleaved"] = (codec16, M60, TW, True)
    for name, (cx, M, _, _) in cases.items():
        check(cx.route_for(M) == "panel", f"{name} routes panel")
    return cases


def phase_panel_kernels(rng, device, results: dict, codec, codec16) -> dict:
    """K6 and K7 against their plain versions on the card, byte for byte.
    K6 at RS(200,56), 1 MiB shards (200 and 56 rows). K7 on every matrix
    of :func:`panel_cases` at its plan, each product also unpacked and held
    against the NumPy field arithmetic on a 64 KiB slice; at RS(200,56)
    also in the reference's three sub-launches (the accumulating launch),
    in a forced split of the K tiles over four blocks, as an accumulating
    launch with a K split, and on a ragged plane width. ``codec`` and
    ``codec16`` are the shared codecs, which keep the plans."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import host_matvec
    from noise_ec_tpu_torch.ops.pack import (
        blocked_lane_tl,
        pack_words_lanes_blocked,
        pack_words_lanes_blocked_plain,
        unpack_words_lanes_blocked,
        unpack_words_lanes_blocked_plain,
    )
    from noise_ec_tpu_torch.ops.panel import (
        gf2_matmul_panel,
        gf2_matmul_panel_chain,
        gf2_matmul_panel_plain,
        sublaunch_count,
    )

    _, M = rs_200_56_parity()
    words = rand_words(rng, (200, TW), device)
    planes = pack_words_lanes_blocked(words)
    err_p = max_abs_err(planes, pack_words_lanes_blocked_plain(words))
    back = unpack_words_lanes_blocked(planes)
    err_u = max_abs_err(back, unpack_words_lanes_blocked_plain(planes))
    torch.cuda.synchronize()
    check(err_p == 0 and err_u == 0, "blocked pack/unpack (200 rows) vs plain")
    check(torch.equal(back, words), "blocked pack/unpack round trip")
    del back

    report = {"phase": "panel_kernels", "blocked_tl": blocked_lane_tl(TW)}
    err_k7 = err_acc = err_u56 = 0
    host_cols = HOST_SLICE // 4
    for name, (cx, Mx, tw, inter) in panel_cases(codec, codec16).items():
        r, k = Mx.shape
        t0 = time.monotonic()
        kind, threads, tiles, G = cx.plan_for(Mx)
        plan_s = time.monotonic() - t0
        check(kind == "panel" and G == 1, f"{name} plans K7 in one launch")
        rows = cx.sym_bytes * k  # byte rows in; shards for the interleaved
        w = words if name == "RS(200,56) parity" else rand_words(
            rng, (k if inter else rows, tw), device)
        if inter:
            x = pack_words_lanes_blocked(w, 16).reshape(16 * k, 8, tw // 128)
        else:
            x = pack_words_lanes_blocked(w).reshape(8 * rows, 8, tw // 64)
        out = gf2_matmul_panel(tiles, x, threads)
        err = max_abs_err(out, gf2_matmul_panel_plain(tiles, x))
        check(err == 0, f"K7 {name} vs plain")
        err_k7 = max(err_k7, err)
        if inter:
            got = unpack_words_lanes_blocked(out.reshape(r, 16, 8, tw // 128))
            host = host_matvec(GF65536(), Mx,
                               w[:, :host_cols].cpu().numpy().view("<u2"))
            ok = np.array_equal(got[:, :host_cols].cpu().numpy().view("<u2"),
                                host)
        else:
            got = unpack_words_lanes_blocked(
                out.reshape(cx.sym_bytes * r, 8, 8, tw // 64))
            e = max_abs_err(got, unpack_words_lanes_blocked_plain(
                out.reshape(cx.sym_bytes * r, 8, 8, tw // 64)))
            err_u56 = max(err_u56, e)
            cols = min(host_cols, tw)
            ok = np.array_equal(got[:, :cols].cpu().numpy().view(np.uint8),
                                host_product_bytes(cx, Mx, w, cols))
        check(ok, f"K7 {name} vs host_matvec (64 KiB slice)")
        report[name] = {"shard_bytes": 4 * tw, "planes": list(x.shape),
                        "rows": tiles.n_rows, "KT": tiles.KT,
                        "row_group": tiles.RGR, "WC": tiles.WC,
                        "threads": threads,
                        "ring_bytes": tiles.ring_bytes,
                        "plan_seconds": plan_s, "equal": True}
        if name != "RS(200,56) parity":
            continue
        # The reference's sub-launches, a forced K split, an accumulating
        # launch split over K, a ragged width.
        G3 = sublaunch_count(codec._xor_cost_for(Mx), tiles.NT)
        three = gf2_matmul_panel_chain(tiles, x, threads, G3)
        split4 = gf2_matmul_panel(tiles, x, threads, ksplit=4)
        acc = rand_words(rng, tuple(out.shape), device)
        acc_plain = acc.clone()
        lo, hi = 5, tiles.NT - 7
        gf2_matmul_panel(tiles, x, threads, acc=acc, k_slice=(lo, hi),
                         ksplit=3)
        gf2_matmul_panel_plain(tiles, x, acc=acc_plain, k_slice=(lo, hi))
        ragged = x[:, :, :98].contiguous()
        err_r = max_abs_err(gf2_matmul_panel(tiles, ragged, threads),
                            gf2_matmul_panel_plain(tiles, ragged))
        e3 = max_abs_err(three, out)
        e4 = max_abs_err(split4, out)
        ea = max_abs_err(acc, acc_plain)
        torch.cuda.synchronize()
        check(e3 == 0, f"K7 in G={G3} sub-launches vs one")
        check(e4 == 0, "K7 with the K tiles split over four blocks")
        check(ea == 0, "K7 accumulating launch (split over three) vs plain")
        check(err_r == 0, "K7 on a ragged width (98 words an 8-word row)")
        err_acc = max(e3, ea)
        err_k7 = max(err_k7, e4, err_r)
        report[name].update(forced_sublaunches=G3, forced_ksplit=4,
                            acc_k_slice=[lo, hi], ragged_w8=98)
    results["gf2mm_panel"]["max_abs_err"] = err_k7
    results["gf2mm_panel_acc"]["max_abs_err"] = err_acc
    results["pack_lanes_blocked"]["max_abs_err"] = err_p
    results["unpack_lanes_blocked"]["max_abs_err"] = max(err_u, err_u56)
    return report


def rs16_200_56_parity():
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix

    gf = GF65536()
    return gf, generator_matrix(gf, 200, 256, "cauchy")[200:]


def bytes_as_u16(words: torch.Tensor, ncols: int) -> np.ndarray:
    """The first ``ncols`` byte columns of byte-sliced words (2k, TW) as the
    (k, ncols) u16 symbols they hold."""
    from noise_ec_tpu_torch.ops.pack import unpack_u16_bytesliced

    return unpack_u16_bytesliced(
        words[:, :ncols // 4].cpu().numpy().view(np.uint8))


def k8_matrices(rng) -> dict:
    """The four matrices the main path runs K8 on, name -> (field, M):
    GF(2^16) RS(200,56)'s parity, its (56, 200) and (28, 200) recovery
    matrices at the main path's 28 + 28 erasures (``reconstruct`` and
    ``reconstruct_data``), and a dense (200, 200) GF(2^8) matrix."""
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )

    gf16, P = rs16_200_56_parity()
    G = generator_matrix(gf16, 200, 256, "cauchy")
    present = [i for i in range(256) if i not in set(WIDE_LOST)][:200]
    lost_data = [i for i in WIDE_LOST if i < 200]
    return {
        "rs16_200_56_parity": ("gf65536", P),
        "rs16_56_200_recovery": ("gf65536", reconstruction_matrix(
            gf16, G, present, list(WIDE_LOST))),
        "rs16_28_200_recovery": ("gf65536", reconstruction_matrix(
            gf16, G, present, lost_data)),
        "dense_200_200_gf256": ("gf256", rng.integers(
            1, 256, size=(200, 200), dtype=np.uint8)),
    }


def k8_words(rng, tiles, field: str, device, batch: int = 0) -> torch.Tensor:
    """Random words for K8 on ``tiles`` at 1 MiB shards: (K, TW) byte rows
    (a GF(2^16) shard's byte-sliced rows hold half of it), or (batch, K,
    TW)."""
    tw = TWB if field == "gf65536" else TW
    return rand_words(rng, ((batch,) if batch else ()) + (tiles.k, tw),
                      device)


def groups_launch_of(x: torch.Tensor, group: int) -> dict:
    """The launch K9/K10's wrapper takes for ``x`` (words to pack, or
    planes to unpack, into a fresh aligned output): V, threads, grid."""
    from noise_ec_tpu_torch.ops.pack import (
        groups_launch,
        groups_vec,
        tile_lanes,
    )

    rows, TW = x.shape[0], x.numel() // x.shape[0]
    V = groups_vec(tile_lanes(TW, group), group, x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    threads, bx, by = groups_launch(rows, TW, group, V, sms)
    return {"V": V, "threads": threads, "grid": [bx, by]}


def check_groups(rng, device, group: int, results: dict, names) -> dict:
    """K9 (group 8) or K10 (group 16) pack and unpack against their plain
    versions and the round trip, at the TLs the new forms cover: 130 (V =
    2) and 129 (V = 1), 384, 512; words and planes 4 bytes off a 16-byte
    boundary (V = 1); and rows or a row long enough that the row-stride
    and grid-stride loops run. Each case names the launch it ran."""
    from noise_ec_tpu_torch.ops.pack import (
        _pack_groups_plain,
        _unpack_groups_plain,
        pack_words16,
        pack_words_sublane,
        tile_lanes,
        unpack_words16,
        unpack_words_sublane,
    )

    kname = "K9" if group == 8 else "K10"
    pack, unpack = ((pack_words_sublane, unpack_words_sublane) if group == 8
                    else (pack_words16, unpack_words16))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # Past one wave of 256-thread blocks: rows on y, or lanes on x.
    many_rows = sms * 8 + 1
    long_row = group * 4 * 256 * sms * 8 * 2
    cases = {"TL 130": (10, 130 * group, 0), "TL 129": (10, 129 * group, 0),
             "TL 384": (10, 384 * group, 0), "TL 512": (10, 1024 * group, 0),
             "4 bytes off": (10, 1024 * group, 1),
             "row-stride loop": (many_rows, 128 * group, 0),
             "grid-stride loop": (1, long_row, 0)}
    report = {}
    for case, (rows, tw, off) in cases.items():
        flat = rand_words(rng, rows * tw + off, device)
        words = flat[off:].reshape(rows, tw)
        planes = pack(words)
        err_p = max_abs_err(planes, _pack_groups_plain(words, group))
        pflat = torch.empty(planes.numel() + off, dtype=torch.int32,
                            device=device)
        src = pflat[off:].view(planes.shape)
        src.copy_(planes)
        back = unpack(src)
        err_u = max_abs_err(back, _unpack_groups_plain(src))
        torch.cuda.synchronize()
        check(err_p == 0 and err_u == 0, f"{kname} {case} vs plain")
        check(torch.equal(back, words), f"{kname} {case} round trip")
        report[case] = {"rows": rows, "TW": tw, "TL": tile_lanes(tw, group),
                        "offset_bytes": 4 * off,
                        "pack": groups_launch_of(words, group),
                        "unpack": groups_launch_of(src, group),
                        "equal": True}
        for name, err in zip(names, (err_p, err_u)):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
    # One pass of the grid covers less than the long row.
    gs = report["grid-stride loop"]["pack"]
    check(report["4 bytes off"]["pack"]["V"] == 1
          and report["4 bytes off"]["unpack"]["V"] == 1
          and report["TL 130"]["pack"]["V"] == 2
          and report["TL 129"]["pack"]["V"] == 1
          and report["row-stride loop"]["pack"]["grid"][1] < many_rows
          and gs["grid"][0] * gs["threads"] * gs["V"] * group < long_row,
          f"the {kname} cases reach every V and both loops: {report}")
    return report


def phase_gf16_kernels(rng, device, results: dict) -> dict:
    """K8 against its plain version at full width on the four matrices of
    :func:`k8_matrices` (and against the NumPy field arithmetic on a 64 KiB
    slice), on RS(200,56)'s parity in a batch of two, and on an odd K
    (random (3, 5) bits) at a ragged width in a batch of two; K10 at
    RS(10,4)'s GF(2^16) shapes."""
    from noise_ec_tpu_torch.gf import GF256, GF65536
    from noise_ec_tpu_torch.matrix import host_matvec
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.mxu import (
        build_mxu_tiles,
        mxu_encode_tiles,
        mxu_encode_words_bits,
        mxu_encode_words_bits_plain,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words16,
        pack_words16_plain,
        unpack_words16,
        unpack_words16_plain,
    )

    report = {"phase": "gf16_kernels"}
    codecs = {"gf65536": DeviceCodec(field="gf65536", device=device),
              "gf256": DeviceCodec(device=device)}
    gfs = {"gf65536": GF65536(), "gf256": GF256()}
    errs = []
    for name, (field, M) in k8_matrices(rng).items():
        codec = codecs[field]
        check(codec.route_for(M) == "mxu", f"{name} routes mxu")
        t0 = time.monotonic()
        kind, _, tiles, _ = codec.plan_for(M)
        torch.cuda.synchronize()
        plan_s = time.monotonic() - t0
        words = k8_words(rng, tiles, field, device)
        out = mxu_encode_tiles(tiles, words)
        m2 = tiles.matrix()
        errs.append(max_abs_err(out, mxu_encode_words_bits_plain(
            m2, words, tiles.r, tiles.k)))
        torch.cuda.synchronize()
        check(errs[-1] == 0, f"K8 {name} vs plain")
        if field == "gf65536":
            host = host_matvec(gfs[field], M,
                               bytes_as_u16(words, HOST_SLICE // 2))
            got = bytes_as_u16(out, HOST_SLICE // 2)
        else:
            host = host_matvec(gfs[field], M, words[:, :HOST_SLICE // 4]
                               .cpu().numpy().view(np.uint8))
            got = out[:, :HOST_SLICE // 4].cpu().numpy().view(np.uint8)
        check(np.array_equal(got, host),
              f"K8 {name} vs host_matvec on a 64 KiB slice")
        report[name] = {"kind": kind, "operand": list(m2.shape),
                        "N": tiles.N, "row_tiles": tiles.T,
                        "plan_seconds": plan_s, "equal": True}
        if name == "rs16_200_56_parity":
            pair = k8_words(rng, tiles, field, device, batch=2)
            errs.append(max_abs_err(mxu_encode_tiles(tiles, pair),
                                    mxu_encode_words_bits_plain(
                                        m2, pair, tiles.r, tiles.k)))
            check(errs[-1] == 0, "K8 RS(200,56) batch of two vs plain")
            report[name]["batch_of_two"] = True
    # Odd K (8K = 40 bits, not a multiple of 16 bytes) at N = 32 on four
    # warpgroups of 64 words: TW = 8,224 words ends in half a block.
    small = torch.from_numpy(
        rng.integers(0, 2, size=(24, 40)).astype(np.int8)).to(device)
    ragged = rand_words(rng, (2, 5, 8224), device)
    got = mxu_encode_words_bits(small, ragged, 3, 5)
    errs.append(max_abs_err(got, mxu_encode_words_bits_plain(
        small, ragged, 3, 5)))
    torch.cuda.synchronize()
    check(errs[-1] == 0, "K8 odd K, ragged width, batch of two vs plain")
    report["odd_k_ragged"] = {"r": 3, "k": 5, "TW": 8224, "batch": 2,
                              "N": build_mxu_tiles(small, 3, 5).N,
                              "equal": True}
    results["mxu_gf2"]["max_abs_err"] = max(errs)

    words16 = rand_words(rng, (10, TW), device)
    planes = pack_words16(words16)
    err_p = max_abs_err(planes, pack_words16_plain(words16))
    back = unpack_words16(planes)
    err_u = max_abs_err(back, unpack_words16_plain(planes))
    parity_planes = planes[:4].contiguous()
    err_u4 = max_abs_err(unpack_words16(parity_planes),
                         unpack_words16_plain(parity_planes))
    torch.cuda.synchronize()
    check(err_p == 0 and err_u == 0 and err_u4 == 0,
          "K10 pack16/unpack16 vs plain")
    check(torch.equal(back, words16), "K10 round trip")
    results["pack_words16"]["max_abs_err"] = err_p
    results["unpack_words16"]["max_abs_err"] = max(err_u, err_u4)
    report["k10"] = {"rows": [10, 4], "planes": list(planes.shape),
                     "equal": True, "pack": groups_launch_of(words16, 16),
                     "unpack": groups_launch_of(parity_planes, 16),
                     "cases": check_groups(rng, device, 16, results, (
                         "pack_words16", "unpack_words16"))}
    return report


# RS(50,20) at the code's limit: 10 data and 10 parity shards lost.
SPLIT_LOST = tuple(range(0, 20, 2)) + tuple(range(50, 70, 2))
# RS(17,3)'s three lost shards: data at both ends and the middle parity.
LOST_17_3 = (0, 16, 18)
# Streams are timed end to end this many times each.
STREAM_REPS = 2
# BASELINE config 3's streams: RS(50,20) and RS(17,3) at 1 MiB shards (8
# and 16 chunks), and the object-stream shape (4 MiB chunks).
STREAM_50_20 = 400 * MIB
STREAM_17_3 = 272 * MIB
OBJECT_STREAM, OBJECT_CHUNK = 64 * MIB, 4 * MIB


def rs_50_20():
    """GF(2^8) RS(50,20)'s generator and its (20, 50) recovery matrix for
    SPLIT_LOST."""
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )

    gf = GF256()
    G = generator_matrix(gf, 50, 70, "cauchy")
    present = [i for i in range(70) if i not in SPLIT_LOST]
    return gf, G, reconstruction_matrix(gf, G, present[:50],
                                        list(SPLIT_LOST))


def split_cases(codec, codec16) -> dict:
    """Every matrix the baked route runs K5 on in main_path and the times:
    RS(50,20)'s parity and (20, 50) recovery matrix, RS(30,10)'s and
    RS(40,12)'s parity, GF(2^16) RS(30,10)'s parity over 60 byte rows, and
    RS(10,4)'s parity. Values: (codec, matrix, words a byte row)."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix

    gf, G, R = rs_50_20()
    cases = {"RS(50,20) parity": (codec, G[50:], TW),
             "RS(50,20) recovery (20,50)": (codec, R, TW)}
    for k, r in ((30, 10), (40, 12), (10, 4)):
        cases[f"RS({k},{r}) parity"] = (
            codec, generator_matrix(gf, k, k + r, "cauchy")[k:], TW)
    cases["GF(2^16) RS(30,10) parity"] = (
        codec16, generator_matrix(GF65536(), 30, 40, "cauchy")[30:], TWB)
    for name, (cx, M, _) in cases.items():
        check(cx.route_for(M) == "baked", f"{name} routes baked")
    return cases


def phase_split_kernels(rng, device, results: dict, codec, codec16) -> dict:
    """K5 against its plain version on the card, byte for byte, on every
    matrix of :func:`split_cases` at 1 MiB shards, at its plan and with
    its phases split over three blocks a column tile, each also against
    the NumPy field arithmetic on a 64 KiB slice; RS(10,4) also against
    K1 forced; and RS(50,20)'s parity on a batch of three at the smallest
    word quantum and through the words entry on ragged words (TW off the
    quantum). ``codec`` and ``codec16`` are the shared codecs."""
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_split_encode_words,
        fused_split_encode_words_plain,
    )

    report = {"phase": "split_kernels"}
    err = 0
    cols = HOST_SLICE // 4
    for name, (cx, M, tw) in split_cases(codec, codec16).items():
        r, k = (cx.sym_bytes * n for n in M.shape)
        t0 = time.monotonic()
        kind, threads, tiles, _ = cx.plan_for(M)
        plan_s = time.monotonic() - t0
        check(kind == "split", f"{name} plans onto K5")
        w = rand_words(rng, (k, tw), device)
        out = fused_split_encode_words(tiles, w, r, threads)
        plain = fused_split_encode_words_plain(tiles, w, r, 128)
        split3 = fused_split_encode_words(tiles, w, r, threads, ksplit=3)
        e = max(max_abs_err(out, plain), max_abs_err(split3, plain))
        host = host_product_bytes(cx, M, w, cols)
        torch.cuda.synchronize()
        check(e == 0, f"K5 {name} vs plain, one block and three a column")
        check(np.array_equal(out[:, :cols].cpu().numpy().view(np.uint8),
                             host), f"K5 {name} vs host_matvec (64 KiB)")
        if name == "RS(10,4) parity":
            _, t1, p1, _ = cx.plan_for(M, "fused")
            check(torch.equal(out, fused_encode_words(p1, w, r, t1)),
                  f"K5 {name} vs K1")
        report[name] = {"threads": threads, "ksl": tiles.KT // 8,
                        "phases": tiles.NT, "row_groups": tiles.NRG,
                        "WC": tiles.WC,
                        "ring_bytes": tiles.ring_bytes,
                        "plan_seconds": plan_s, "equal": True}
        err = max(err, e)
    # A batch of three at the 32 KiB quantum, and ragged words through the
    # codec (padded to the quantum and sliced back).
    M = split_cases(codec, codec16)["RS(50,20) parity"][1]
    _, threads, tiles, _ = codec.plan_for(M)
    w3 = rand_words(rng, (3, 50, 8192), device)
    out3 = fused_split_encode_words(tiles, w3, 20, threads)
    e3 = max_abs_err(out3, fused_split_encode_words_plain(tiles, w3, 20, 128))
    ragged = rand_words(rng, (3, 50, TW - 5), device)
    got = codec.matmul_words_batch(M, ragged)
    torch.cuda.synchronize()
    check(e3 == 0, "K5 on a batch of three (TW = 8,192) vs plain")
    # The same call again: its key's second call, device_op's execute route.
    check(torch.equal(codec.matmul_words_batch(M, ragged), got),
          "K5 on ragged words, called again")
    for b in range(3):
        for lo in (0, TW - 5 - cols):
            check(np.array_equal(
                got[b, :, lo:lo + cols].cpu().numpy().view(np.uint8),
                host_product_bytes(codec, M, ragged[b, :, lo:], cols)),
                f"K5 on ragged words (TW = {TW - 5}), batch {b}, at {lo}")
    results["fused_split"]["max_abs_err"] = max(err, e3)
    report["batch_ragged"] = {"batch": 3, "tw": [8192, TW - 5],
                              "equal": True}
    report["row_maps"] = split_row_maps(rng, device, codec, codec16)
    return report


# The rebuild cells' patterns for K5's row maps: (field, k, r, lost, the
# survivors' order), the survivors out of codeword order so the input map
# skips rows and runs backwards; GF(2^16) at m = 16 over symbol rows.
ROW_MAP_CASES = (("gf256", 6, 3, (4,), (8, 0, 5, 2, 7, 1, 3, 6)),
                 ("gf256", 6, 3, (0, 7), (8, 6, 5, 4, 3, 2, 1)),
                 ("gf256", 10, 4, (3,), (13, 0, 12, 1, 11, 2, 10, 4, 9, 5,
                                         8, 6, 7)),
                 ("gf256", 10, 4, (2, 12), (13, 11, 10, 9, 8, 7, 6, 5, 4,
                                            3, 1, 0)),
                 ("gf65536", 6, 3, (1, 7), (8, 6, 5, 4, 3, 2, 0)))
# Stripes a rebuild: the benchmark's block group of 128 x 1 MiB cells.
ROW_MAP_BATCH = 128


def mapped_split(tiles, threads, pat, m: int, words, out, ksplit,
                 what: str) -> None:
    """One K5 launch through the row maps of the rebuild pattern ``pat``
    (``BatchCodec._pattern``), into ``out``; checks it is one launch."""
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
    from noise_ec_tpu_torch.ops.fused import fused_split_encode_words

    counter = "fused_split" if m == 8 else "fused_split16"
    reset_launch_counts()
    got = fused_split_encode_words(tiles, words, len(pat.lost), threads,
                                   ksplit=ksplit, m=m, in_rows=pat.sel,
                                   out=out, out_rows=pat.lost)
    torch.cuda.synchronize()
    launched = {x: v for x, v in launch_counts().items() if v}
    check(got is out and launched == {counter: 1},
          f"{what}: one {counter} launch a mapped call, got {launched}")


def split_row_maps(rng, device, codec, codec16) -> dict:
    """K5 through its row maps (``fused_split_encode_words(..., in_rows=,
    out=, out_rows=)``) at the rebuild cells' geometry on 1 MiB cells: on
    each pattern of :data:`ROW_MAP_CASES`, the survivors a (B, P, TW)
    batch (batch stride P TW), the product stored into a sentinel-filled
    (B, n, TW) codeword at the lost rows, against the plain version under
    the same maps at B = 4 (K split 1 and the planner's) and B = 1 (the
    streaming decoder's; the planner's split), the whole codeword compared
    so no other row may change; at B = 128 against the contiguous call on
    the gathered rows; one launch a call. Then ``BatchCodec.
    reconstruct_batch_words`` on the same pattern at B = 16 against the
    encoded codeword, counted on the in-place path. Inputs are made on
    the card."""
    from noise_ec_tpu_torch.obs.registry import default_registry
    from noise_ec_tpu_torch.ops.fused import (
        fused_split_encode_words,
        fused_split_encode_words_plain,
    )
    from noise_ec_tpu_torch.parallel import BatchCodec

    sentinel = 0x5EC71E55
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    in_place = default_registry().counter(
        "noise_ec_batch_assembly_total").labels(
        entry="reconstruct_batch_words", path="in_place")
    report = {}
    for field, k, r, lost, present in ROW_MAP_CASES:
        cx = codec if field == "gf256" else codec16
        m = 8 * cx.sym_bytes
        name = f"{field} {k}+{r} lost {list(lost)} m={m}"
        n, P, e = k + r, len(present), len(lost)
        bc = BatchCodec(k, r, field=field, device=device)
        pat = bc._pattern(list(present), device)
        kind, threads, tiles, _ = cx.plan_for(pat.R)
        check(kind == "split", f"{name}: the rebuild plans onto K5")
        for B, ksplit in ((4, 1), (4, None), (1, None)):
            words = device_words(gen, (B, P, TW), device)
            out = torch.full((B, n, TW), sentinel, dtype=torch.int32,
                             device=device)
            mapped_split(tiles, threads, pat, m, words, out, ksplit, name)
            want = torch.full_like(out, sentinel)
            fused_split_encode_words_plain(tiles, words, e, 128, m,
                                           in_rows=pat.sel, out=want,
                                           out_rows=pat.lost)
            torch.cuda.synchronize()
            check(torch.equal(out, want),
                  f"{name}: K5 through row maps vs plain, B = {B}, "
                  f"K split {ksplit or 'of the planner'}")
        words = device_words(gen, (ROW_MAP_BATCH, P, TW), device)
        out = torch.full((ROW_MAP_BATCH, n, TW), sentinel,
                         dtype=torch.int32, device=device)
        mapped_split(tiles, threads, pat, m, words, out, None, name)
        want = torch.full_like(out, sentinel)
        want[:, pat.lost.long()] = fused_split_encode_words(
            tiles, words.index_select(1, pat.sel), e, threads, m=m)
        torch.cuda.synchronize()
        check(torch.equal(out, want),
              f"{name}: K5 through row maps vs the gathered call, "
              f"B = {ROW_MAP_BATCH}")
        del words, out, want
        full = bc.encode_batch_words(device_words(gen, (16, k, TW), device))
        before = in_place.value
        got = bc.reconstruct_batch_words(
            full[:, list(present)].contiguous(), list(present))
        torch.cuda.synchronize()
        check(torch.equal(got, full),
              f"{name}: reconstruct_batch_words at B = 16")
        check(in_place.value == before + 1,
              f"{name}: the rebuild took the in-place path")
        report[name] = {"sel": pat.sel.tolist(), "lost": pat.lost.tolist(),
                        "phases": tiles.NT,
                        "batches": [4, 4, 1, ROW_MAP_BATCH, 16],
                        "equal": True}
        del full, got
    return report

# The GF(2^16) streams at 1 MiB shards: RS(30,10) on 240 MiB (8 chunks),
# decoded at ten data erasures, and RS(50,20) on 400 MiB, decoded at
# SPLIT_LOST.
STREAM16_30_10 = 240 * MIB
LOST16_30_10 = tuple(range(0, 30, 3))
# Plane words of one bit-plane of a 1 MiB GF(2^16) shard at 16 planes a
# symbol (the interleaved words entry): one 16-word group a plane word.
GROUPS16 = TW // 16


def words16_cases(codec16) -> dict:
    """Every matrix the interleaved GF(2^16) words entry runs K5 at m = 16
    on in main_path: RS(10,4)'s, RS(17,3)'s and RS(30,10)'s parity, and
    RS(30,10)'s (10, 30) recovery matrix at LOST16_30_10."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )

    gf = GF65536()
    cases = {f"RS({k},{r}) parity": generator_matrix(gf, k, k + r,
                                                     "cauchy")[k:]
             for k, r in ((10, 4), (17, 3), (30, 10))}
    G = generator_matrix(gf, 30, 40, "cauchy")
    present = [i for i in range(40) if i not in LOST16_30_10]
    cases["RS(30,10) recovery (10,30)"] = reconstruction_matrix(
        gf, G, present[:30], list(LOST16_30_10))
    for name, M in cases.items():
        check(codec16.route_for(M) == "baked", f"GF(2^16) {name} baked")
    return cases


def tier3_matrix() -> np.ndarray:
    """GF(2^16) RS(49,2)'s parity: baked, but past the 48 rows of the
    reference's lane tile at m = 16, so its forced pipeline is the
    reference's tier 3 (K10 -> K4 -> K10)."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix

    return generator_matrix(GF65536(), 49, 51, "cauchy")[49:]


def host_words16(M, w: torch.Tensor, cols: int) -> np.ndarray:
    """The NumPy field arithmetic's GF(2^16) product of the first ``cols``
    interleaved words of each row of ``w`` (u16 symbols)."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import host_matvec

    return host_matvec(GF65536(), M, w[:, :cols].cpu().numpy().view("<u2"))


def phase_words16_kernels(rng, device, results: dict, codec16) -> dict:
    """The m = 16 forms against their plain versions on the card, byte for
    byte, at 1 MiB shards: K5@16 on every matrix of :func:`words16_cases`
    at its plan and with its phases split over three blocks, each also
    against the NumPy field arithmetic on a 64 KiB slice, and K1@16 forced
    on RS(10,4) and RS(17,3) (the codes whose network K1 holds), also
    against K5@16; the lane pack and unpack at m = 16 at TL = 128 and at
    the port's TL (512) on each matrix's words, and at the blocked TL on
    RS(50,20)'s panel shapes (50 rows in, 20 out); a batch of three
    through K5@16 and K1@16; ragged words (TW off the 16,384-word quantum)
    through the interleaved entry; and the forced tier 3 of main_path at
    RS(49,2) (:func:`tier3_matrix`), K10 pack, K4 and K10 unpack each at
    that path's shapes; and K4 alone on GF(2^16) RS(30,10)'s 160 x 480
    pipeline program, against its plain version and the host."""
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_encode_words_plain,
        fused_split_encode_words,
        fused_split_encode_words_plain,
    )
    from noise_ec_tpu_torch.ops.gf2mm import (
        gf2_matmul_sparse,
        gf2_matmul_sparse_plain,
    )
    from noise_ec_tpu_torch.ops.pack import (
        blocked_lane_tl,
        lane_tl,
        pack_words16,
        pack_words16_plain,
        pack_words_lanes,
        pack_words_lanes_blocked,
        pack_words_lanes_blocked_plain,
        pack_words_lanes_plain,
        unpack_words16,
        unpack_words16_plain,
        unpack_words_lanes,
        unpack_words_lanes_blocked,
        unpack_words_lanes_blocked_plain,
        unpack_words_lanes_plain,
    )

    report = {"phase": "words16_kernels"}
    err = {name: 0 for name in ("fused_split16", "fused_encode16",
                                "pack_lanes16", "unpack_lanes16",
                                "pack_lanes_blocked16",
                                "unpack_lanes_blocked16")}
    cols = HOST_SLICE // 4
    cases = words16_cases(codec16)
    for name, M in cases.items():
        r, k = M.shape
        kind, threads, tiles, _ = codec16.plan_for(M)
        check(kind == "split", f"GF(2^16) {name} plans onto K5")
        w = rand_words(rng, (k, TW), device)
        out = fused_split_encode_words(tiles, w, r, threads, m=16)
        plain = fused_split_encode_words_plain(tiles, w, r, 128, 16)
        ksplit = min(3, tiles.NT)
        split3 = fused_split_encode_words(tiles, w, r, threads, ksplit=ksplit,
                                          m=16)
        e5 = max(max_abs_err(out, plain), max_abs_err(split3, plain))
        torch.cuda.synchronize()
        check(e5 == 0, f"K5@16 {name} vs plain, one block and {ksplit} a "
              "column")
        check(np.array_equal(out[:, :cols].cpu().numpy().view("<u2"),
                             host_words16(M, w, cols)),
              f"K5@16 {name} vs host_matvec (64 KiB)")
        err["fused_split16"] = max(err["fused_split16"], e5)
        entry = {"threads": threads, "ksl": tiles.KT // 16,
                 "phases": tiles.NT, "row_groups": tiles.NRG, "WC": tiles.WC,
                 "ring_bytes": tiles.ring_bytes, "ksplit": ksplit,
                 "equal": True}
        if k <= 17:
            _, t1, p1, _ = codec16.plan_for(M, "fused")
            o1 = fused_encode_words(p1, w, r, t1, m=16)
            e1 = max_abs_err(o1, fused_encode_words_plain(p1, w, r, 128, 16))
            torch.cuda.synchronize()
            check(e1 == 0, f"K1@16 {name} vs plain")
            check(torch.equal(o1, out), f"K1@16 {name} vs K5@16")
            err["fused_encode16"] = max(err["fused_encode16"], e1)
            entry["k1"] = xornet_plan(t1, p1, TW // 16)
        for tl in (128, lane_tl(TW, 16)):
            planes = pack_words_lanes(w, tl, 16)
            ep = max_abs_err(planes, pack_words_lanes_plain(w, tl, 16))
            back = unpack_words_lanes(planes, tl)
            eu = max_abs_err(back, unpack_words_lanes_plain(planes, tl))
            torch.cuda.synchronize()
            check(ep == 0 and eu == 0,
                  f"lane pack/unpack@16 TL={tl} {name} vs plain")
            check(torch.equal(back, w), f"lane pack@16 TL={tl} round trip")
            err["pack_lanes16"] = max(err["pack_lanes16"], ep)
            err["unpack_lanes16"] = max(err["unpack_lanes16"], eu)
        entry["lane_tl"] = [128, lane_tl(TW, 16)]
        report[name] = entry

    # K6@16 at RS(50,20)'s panel shapes.
    w50 = rand_words(rng, (50, TW), device)
    planes = pack_words_lanes_blocked(w50, 16)
    ep = max_abs_err(planes, pack_words_lanes_blocked_plain(w50, 16))
    parity_planes = planes[:20].contiguous()
    back = unpack_words_lanes_blocked(parity_planes)
    eu = max_abs_err(back, unpack_words_lanes_blocked_plain(parity_planes))
    torch.cuda.synchronize()
    check(ep == 0 and eu == 0, "blocked pack/unpack@16 (50, 20 rows)")
    check(torch.equal(unpack_words_lanes_blocked(planes), w50),
          "blocked pack@16 round trip")
    err["pack_lanes_blocked16"] = ep
    err["unpack_lanes_blocked16"] = eu
    report["RS(50,20) blocked"] = {"tl": blocked_lane_tl(TW, 16),
                                   "rows": [50, 20], "equal": True}

    # A batch of three through K5@16 and K1@16, and ragged words through
    # the codec (padded to the quantum and sliced back).
    M = cases["RS(10,4) parity"]
    _, threads, tiles, _ = codec16.plan_for(M)
    _, t1, p1, _ = codec16.plan_for(M, "fused")
    w3 = rand_words(rng, (3, 10, TW), device)
    out3 = fused_split_encode_words(tiles, w3, 4, threads, m=16)
    e3 = max(max_abs_err(out3, fused_split_encode_words_plain(
        tiles, w3, 4, 128, 16)), max_abs_err(
            fused_encode_words(p1, w3, 4, t1, m=16), out3))
    M30 = cases["RS(30,10) parity"]
    ragged = rand_words(rng, (3, 30, TW - 5), device)
    got = codec16.matmul_words_batch(M30, ragged)
    torch.cuda.synchronize()
    check(e3 == 0, "K5@16 and K1@16 on a batch of three vs plain")
    for b in range(3):
        for lo in (0, TW - 5 - cols):
            check(np.array_equal(
                got[b, :, lo:lo + cols].cpu().numpy().view("<u2"),
                host_words16(M30, ragged[b, :, lo:], cols)),
                f"K5@16 on ragged words (TW = {TW - 5}), batch {b}, at {lo}")
    err["fused_split16"] = max(err["fused_split16"], e3)
    err["fused_encode16"] = max(err["fused_encode16"], e3)
    report["batch_ragged"] = {"batch": 3, "tw": [TW, TW - 5], "equal": True}
    for name, e in err.items():
        results[name]["max_abs_err"] = e

    # The main path's forced tier 3 at GF(2^16) RS(49,2), kernel by kernel:
    # K10 packs 49 rows, K4 runs the pipeline program over 784 planes into
    # 32, K10 unpacks the 2 product rows.
    M49 = tier3_matrix()
    kind, tp, prog, _ = codec16.plan_for(M49, "pipeline")
    check(kind == "pipeline", "GF(2^16) RS(49,2) forced pipeline")
    w49 = rand_words(rng, (49, TW), device)
    planes = pack_words16(w49)
    ep = max_abs_err(planes, pack_words16_plain(w49))
    x = planes.reshape(784, 8, TW // 128)
    prod = gf2_matmul_sparse(prog, x, tp)
    em = max_abs_err(prod, gf2_matmul_sparse_plain(prog, x))
    prod = prod.reshape(2, 16, TW // 16)
    back = unpack_words16(prod)
    eu = max_abs_err(back, unpack_words16_plain(prod))
    torch.cuda.synchronize()
    check(ep == 0, "K10 pack16 on RS(49,2)'s 49 rows vs plain")
    check(em == 0, "K4 on RS(49,2)'s pipeline program vs plain")
    check(eu == 0, "K10 unpack16 on RS(49,2)'s 2 rows vs plain")
    check(np.array_equal(back[:, :cols].cpu().numpy().view("<u2"),
                         host_words16(M49, w49, cols)),
          "K10 -> K4 -> K10 on RS(49,2) vs host_matvec (64 KiB)")
    for name, e in (("pack_words16", ep), ("gf2mm_sparse", em),
                    ("unpack_words16", eu)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    report["RS(49,2) tier 3"] = {"planes": [784, 32], "equal": True,
                                 **xornet_plan(tp, prog, TW // 16)}

    # K4 alone on GF(2^16) RS(30,10)'s 160 x 480 pipeline program, on the
    # lane pack's planes at m = 16, against its plain version and, unpacked,
    # the NumPy field arithmetic.
    M30 = cases["RS(30,10) parity"]
    kind, tp, prog, _ = codec16.plan_for(M30, "pipeline")
    w30 = rand_words(rng, (30, TW), device)
    tl = lane_tl(TW, 16)
    x = pack_words_lanes(w30, tl, 16).reshape(480, 8, TW // 128)
    prod = gf2_matmul_sparse(prog, x, tp)
    em = max_abs_err(prod, gf2_matmul_sparse_plain(prog, x))
    back = unpack_words_lanes(prod.reshape(10, 16, 8, TW // 128), tl)
    torch.cuda.synchronize()
    check(em == 0, "K4 on GF(2^16) RS(30,10)'s pipeline program vs plain")
    check(np.array_equal(back[:, :cols].cpu().numpy().view("<u2"),
                         host_words16(M30, w30, cols)),
          "K4 on GF(2^16) RS(30,10) vs host_matvec (64 KiB)")
    results["gf2mm_sparse"]["max_abs_err"] = max(
        results["gf2mm_sparse"]["max_abs_err"], em)
    report["RS(30,10) K4"] = {"planes": [480, 160], "equal": True,
                              **xornet_plan(tp, prog, TW // 16)}
    return report


# The dense-mask kernels' plane width at 1 MiB shards: the sublane layout's
# TW / 8 words a plane (RS(10,4): 80 planes in, 32 out).
W_PLANE = TW // 8
# Scattered corruption for the FEC decodes: this many byte columns wrong in
# one share each, and this many more in two shares each (within the
# radius of 14 shares, two).
FEC_SCATTER, FEC_SCATTER2 = 2048, 8
# Warm decodes timed per FEC case and route.
FEC_REPS = 5


def dense_masks(gf, k: int, r: int):
    """RS(k,r)'s parity rows and their (8r, 8k) int32 select masks."""
    from noise_ec_tpu_torch.gf import expand_generator_masks
    from noise_ec_tpu_torch.matrix import generator_matrix

    M = generator_matrix(gf, k, k + r, "cauchy")[k:]
    return M, expand_generator_masks(gf, M)


def dense_bound(R: int, C: int, W: int) -> tuple[float, str]:
    """K11/K12's bound: the masks, the C input and R output planes of W
    words moved once; one logic op per mask word and plane word
    (``acc ^= m & p`` is a single LOP3)."""
    return bound((R * C + C * W + R * W) * 4, R * C * W)


def dense_plan(masks: torch.Tensor, planes: torch.Tensor) -> dict:
    """K11's launch for these operands: the planner's (KT, WR, WC, WK,
    ksplit) and the words a plane copy moves."""
    from noise_ec_tpu_torch.ops.gf2mm import dense_copy_words
    from noise_ec_tpu_torch.ops.gf2tile import dense_shape

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    KT, WR, WC, WK, ksplit = dense_shape(*masks.shape, planes.shape[1], sms)
    return {"KT": KT, "WR": WR, "WC": WC, "WK": WK, "ksplit": ksplit,
            "copy_words": dense_copy_words(planes)}


def phase_dense_kernels(rng, device, results: dict) -> dict:
    """K9, K11 and K12 against their plain versions on the card, byte for
    byte: K9 pack and unpack at RS(10,4)'s 1 MiB shards (10 rows, TW =
    262,144) and at TW = 3,072 (TL = 384), with their round trips; K11 and
    K12 on RS(10,4)'s (32, 80) select masks, on random words of that
    shape and on RS(50,20)'s (160, 400) masks over 32,768-word planes, and
    on random (32, 80) words at W = 32,767 and 1,001 (4-byte plane
    copies), on planes starting 4 bytes off a 16-byte boundary, with masks
    sliced from a wider matrix, at R = 20 and at W = 2,048 (the planner's
    K split), each with K12 (on the zero-padded tiled view where 8 does not
    divide W) equal to K11; K12 also against the sparse K4 on RS(10,4).
    Each case names K11's launch (:func:`dense_plan`)."""
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.ops.gf2mm import (
        bits_to_rows,
        gf2_matmul_dense,
        gf2_matmul_dense_plain,
        gf2_matmul_dense_tiled,
        gf2_matmul_dense_tiled_plain,
        gf2_matmul_sparse,
        planes_to_tiled,
        sparse_plan,
        tiled_to_planes,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_sublane,
        pack_words_sublane_plain,
        tile_lanes,
        unpack_words_sublane,
        unpack_words_sublane_plain,
    )

    report = {"phase": "dense_kernels"}
    for tw in (TW, 3072):
        words = rand_words(rng, (10, tw), device)
        planes = pack_words_sublane(words)
        err_p = max_abs_err(planes, pack_words_sublane_plain(words))
        back = unpack_words_sublane(planes)
        err_u = max_abs_err(back, unpack_words_sublane_plain(planes))
        torch.cuda.synchronize()
        check(err_p == 0 and err_u == 0, f"K9 pack/unpack TW={tw} vs plain")
        check(torch.equal(back, words), f"K9 round trip TW={tw}")
        report[f"k9_tw{tw}"] = {"tl": tile_lanes(tw), "equal": True,
                                "pack": groups_launch_of(words, 8),
                                "unpack": groups_launch_of(planes, 8)}
        for name, err in (("pack_sublane", err_p), ("unpack_sublane", err_u)):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
    report["k9_cases"] = check_groups(rng, device, 8, results, (
        "pack_sublane", "unpack_sublane"))

    gf = GF256()
    M10, masks10 = dense_masks(gf, 10, 4)
    m10 = torch.from_numpy(masks10).to(device)
    rand = rand_words(rng, (32, 80), device)
    wide = rand_words(rng, (40, 96), device)
    off = rand_words(rng, (80, W_PLANE + 4), device)
    cases = {
        "RS(10,4) select masks (32,80)": (
            m10, rand_words(rng, (80, W_PLANE), device)),
        "random-word masks (32,80)": (
            rand, rand_words(rng, (80, W_PLANE), device)),
        "RS(50,20) select masks (160,400)": (
            torch.from_numpy(dense_masks(gf, 50, 20)[1]).to(device),
            rand_words(rng, (400, W_PLANE), device)),
        "W = 32,767": (rand, rand_words(rng, (80, W_PLANE - 1), device)),
        "W = 1,001": (rand, rand_words(rng, (80, 1001), device)),
        "planes 4 bytes off 16": (m10, off[:, 1:W_PLANE + 1]),
        "masks sliced (32,80) of (40,96)": (
            wide[3:35, 7:87], rand_words(rng, (80, W_PLANE), device)),
        "R = 20": (rand_words(rng, (20, 80), device),
                   rand_words(rng, (80, W_PLANE), device)),
        "K split, W = 2,048": (rand, rand_words(rng, (80, 2048), device)),
    }
    for name, (m, planes) in cases.items():
        (R, C), W = m.shape, planes.shape[1]
        if W % 8:
            tiled = planes_to_tiled(planes)
        else:
            tiled = planes.reshape(C, 8, W // 8)
        out = gf2_matmul_dense(m, planes)
        e11 = max_abs_err(out, gf2_matmul_dense_plain(m, planes))
        out_t = gf2_matmul_dense_tiled(m, tiled)
        e12 = max_abs_err(out_t, gf2_matmul_dense_tiled_plain(m, tiled))
        torch.cuda.synchronize()
        check(e11 == 0, f"K11 {name} vs plain")
        check(e12 == 0, f"K12 {name} vs plain")
        check(torch.equal(tiled_to_planes(out_t, W), out),
              f"K12 vs K11 {name}")
        entry = {"masks": [R, C], "W": W, "equal": True,
                 "k11": dense_plan(m, planes)}
        if m is m10 and W == W_PLANE and planes.is_contiguous():
            threads, prog = sparse_plan(bits_to_rows(masks10 != 0), C)
            sparse = gf2_matmul_sparse(prog.to(device), tiled, threads)
            check(torch.equal(sparse, out_t), f"K12 vs K4 {name}")
            entry["equal_to_k4"] = True
        report[name] = entry
        results["gf2mm_dense"]["max_abs_err"] = max(
            results["gf2mm_dense"]["max_abs_err"], e11)
        results["gf2mm_dense_tiled"]["max_abs_err"] = max(
            results["gf2mm_dense_tiled"]["max_abs_err"], e12)
    check(report["planes 4 bytes off 16"]["k11"]["copy_words"] == 1
          and report["W = 1,001"]["k11"]["copy_words"] == 1
          and report["K split, W = 2,048"]["k11"]["ksplit"] > 1,
          "the dense cases reach the 4-byte copies and the K split")
    return report


def degraded_rows(chunks, present):
    """(index, rows) of each encoded chunk's ``present`` shards, built
    from its data and parity rows without assembling the codeword."""
    for c in chunks:
        k = c.data.shape[0]
        rows = np.empty((len(present), c.data.shape[1]), dtype=np.uint8)
        for i, j in enumerate(present):
            rows[i] = c.data[j] if j < k else c.parity[j - k]
        yield c.index, rows


def stream_parity_ok(enc, c) -> bool:
    """Chunk ``c``'s parity against the NumPy field arithmetic on the first
    64 KiB of each shard, in the field of ``enc`` (u16 symbols over
    GF(2^16))."""
    from noise_ec_tpu_torch.matrix import host_matvec

    cols = min(HOST_SLICE, c.data.shape[1])
    data, parity = c.data[:, :cols], c.parity[:, :cols]
    gf = enc.codec.gf
    if gf.degree == 16:
        data, parity = (np.ascontiguousarray(a).view("<u2")
                        for a in (data, parity))
    return np.array_equal(parity,
                          host_matvec(gf, enc.codec.parity_matrix, data))


def drive_streams(rng, run_path, out: dict, cases: dict) -> dict:
    """Each stream of ``cases`` (name -> (encoder, decoder or None, stream
    bytes, present shard indices)) through ``run_path`` into ``out``:
    encode at depth 4, then decode the ``present`` shards of every chunk
    at depth 4. Every chunk's parity is checked against the NumPy field
    arithmetic on a 64 KiB slice (:func:`stream_parity_ok`), every rebuilt
    chunk against the encoded one, and every stream round trip in full."""
    from noise_ec_tpu_torch.parallel import StreamChunk, decode_stream

    report = {}
    for name, (enc, dec, size, present) in cases.items():
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        chunks, out[f"{name}_encode"] = run_path(
            lambda: list(enc.encode_bytes(data, depth=4)))
        check([c.index for c in chunks] == list(range(len(chunks))),
              f"{name} chunks in order")
        check(decode_stream(chunks, enc.k, len(data)) == data,
              f"{name} round trip")
        for c in chunks:
            check(stream_parity_ok(enc, c),
                  f"{name} chunk {c.index} parity vs host_matvec (64 KiB)")
        report[name] = {"stream_bytes": size, "chunks": len(chunks),
                        "chunk_bytes": enc.chunk_bytes,
                        "stride_bytes": int(chunks[0].data.shape[1]),
                        "tail_data_len": chunks[-1].data_len}
        if dec is not None:
            rebuilt, out[f"{name}_decode"] = run_path(
                lambda: list(dec.reconstruct_stream(
                    degraded_rows(chunks, present), present, depth=4)))
            check([i for i, _ in rebuilt] == [c.index for c in chunks],
                  f"{name} rebuilt chunks in order")
            for (i, rows), c in zip(rebuilt, chunks):
                check(np.array_equal(rows[:enc.k], c.data)
                      and np.array_equal(rows[enc.k:], c.parity),
                      f"{name} chunk {i} rebuilt")
            check(decode_stream(
                [StreamChunk(index=i, shards=rows, data_len=c.data_len)
                 for (i, rows), c in zip(rebuilt, chunks)],
                enc.k, len(data)) == data,
                f"{name} round trip after the loss")
            report[name]["lost"] = [i for i in range(enc.n)
                                    if i not in present]
            del rebuilt
        del chunks, data
    return report


def main_path_streams(rng, run_path, out: dict) -> dict:
    """The streaming paths of main_path, each through ``run_path`` into
    ``out``: RS(50,20) on a 400 MiB stream in 50 MiB chunks (depth 4),
    decoded at 20 erasures; RS(17,3) on 272 MiB in 17 MiB chunks, decoded
    at 3; the object-stream shape (64 MiB in 4 MiB chunks at RS(50,20),
    a short tail); and GF(2^16) ``ReedSolomon(30, 10)`` on a 30 MiB object
    at 1 MiB shards, encode and a 10-erasure reconstruct. Every chunk's
    parity is checked against the NumPy field arithmetic on a 64 KiB
    slice, every rebuilt codeword against the encoded one, and every
    stream round trip in full."""
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.parallel import StreamingDecoder, StreamingEncoder

    present50 = [i for i in range(70) if i not in SPLIT_LOST]
    present17 = [i for i in range(20) if i not in LOST_17_3]
    cases = {
        "stream_rs_50_20": (StreamingEncoder(50, 20, chunk_bytes=50 * SHARD),
                            StreamingDecoder(50, 20), STREAM_50_20,
                            present50),
        "stream_rs_17_3": (StreamingEncoder(17, 3, chunk_bytes=17 * SHARD),
                           StreamingDecoder(17, 3), STREAM_17_3, present17),
        "stream_object_4mib": (StreamingEncoder(50, 20,
                                                chunk_bytes=OBJECT_CHUNK),
                               None, OBJECT_STREAM, None),
    }
    report = drive_streams(rng, run_path, out, cases)
    n50 = report["stream_rs_50_20"]["chunks"]
    n17 = report["stream_rs_17_3"]["chunks"]
    nobj = report["stream_object_4mib"]["chunks"]
    check(report["stream_object_4mib"]["tail_data_len"] < OBJECT_CHUNK,
          "the object stream's tail chunk is short")
    for path, kernel, n in (("stream_rs_50_20_encode", "fused_split", n50),
                            ("stream_rs_50_20_decode", "fused_split", n50),
                            ("stream_rs_17_3_encode", "fused_split", n17),
                            ("stream_rs_17_3_decode", "fused_split", n17),
                            ("stream_object_4mib_encode", "fused_split",
                             nobj)):
        check(out[path][kernel] == n and sum(out[path].values()) == n,
              f"{path}: one {kernel} launch a chunk and no other kernel")

    obj = rng.integers(0, 256, size=30 * SHARD, dtype=np.uint8).tobytes()
    rs16 = ReedSolomon(30, 10, field="gf65536")
    check(rs16._dev.plan_for(rs16.G[30:])[0] == "split",
          "GF(2^16) RS(30,10) parity plans onto K5")
    lost16 = set(range(0, 30, 3))  # ten data shards: a (10, 30) recovery

    def rs16_path():
        shards = rs16.split(obj)
        enc = rs16.encode(shards)
        holes = [None if i in lost16 else s for i, s in enumerate(enc)]
        rec = rs16.reconstruct(holes)
        return shards, enc, rec, rs16.join(rec, len(obj))

    (shards, enc, rec, joined), out["rs16_30_10"] = run_path(rs16_path)
    ref = ReedSolomon(30, 10, field="gf65536", backend="numpy")
    cut = [s[:HOST_SLICE] for s in shards]
    check(all(np.array_equal(a[:HOST_SLICE], b)
              for a, b in zip(enc, ref.encode(cut))),
          "GF(2^16) RS(30,10) encode vs numpy backend (64 KiB slice)")
    check(all(np.array_equal(a, b) for a, b in zip(rec, enc)),
          "GF(2^16) RS(30,10) reconstruct at 10 erasures")
    check(joined == obj, "GF(2^16) RS(30,10) join")
    check(out["rs16_30_10"]["fused_split"] == 2
          and sum(out["rs16_30_10"].values()) == 2,
          "GF(2^16) RS(30,10): encode and reconstruct on K5 alone")
    report["rs16_30_10"] = {"object_bytes": len(obj),
                            "erasures": sorted(lost16)}
    return {"streams": report}


def main_path_words16(rng, run_path, out: dict) -> dict:
    """The interleaved GF(2^16) words paths of main_path, each through
    ``run_path`` into ``out``: ``StreamingEncoder(30, 10,
    field="gf65536")`` on 240 MiB in 30 MiB chunks (1 MiB shards, depth
    4), decoded at ten data erasures (K5@16 both ways);
    ``StreamingEncoder(50, 20, field="gf65536")`` on 400 MiB in 50 MiB
    chunks, decoded at 10 data + 10 parity erasures (K6@16 -> K7 -> K6@16
    both ways); and ``BatchCodec(10, 4, field="gf65536")`` on a batch of
    four 1 MiB-shard objects, ``encode_batch_words`` on the planner's tier
    and the words product under each forced tier. Every chunk's parity is
    checked against the NumPy field arithmetic on a 64 KiB slice, every
    rebuilt chunk against the encoded one, every stream round trip in full,
    and every batch product against the host on a 64 KiB slice."""
    from noise_ec_tpu_torch.parallel import (
        BatchCodec,
        StreamingDecoder,
        StreamingEncoder,
    )

    cases = {}
    for name, (k, r, size, lost) in {
            "stream16_rs_30_10": (30, 10, STREAM16_30_10, LOST16_30_10),
            "stream16_rs_50_20": (50, 20, STREAM_50_20, SPLIT_LOST)}.items():
        cases[name] = (StreamingEncoder(k, r, chunk_bytes=k * SHARD,
                                        field="gf65536"),
                       StreamingDecoder(k, r, field="gf65536"), size,
                       [i for i in range(k + r) if i not in lost])
    report = drive_streams(rng, run_path, out, cases)
    for path in ("encode", "decode"):
        n = report["stream16_rs_30_10"]["chunks"]
        counts = out[f"stream16_rs_30_10_{path}"]
        check(counts["fused_split16"] == n and sum(counts.values()) == n,
              f"stream16_rs_30_10_{path}: one K5@16 launch a chunk and no "
              "other kernel")
        n = report["stream16_rs_50_20"]["chunks"]
        counts = out[f"stream16_rs_50_20_{path}"]
        check(counts["pack_lanes_blocked16"] == n
              and counts["unpack_lanes_blocked16"] == n
              and counts["gf2mm_panel"] >= n,
              f"stream16_rs_50_20_{path}: K6@16 -> K7 -> K6@16 a chunk")
        for name in ("stream16_rs_30_10", "stream16_rs_50_20"):
            counts = out[f"{name}_{path}"]
            check(counts["pack_words16"] == 0
                  and counts["unpack_words16"] == 0,
                  f"{name}_{path}: no K10 launch")

    bc = BatchCodec(10, 4, field="gf65536")
    words = rand_words(rng, (4, 10, TW), bc.device_codec().device)
    full, out["batch16"] = run_path(lambda: bc.encode_batch_words(words))
    check(out["batch16"]["fused_split16"] == 1
          and sum(out["batch16"].values()) == 1,
          "BatchCodec GF(2^16) encode_batch_words: one K5@16 launch")
    want = [host_words16(bc.parity_matrix, words[b], HOST_SLICE // 4)
            for b in range(4)]
    for b in range(4):
        check(np.array_equal(full[b, 10:, :HOST_SLICE // 4].cpu().numpy()
                             .view("<u2"), want[b]),
              f"BatchCodec GF(2^16) batch {b} parity vs host_matvec")
    tier_kernels = {"split": ("fused_split16",), "fused": ("fused_encode16",),
                    "pipeline": ("pack_lanes16", "gf2mm_sparse",
                                 "unpack_lanes16")}
    for tier, kernels in tier_kernels.items():
        got, out[f"batch16_{tier}"] = run_path(
            lambda: bc.device_codec().matmul_words_batch(
                bc.parity_matrix, words, tier=tier))
        check(torch.equal(got, full[:, 10:]),
              f"BatchCodec GF(2^16) tier {tier} vs the planner's")
        counts = out[f"batch16_{tier}"]
        check(all(counts[n] == 1 for n in kernels)
              and sum(counts.values()) == len(kernels),
              f"BatchCodec GF(2^16) tier {tier} ran {kernels} once each")
    report["batch16"] = {"batch": 4, "k": 10, "r": 4, "shard_bytes": SHARD,
                         "tiers": [None, *tier_kernels]}
    return {"words16_paths": report}


def main_path_gf16(rng, run_path, out: dict) -> dict:
    """The GF(2^16) paths and the dense GF(2^8) "mxu" path of main_path,
    each run through ``run_path`` into ``out``; every output checked
    against the NumPy codec (RS(200,56) and the wide words on a 64 KiB
    slice of each shard, the rest in full)."""
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.pack import (
        bytesliced_to_words16,
        words16_to_bytesliced,
    )

    obj = rng.integers(0, 256, size=10 * SHARD, dtype=np.uint8).tobytes()
    wide_obj = rng.integers(0, 256, size=200 * SHARD,
                            dtype=np.uint8).tobytes()
    rs = ReedSolomon(10, 4, field="gf65536")
    rs200 = ReedSolomon(200, 56, field="gf65536")
    codec16 = DeviceCodec(field="gf65536")
    gf16 = rs.gf
    M60 = generator_matrix(gf16, 60, 80, "cauchy")[60:]
    M49 = tier3_matrix()
    check(codec16.route_for(rs.G[10:]) == "baked", "GF(2^16) RS(10,4) baked")
    check(codec16.route_for(M60) == "panel", "GF(2^16) RS(60,20) panel")
    check(codec16.route_for(M49) == "baked", "GF(2^16) RS(49,2) baked")
    device = codec16.device
    w10 = rand_words(rng, (10, TW), device)
    w60 = rand_words(rng, (60, TW), device)
    w49 = rand_words(rng, (49, TW), device)
    dense = rng.integers(1, 256, size=(200, 200), dtype=np.uint8)
    dense_in = rng.integers(0, 256, size=(200, SHARD), dtype=np.uint8)
    codec = DeviceCodec()
    check(codec.route_for(dense) == "mxu", "dense (200,200) routes mxu")
    wide_lost = set(WIDE_LOST)

    def codec_path(rsx, blob, lost):
        shards = rsx.split(blob)
        enc = rsx.encode(shards)
        verified = rsx.verify(enc)
        holes = [None if i in lost else s for i, s in enumerate(enc)]
        rec = rsx.reconstruct(holes)
        data = rsx.reconstruct_data(holes)
        return (shards, enc, verified, holes, rec, data,
                rsx.join(rec, len(blob)))

    def words16():
        return (codec16.matmul_words(rs.G[10:], w10),
                codec16.matmul_words(M60, w60),
                codec16.matmul_words(M49, w49, tier="pipeline"))

    r10, out["rs16_10_4"] = run_path(
        lambda: codec_path(rs, obj, {0, 5, 11}))
    r200, out["rs16_200_56"] = run_path(
        lambda: codec_path(rs200, wide_obj, wide_lost))
    codec16.plan_for(M49, "pipeline")  # host factoring, before the path
    (i10, i60, i49), out["words16"] = run_path(words16)
    dense_out, out["mxu_256"] = run_path(
        lambda: codec.matmul_stripes(dense, dense_in))

    ref = ReedSolomon(10, 4, field="gf65536", backend="numpy")
    shards, enc, verified, holes, rec, data, joined = r10
    check(all(np.array_equal(a, b) for a, b in zip(enc, ref.encode(shards))),
          "GF(2^16) RS(10,4) encode vs numpy backend")
    check(verified, "GF(2^16) RS(10,4) verify")
    check(all(np.array_equal(a, b) for a, b in
              zip(rec, ref.reconstruct(holes))),
          "GF(2^16) RS(10,4) reconstruct vs numpy backend")
    check(all(np.array_equal(a, b) for a, b in zip(data[:10], enc)),
          "GF(2^16) RS(10,4) reconstruct_data")
    check(joined == obj, "GF(2^16) RS(10,4) join")

    ref200 = ReedSolomon(200, 56, field="gf65536", backend="numpy")
    shards, enc, verified, holes, rec, data, joined = r200
    cut = [s[:HOST_SLICE] for s in shards]
    check(all(np.array_equal(a[:HOST_SLICE], b)
              for a, b in zip(enc, ref200.encode(cut))),
          "GF(2^16) RS(200,56) encode vs numpy backend (64 KiB slice)")
    check(verified, "GF(2^16) RS(200,56) verify")
    want = ref200.reconstruct(
        [None if s is None else s[:HOST_SLICE] for s in holes])
    check(all(np.array_equal(a[:HOST_SLICE], b) for a, b in zip(rec, want)),
          "GF(2^16) RS(200,56) reconstruct vs numpy backend (64 KiB slice)")
    check(all(np.array_equal(a, b) for a, b in zip(rec, enc)),
          "GF(2^16) RS(200,56) reconstruct 28 data + 28 parity")
    check(all(np.array_equal(a, b) for a, b in zip(data[:200], enc)),
          "GF(2^16) RS(200,56) reconstruct_data")
    check(joined == wide_obj, "GF(2^16) RS(200,56) join")

    for name, M, w, got, cols in (("RS(10,4)", rs.G[10:], w10, i10, TW),
                                  ("RS(60,20)", M60, w60, i60,
                                   HOST_SLICE // 4),
                                  ("RS(49,2) tier 3", M49, w49, i49,
                                   HOST_SLICE // 4)):
        sliced = words16_to_bytesliced(w)
        once = codec16.matmul_words_bytesliced(M, sliced)
        # Called twice: the key's second call is device_op's execute route.
        check(torch.equal(codec16.matmul_words_bytesliced(M, sliced), once),
              f"the byte-sliced entry at {name}, called again")
        via = bytesliced_to_words16(once)
        host = host_matvec(gf16, M, w[:, :cols].cpu().numpy().view("<u2"))
        check(torch.equal(got, via),
              f"interleaved GF(2^16) {name} vs the byte-sliced entry")
        check(np.array_equal(got[:, :cols].cpu().numpy().view("<u2"), host),
              f"interleaved GF(2^16) {name} vs host_matvec")
    check(np.array_equal(dense_out[:, :HOST_SLICE], host_matvec(
        GF256(), dense, dense_in[:, :HOST_SLICE])),
        "dense (200,200) matmul_stripes vs host_matvec (64 KiB slice)")

    for path in ("rs16_200_56", "mxu_256"):
        check(out[path]["mxu_gf2"] > 0, f"K8 launched on {path}")
    # encode, verify, reconstruct (56,200) and reconstruct_data (28,200):
    # four products, every one past the XOR-network budgets.
    check(out["rs16_200_56"]["mxu_gf2"] == 4 and sum(
        out["rs16_200_56"].values()) == 4,
        "GF(2^16) RS(200,56) ran its four products, encode and reconstruct "
        "included, on K8 alone")
    check(out["rs16_10_4"]["fused_split"] > 0,
          "K5 launched on GF(2^16) RS(10,4)")
    # K5@16 at RS(10,4), K6@16 -> K7 -> K6@16 at RS(60,20), and the forced
    # pipeline's tier 3 at RS(49,2).
    for name in ("fused_split16", "pack_lanes_blocked16", "gf2mm_panel",
                 "unpack_lanes_blocked16", "pack_words16", "gf2mm_sparse",
                 "unpack_words16"):
        check(out["words16"][name] == 1, f"{name} launched once on words16")
    check(sum(out["words16"].values()) == 7, "words16 ran those seven")
    return {"rs16_10_4_object_bytes": len(obj),
            "rs16_200_56_object_bytes": len(wide_obj),
            "rs16_200_56_erasures": list(WIDE_LOST),
            "words16_matrices": ["RS(10,4) parity", "RS(60,20) parity",
                                 "RS(49,2) parity, tier 3 forced"],
            "mxu_256_stripe_bytes": SHARD}


def main_path_dense_masks(rng, run_path, out: dict) -> dict:
    """The dense-mask ops API on a runtime matrix, as ``main_path``: RS(10,4)
    parity of 1 MiB shards as K9 pack -> K11 (and K12 on the tiled view of
    the same planes) with the expanded select masks -> K9 unpack, both
    against the NumPy field arithmetic."""
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.matrix import host_matvec
    from noise_ec_tpu_torch.ops.gf2mm import (
        gf2_matmul_dense,
        gf2_matmul_dense_tiled,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_sublane,
        unpack_words_sublane,
    )

    gf = GF256()
    M, masks = dense_masks(gf, 10, 4)
    data = rng.integers(0, 256, size=(10, SHARD), dtype=np.uint8)
    words = torch.from_numpy(data.view(np.int32)).cuda()
    m = torch.from_numpy(masks).cuda()

    def path():
        flat = pack_words_sublane(words).reshape(80, W_PLANE)
        p11 = gf2_matmul_dense(m, flat)
        p12 = gf2_matmul_dense_tiled(m, flat.reshape(80, 8, W_PLANE // 8))
        return tuple(unpack_words_sublane(p.reshape(4, 8, W_PLANE))
                     for p in (p11, p12))

    (p11, p12), out["dense_masks"] = run_path(path)
    want = host_matvec(gf, M, data)
    for name, got in (("K11", p11), ("K12", p12)):
        check(np.array_equal(got.cpu().numpy().view(np.uint8), want),
              f"dense-mask RS(10,4) parity through {name} vs host_matvec")
    for name in ("pack_sublane", "gf2mm_dense", "gf2mm_dense_tiled",
                 "unpack_sublane"):
        check(out["dense_masks"][name] > 0, f"{name} launched on dense_masks")
    return {"dense_masks": {"matrix": "RS(10,4) parity", "shard_bytes": SHARD,
                            "masks": list(masks.shape)}}


def main_path_hwcheck(run_path, out: dict, codecs: dict) -> dict:
    """The port's hardware check (``noise_ec_tpu_torch.tools.hwcheck``), as
    ``main_path``, on the shared codecs (their plans are reused): all 51
    checks must pass, and the sublane kernels K9 must have run (tier 3)."""
    from noise_ec_tpu_torch.tools import hwcheck

    report, out["hwcheck"] = run_path(
        lambda: hwcheck.run("cuda", codecs=codecs))
    failed = [c["check"] for c in report["checks"] if not c["ok"]]
    check(not failed, f"hwcheck: failed {failed}")
    check(len(report["checks"]) == 51, "hwcheck ran its 51 checks")
    for name in ("pack_sublane", "unpack_sublane", "pack_lanes",
                 "unpack_lanes", "gf2mm_sparse", "fused_split",
                 "gf2mm_panel", "mxu_gf2"):
        check(out["hwcheck"][name] > 0, f"{name} launched on hwcheck")
    return {"hwcheck": {key: report[key]
                        for key in ("device", "ok", "elapsed_s")}
            | {"checks": len(report["checks"])}}


def fec_cases(rng, shares: list, k: int) -> dict:
    """The FEC decode cases over one codeword's ``shares``: the first k in
    order (the systematic shortcut), all of them with share 1 wholly
    corrupt, and all of them with FEC_SCATTER byte columns wrong in one
    share and FEC_SCATTER2 in two (the syndrome path)."""
    from noise_ec_tpu_torch.codec import Share

    rows = np.stack([np.frombuffer(s.data, np.uint8) for s in shares])
    whole = rows.copy()
    whole[1] ^= 0x3C
    scattered = rows.copy()
    n, S = rows.shape
    cols = rng.choice(S, size=FEC_SCATTER + FEC_SCATTER2, replace=False)
    one = rng.integers(0, n, size=cols.size)
    scattered[one, cols] ^= rng.integers(1, 256, size=cols.size,
                                         dtype=np.uint8)
    two = (one[:FEC_SCATTER2] + rng.integers(1, n, size=FEC_SCATTER2)) % n
    scattered[two, cols[:FEC_SCATTER2]] ^= rng.integers(
        1, 256, size=FEC_SCATTER2, dtype=np.uint8)

    def as_shares(a):
        return [Share(i, a[i].tobytes()) for i in range(n)]

    return {"in_order_k": shares[:k], "whole_share": as_shares(whole),
            "scattered": as_shares(scattered)}


def main_path_fec(rng, run_path, out: dict) -> dict:
    """The infectious codec, as ``main_path``: ``FEC(10, 14)`` with 1 MiB
    shares (a 10 MiB payload) on ``bw_route="device"`` and on "host":
    ``encode_shares``, then ``decode`` of each :func:`fec_cases` case; and
    GF(2^16) ``FEC(10, 14)`` on the device route with share 1 wholly
    corrupt (the byte-sliced fold). Every decode returns the payload byte
    for byte; the device route's corrupted decodes run on the card and the
    host route's decodes launch nothing."""
    from noise_ec_tpu_torch.codec import FEC

    payload = rng.integers(0, 256, size=10 * SHARD, dtype=np.uint8).tobytes()
    report = {}
    cases = None
    for route in ("device", "host"):
        fec = FEC(10, 14, bw_route=route)
        shares, out[f"fec_{route}_encode"] = run_path(
            lambda: fec.encode_shares(payload))
        check(out[f"fec_{route}_encode"]["fused_split"] > 0,
              f"K5 launched on fec_{route}_encode")
        if cases is None:
            cases = fec_cases(rng, shares, 10)
        for name, case in cases.items():
            got, out[f"fec_{route}_{name}"] = run_path(
                lambda: fec.decode(case))
            check(got == payload, f"FEC {route} {name} returns the payload")
        report[route] = dict(fec.stats)
    check(report["device"] == report["host"] == {
        "fast_decodes": 1, "bw_decodes": 2, "subset_decodes": 0},
        "FEC stats on both routes")
    for name in cases:
        check(sum(out[f"fec_host_{name}"].values()) == 0,
              f"fec_host_{name} launches nothing")
    check(sum(out["fec_device_in_order_k"].values()) == 0,
          "the systematic shortcut launches nothing")
    for name in ("whole_share", "scattered"):
        check(out[f"fec_device_{name}"]["fused_split"] > 0,
              f"K5 launched on fec_device_{name}")

    fec16 = FEC(10, 14, field="gf65536", bw_route="device")
    shares16 = fec16.encode_shares(payload)
    case16 = fec_cases(rng, shares16, 10)["whole_share"]
    got16, out["fec16_device_whole_share"] = run_path(
        lambda: fec16.decode(case16))
    check(got16 == payload, "GF(2^16) FEC whole_share returns the payload")
    check(out["fec16_device_whole_share"]["fused_split"] > 0,
          "K5 launched on fec16_device_whole_share")
    report["gf65536_device"] = dict(fec16.stats)
    return {"fec": {"payload_bytes": len(payload), "shares": 14,
                    "scatter_columns": [FEC_SCATTER, FEC_SCATTER2],
                    "stats": report}}


def phase_main_path(rng, codecs: dict) -> dict:
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.matrix import host_matvec, reconstruction_matrix
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    obj = rng.integers(0, 256, size=10 * SHARD, dtype=np.uint8).tobytes()
    small = rng.integers(0, 256, size=64 << 10, dtype=np.uint8).tobytes()
    batch = [rng.integers(0, 256, size=(10, SHARD), dtype=np.uint8)
             for _ in range(5)]
    forced = rng.integers(0, 256, size=(10, SHARD), dtype=np.uint8)
    wide_obj = rng.integers(0, 256, size=200 * SHARD, dtype=np.uint8).tobytes()
    obj229 = rng.integers(0, 256, size=229 * (64 << 10) - 5,
                          dtype=np.uint8).tobytes()
    rs = ReedSolomon(10, 4)  # device="cuda" is the default
    rs42 = ReedSolomon(4, 2)
    rs200 = ReedSolomon(200, 56)
    rs229 = ReedSolomon(229, 6)
    codec = DeviceCodec()
    out = {}

    def run_path(fn):
        """Each path runs with the counts zeroed just before it and read
        just after; the kernels' line sums them."""
        reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, launch_counts()

    def rs_10_4():
        shards = rs.split(obj)
        enc = rs.encode(shards)
        verified = rs.verify(enc)
        lost = [None if i in (0, 5, 11) else s for i, s in enumerate(enc)]
        rec = rs.reconstruct(lost)
        return shards, enc, verified, rec, rs.join(rec, len(obj))

    def rs_4_2():
        enc = rs42.encode(rs42.split(small))
        lost = [None if i in (1, 4) else s for i, s in enumerate(enc)]
        return enc, rs42.join(rs42.reconstruct(lost), len(small))

    (shards, enc, verified, rec, joined), out["rs_10_4"] = run_path(rs_10_4)
    outs, out["batch"] = run_path(lambda: rs.matmul_many(rs.G[10:], batch))
    (enc42, joined42), out["rs_4_2"] = run_path(rs_4_2)
    piped, out["pipeline"] = run_path(
        lambda: codec.matmul_stripes(rs.G[10:], forced, tier="pipeline"))
    # K1 runs where it is forced: the planner takes K5 first (PERF.md).
    fused1, out["fused_forced"] = run_path(
        lambda: codec.matmul_stripes(rs.G[10:], forced, tier="fused"))

    # The panel route. Planning a new matrix is host work: the recovery
    # matrices are planned (and timed) before their path runs.
    wide_lost = set(WIDE_LOST)
    present = [i for i in range(256) if i not in wide_lost][:200]
    plan_s = {}
    for name, rows in (("recovery_56", list(WIDE_LOST)),
                       ("recovery_28", list(WIDE_LOST[:28]))):
        R = reconstruction_matrix(rs200.gf, rs200.G, present, rows)
        check(rs200._dev.route_for(R) == "panel", f"{name} routes panel")
        t0 = time.monotonic()
        rs200._dev.plan_for(R)
        plan_s[name] = time.monotonic() - t0

    def rs_200_56():
        shards = rs200.split(wide_obj)
        enc = rs200.encode(shards)
        verified = rs200.verify(enc)
        lost = [None if i in wide_lost else s for i, s in enumerate(enc)]
        rec = rs200.reconstruct(lost)
        data = rs200.reconstruct_data(lost)
        return shards, enc, verified, lost, rec, data, rs200.join(
            rec, len(wide_obj))

    def rs_229_6():
        enc = rs229.encode(rs229.split(obj229))
        lost = [None if i in (0, 117, 231) else s for i, s in enumerate(enc)]
        rec = rs229.reconstruct(lost)
        return enc, rs229.verify(enc), lost, rec, rs229.join(rec, len(obj229))

    (w_shards, w_enc, w_verified, w_lost, w_rec, w_data, w_joined), \
        out["rs_200_56"] = run_path(rs_200_56)
    (enc229, verified229, lost229, rec229, joined229), out["rs_229_6"] = \
        run_path(rs_229_6)

    ref = ReedSolomon(10, 4, backend="numpy")
    check(all(np.array_equal(a, b) for a, b in zip(enc, ref.encode(shards))),
          "RS(10,4) encode vs numpy backend")
    check(verified, "RS(10,4) verify")
    check(all(np.array_equal(a, b) for a, b in zip(rec, enc)),
          "RS(10,4) reconstruct {0,5,11}")
    check(joined == obj, "RS(10,4) join")
    for D, got in zip(batch, outs):
        check(np.array_equal(got, host_matvec(rs.gf, rs.G[10:], D)),
              "matmul_many B=5")
    want42 = ReedSolomon(4, 2, backend="numpy").encode(rs42.split(small))
    check(all(np.array_equal(a, b) for a, b in zip(enc42, want42)),
          "RS(4,2) encode vs numpy backend")
    check(joined42 == small, "RS(4,2) round trip")
    check(np.array_equal(piped, host_matvec(rs.gf, rs.G[10:], forced)),
          "forced pipeline")
    check(np.array_equal(fused1, piped), "forced K1")
    for path in ("rs_10_4", "batch", "rs_4_2"):
        check(out[path]["fused_split"] > 0, f"K5 launched on {path}")
    check(out["fused_forced"]["fused_encode"] == 1
          and sum(out["fused_forced"].values()) == 1,
          "the forced product ran on K1 alone")
    for name in ("pack_lanes", "gf2mm_sparse", "unpack_lanes"):
        check(out["pipeline"][name] > 0, f"{name} launched on the pipeline")

    ref200 = ReedSolomon(200, 56, backend="numpy")
    cut = [s[:HOST_SLICE] for s in w_shards]
    want = ref200.encode(cut)
    check(all(np.array_equal(a[:HOST_SLICE], b)
              for a, b in zip(w_enc, want)),
          "RS(200,56) encode vs numpy backend (64 KiB slice)")
    check(w_verified, "RS(200,56) verify")
    want_rec = ref200.reconstruct(
        [None if s is None else s[:HOST_SLICE] for s in w_lost])
    check(all(np.array_equal(a[:HOST_SLICE], b)
              for a, b in zip(w_rec, want_rec)),
          "RS(200,56) reconstruct vs numpy backend (64 KiB slice)")
    check(all(np.array_equal(a, b) for a, b in zip(w_rec, w_enc)),
          "RS(200,56) reconstruct 28 data + 28 parity")
    check(all(np.array_equal(a, b) for a, b in zip(w_data[:200], w_enc)),
          "RS(200,56) reconstruct_data")
    check(w_joined == wide_obj, "RS(200,56) join")
    ref229 = ReedSolomon(229, 6, backend="numpy")
    check(all(np.array_equal(a, b) for a, b in
              zip(enc229, ref229.encode(rs229.split(obj229)))),
          "RS(229,6) encode vs numpy backend")
    check(verified229, "RS(229,6) verify")
    check(all(np.array_equal(a, b) for a, b in
              zip(rec229, ref229.reconstruct(lost229))),
          "RS(229,6) reconstruct vs numpy backend")
    check(joined229 == obj229, "RS(229,6) round trip")
    for path in ("rs_200_56", "rs_229_6"):
        for name in ("pack_lanes_blocked", "gf2mm_panel",
                     "unpack_lanes_blocked"):
            check(out[path][name] > 0, f"{name} launched on {path}")
    check(out["rs_200_56"]["fused_encode"] == 0
          and out["rs_200_56"]["fused_split"] == 0,
          "RS(200,56) runs no fused-kernel launch")
    gf16_report = main_path_gf16(rng, run_path, out)
    words16_report = main_path_words16(rng, run_path, out)
    stream_report = main_path_streams(rng, run_path, out)
    dense_report = main_path_dense_masks(rng, run_path, out)
    hwcheck_report = main_path_hwcheck(run_path, out, codecs)
    fec_report = main_path_fec(rng, run_path, out)
    launches = {name: sum(c[name] for c in out.values())
                for name in out["pipeline"]}
    return {"phase": "main_path", "launches": launches, "by_path": out,
            **gf16_report, **words16_report, **stream_report,
            **dense_report,
            **hwcheck_report, **fec_report,
            "rs_10_4_object_bytes": len(obj), "erasures": [0, 5, 11],
            "batch": len(batch), "rs_4_2_message_bytes": len(small),
            "rs_200_56_object_bytes": len(wide_obj),
            "rs_200_56_erasures": list(WIDE_LOST),
            "rs_200_56_recovery_plan_seconds": plan_s,
            "rs_229_6_object_bytes": len(obj229),
            "rs_229_6_erasures": [0, 117, 231],
            "panel_entries": True, "warm_stripes": True}


def phase_times(rng, device, results: dict) -> dict:
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_encode_words_plain,
    )
    from noise_ec_tpu_torch.ops.gf2mm import (
        gf2_matmul_sparse,
        gf2_matmul_sparse_plain,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_lanes,
        pack_words_lanes_plain,
        unpack_words_lanes,
        unpack_words_lanes_plain,
    )

    timer = Timer(device)
    codec = DeviceCodec(device=device)
    _, mats = matrices()
    M = mats["RS(10,4)"]
    words = rand_words(rng, (10, TW), device)
    W8 = TW // 64
    groups = TW // 8
    _, f_threads, f_prog, _ = codec.plan_for(M, "fused")
    _, p_threads, p_prog, _ = codec.plan_for(M, "pipeline")
    planes = pack_words_lanes(words, 512)
    planes80 = planes.reshape(80, 8, W8)
    parity_planes = gf2_matmul_sparse(p_prog, planes80, p_threads)
    parity_planes = parity_planes.reshape(4, 8, 8, W8)

    cases = {
        "fused_encode": (
            lambda: fused_encode_words(f_prog, words, 4, f_threads),
            lambda: fused_encode_words_plain(f_prog, words, 4, 512),
            14 * SHARD, f_prog.cost * groups + 14 * groups * TRANSPOSE_OPS,
        ),
        "pack_lanes": (
            lambda: pack_words_lanes(words, 512),
            lambda: pack_words_lanes_plain(words, 512),
            20 * SHARD, 10 * groups * TRANSPOSE_OPS,
        ),
        "gf2mm_sparse": (
            lambda: gf2_matmul_sparse(p_prog, planes80, p_threads),
            lambda: gf2_matmul_sparse_plain(p_prog, planes80),
            14 * SHARD, p_prog.cost * groups,
        ),
        "unpack_lanes": (
            lambda: unpack_words_lanes(parity_planes, 512),
            lambda: unpack_words_lanes_plain(parity_planes, 512),
            8 * SHARD, 4 * groups * TRANSPOSE_OPS,
        ),
    }
    for name, (kernel, plain, nbytes, nops) in cases.items():
        b_ms, b_by = bound(nbytes, nops)
        results[name].update(
            ms=timer.median_ms(kernel), plain_ms=timer.median_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
        )

    # The BASELINE metrics, RS(10,4) at 1 MiB shards.
    words_ms = timer.median_ms(lambda: codec.matmul_words(M, words))
    pipe_ms = timer.median_ms(
        lambda: codec.matmul_words(M, words, tier="pipeline"))
    rs = ReedSolomon(10, 4, device=str(device))
    data = [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
            for _ in range(10)]
    enc = rs.encode(data)
    lost = [None if i in (0, 5, 11) else s for i, s in enumerate(enc)]
    rs.reconstruct(lost)

    def host_p50(fn) -> float:
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    encode_ms = host_p50(lambda: rs.encode(data))
    reconstruct_ms = host_p50(lambda: rs.reconstruct(lost))
    data_bytes = 10 * SHARD
    return {
        "phase": "times", "reps": REPS,
        "rs_10_4_matmul_words_ms": words_ms,
        "rs_10_4_matmul_words_gbps": data_bytes / words_ms / 1e6,
        "rs_10_4_matmul_words_pipeline_ms": pipe_ms,
        "rs_10_4_encode_ms": encode_ms,
        "rs_10_4_encode_gbps": data_bytes / encode_ms / 1e6,
        "rs_10_4_reconstruct_3_erasures_p50_ms": reconstruct_ms,
        "library_ms_note": LIBRARY_NOTE,
    }


def panel_xors(bits_rows: tuple, c0: int, c1: int) -> int:
    """XORs a bound charges the product of ``bits_rows`` over input planes
    [c0, c1): the reference panelling's factored XORs (REF_PANEL_KB), plus
    one XOR a row for each further K block that holds a term of it."""
    from noise_ec_tpu_torch.ops.xor_factor import (
        factor_panels,
        split_bits_rows_panels,
    )

    rows = tuple(tuple(c - c0 for c in row if c0 <= c < c1)
                 for row in bits_rows)
    panels = split_bits_rows_panels(rows, c1 - c0, REF_PANEL_KB,
                                    REF_PANEL_RB)
    xors, _ = factor_panels(panels, REF_PANEL_KB)
    blocks = [len({c // REF_PANEL_KB for c in row}) for row in rows]
    return xors + sum(max(n - 1, 0) for n in blocks)


def core_floor(R: int, C: int, W: int) -> float:
    """The product core's own operation floor, ms: one LOP3 (acc ^= mask &
    plane) for each of the R x C mask words on each of W plane words, at
    the logic-op peak (the dense product the core runs, not the factored
    network the bound charges)."""
    return R * C * W / INT_OPS_PER_S * 1e3


def panel_bound(bits_rows: tuple, c0: int, c1: int, acc: bool,
                P: int) -> tuple:
    """(bound_ms, bound_by) of one panel-matmul launch over input planes
    [c0, c1) of ``bits_rows``, ``P`` words a plane: those planes read and
    the R output planes written once (``acc`` read once too); the
    :func:`panel_xors` of that slice (one more XOR for each row folded
    into ``acc``) on every plane word."""
    R = len(bits_rows)
    nbytes = ((c1 - c0) + R * (2 if acc else 1)) * P * 4
    xors = panel_xors(bits_rows, c0, c1)
    if acc:
        xors += sum(1 for row in bits_rows if any(c0 <= c < c1 for c in row))
    return bound(nbytes, xors * P)


def panel_matrices(codec) -> dict:
    """The panel-routed matrices the times are taken on, with the int32
    words a shard the main path gives each: RS(200,56)'s parity and its
    (56,200) recovery matrix at 1 MiB shards, RS(229,6)'s parity at 64 KiB
    shards."""
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )

    gf, M = rs_200_56_parity()
    G = generator_matrix(gf, 200, 256, "cauchy")
    present = [i for i in range(256) if i not in set(WIDE_LOST)][:200]
    out = {
        "RS(200,56) parity": (M, TW),
        "RS(200,56) recovery (56,200)": (
            reconstruction_matrix(gf, G, present, list(WIDE_LOST)), TW),
        "RS(229,6) parity": (
            generator_matrix(gf, 229, 235, "cauchy")[229:], (64 << 10) // 4),
    }
    for name, (M, _) in out.items():
        check(codec.route_for(M) == "panel", f"{name} routes panel")
    return out


def phase_panel_times(rng, device, results: dict) -> dict:
    """K6 and K7 times at RS(200,56), 1 MiB shards, K7 also on the other
    panel matrices (:func:`panel_matrices`), and the codec's RS(200,56)
    numbers."""
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.matrix import reconstruction_matrix
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_lanes_blocked,
        pack_words_lanes_blocked_plain,
        unpack_words_lanes_blocked,
        unpack_words_lanes_blocked_plain,
    )
    from noise_ec_tpu_torch.ops.panel import (
        gf2_matmul_panel,
        gf2_matmul_panel_plain,
        sublaunch_bounds,
        sublaunch_count,
    )

    timer = Timer(device)
    codec = DeviceCodec(device=device)
    _, M = rs_200_56_parity()
    _, threads, tiles, _ = codec.plan_for(M)
    bits_rows = codec.bits_rows_for(M)
    W8 = TW // 64
    P = 8 * W8
    groups = TW // 8
    words = rand_words(rng, (200, TW), device)
    planes = pack_words_lanes_blocked(words).reshape(1600, 8, W8)
    parity_planes = gf2_matmul_panel(tiles, planes, threads).reshape(
        56, 8, 8, W8)
    # The accumulating launch over the middle of the reference's G = 3
    # sub-launches, in the plan's K tiles.
    G3 = sublaunch_count(codec._xor_cost_for(M), tiles.NT)
    lo, hi = sublaunch_bounds(tiles.NT, G3)[1:3]
    c0, c1 = lo * tiles.KT, min(hi * tiles.KT, 1600)
    acc = torch.zeros((448, 8, W8), dtype=torch.int32, device=device)
    acc_plain = acc.clone()

    cases = {
        "gf2mm_panel": (
            lambda: gf2_matmul_panel(tiles, planes, threads),
            lambda: gf2_matmul_panel_plain(tiles, planes),
            PLAIN_PANEL_REPS, panel_bound(bits_rows, 0, 1600, False, P),
        ),
        "gf2mm_panel_acc": (
            lambda: gf2_matmul_panel(tiles, planes, threads, acc=acc,
                                     k_slice=(lo, hi)),
            lambda: gf2_matmul_panel_plain(tiles, planes, acc=acc_plain,
                                           k_slice=(lo, hi)),
            PLAIN_PANEL_REPS, panel_bound(bits_rows, c0, c1, True, P),
        ),
        "pack_lanes_blocked": (
            lambda: pack_words_lanes_blocked(words),
            lambda: pack_words_lanes_blocked_plain(words),
            REPS, bound(400 * SHARD, 200 * groups * TRANSPOSE_OPS),
        ),
        "unpack_lanes_blocked": (
            lambda: unpack_words_lanes_blocked(parity_planes),
            lambda: unpack_words_lanes_blocked_plain(parity_planes),
            REPS, bound(112 * SHARD, 56 * groups * TRANSPOSE_OPS),
        ),
    }
    for name, (kernel, plain, plain_reps, (b_ms, b_by)) in cases.items():
        results[name].update(
            ms=timer.median_ms(kernel),
            plain_ms=timer.median_ms(plain, plain_reps, warmup=False),
            bound_ms=b_ms, bound_by=b_by,
        )
    results["gf2mm_panel"]["bound_xors"] = panel_xors(bits_rows, 0, 1600)
    own_floor = {"gf2mm_panel": core_floor(448, 1600, P),
                 "gf2mm_panel_acc": core_floor(448, c1 - c0, P)}

    words_ms = timer.median_ms(lambda: codec.matmul_words(M, words))
    rs = ReedSolomon(200, 56, device=str(device))
    data = [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
            for _ in range(200)]
    enc = rs.encode(data)
    lost = [None if i in set(WIDE_LOST) else s for i, s in enumerate(enc)]
    rs.reconstruct(lost)

    def host_p50(fn) -> float:
        times = []
        for _ in range(WIDE_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    encode_ms = host_p50(lambda: rs.encode(data))
    reconstruct_ms = host_p50(lambda: rs.reconstruct(lost))
    # Host-side pieces of those two calls: gathering the 200 shards into
    # one array, and the recovery matrix (a 200 x 200 inverse) that every
    # reconstruct computes before its product.
    present = [i for i, s in enumerate(lost) if s is not None][:200]
    stack_ms = host_p50(lambda: np.stack(data))
    recovery_ms = host_p50(lambda: reconstruction_matrix(
        rs.gf, rs.G, present, list(WIDE_LOST)))

    # K7 on each panel matrix at its main-path shard size, under the plan
    # the codec runs it with (the recovery matrix is already planned).
    by_matrix = {}
    for name, (Mx, tw) in panel_matrices(rs._dev).items():
        _, t, pg, _ = rs._dev.plan_for(Mx)
        br = rs._dev.bits_rows_for(Mx)
        Px = 8 * (tw // 64)
        x = rand_words(rng, (pg.n_inputs, 8, tw // 64), device)
        b_ms, b_by = panel_bound(br, 0, pg.n_inputs, False, Px)
        by_matrix[name] = {
            "shard_bytes": 4 * tw, "KT": pg.KT, "row_group": pg.RGR,
            "WC": pg.WC, "threads": t,
            "bound_xors": panel_xors(br, 0, pg.n_inputs),
            "ms": timer.median_ms(lambda: gf2_matmul_panel(pg, x, t)),
            "bound_ms": b_ms, "bound_by": b_by,
            "own_floor_ms": core_floor(pg.n_rows, pg.n_inputs, Px),
        }
    data_bytes = 200 * SHARD
    return {
        "phase": "panel_times", "reps": REPS, "wide_reps": WIDE_REPS,
        "own_floor_ms": own_floor,
        "plain_panel_reps": PLAIN_PANEL_REPS,
        "acc_k_slice": [lo, hi], "threads": threads,
        "gf2mm_panel_by_matrix": by_matrix,
        "rs_200_56_matmul_words_ms": words_ms,
        "rs_200_56_matmul_words_gbps": data_bytes / words_ms / 1e6,
        "rs_200_56_encode_ms": encode_ms,
        "rs_200_56_encode_gbps": data_bytes / encode_ms / 1e6,
        "rs_200_56_reconstruct_56_erasures_p50_ms": reconstruct_ms,
        "rs_200_56_host_stack_ms": stack_ms,
        "rs_200_56_recovery_matrix_ms": recovery_ms,
    }


def int8_bits(words: torch.Tensor) -> torch.Tensor:
    """Byte-row words (K, TW) as the (8K, 4*TW) int8 0/1 bit operand that
    K8 builds in shared memory (row 8q + b: bit b of byte row q)."""
    cols = words.view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (cols[:, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(-1, cols.shape[1]).view(torch.int8)


def phase_gf16_times(rng, device, results: dict) -> dict:
    """K8 on RS(200,56)'s GF(2^16) parity, its (28, 200) recovery matrix
    and the dense (200, 200) GF(2^8) matrix, and K10 at RS(10,4) over
    GF(2^16), 1 MiB shards, beside their bounds and plain versions; the
    GF(2^16) codec's numbers."""
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.mxu import (
        mxu_encode_tiles,
        mxu_encode_words_bits_plain,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words16,
        pack_words16_plain,
        unpack_words16,
        unpack_words16_plain,
    )

    timer = Timer(device)
    codec16 = DeviceCodec(field="gf65536", device=device)
    codec = DeviceCodec(device=device)
    mats = k8_matrices(rng)
    M = mats["rs16_200_56_parity"][1]
    k8 = {}
    words = None
    for name in ("rs16_200_56_parity", "rs16_28_200_recovery",
                 "dense_200_200_gf256"):
        field, Mx = mats[name]
        tiles = (codec16 if field == "gf65536" else codec).plan_for(Mx)[2]
        w = k8_words(rng, tiles, field, device)
        rows, cols, ncols = 8 * tiles.r, 8 * tiles.k, 4 * w.shape[1]
        b_ms, b_by = max(
            (bound((tiles.k + tiles.r) * ncols, 0)[0], "bytes"),
            (2 * rows * cols * ncols / INT8_OPS_PER_S * 1e3, "operations"))
        m2 = tiles.matrix()
        k8[name] = {
            "operand": [rows, cols], "N": tiles.N, "row_tiles": tiles.T,
            "byte_columns": ncols,
            "ms": timer.median_ms(lambda: mxu_encode_tiles(tiles, w)),
            "plain_ms": timer.median_ms(
                lambda: mxu_encode_words_bits_plain(m2, w, tiles.r, tiles.k),
                PLAIN_PANEL_REPS, warmup=False),
            "bound_ms": b_ms, "bound_by": b_by}
        if name == "rs16_200_56_parity":
            words, m2_main = w, m2
    results["mxu_gf2"].update(
        {key: k8["rs16_200_56_parity"][key]
         for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    # The SM clock and power while K8 runs: nvidia-smi sampled with ~1 s
    # of RS(200,56) launches queued.
    tiles_main = codec16.plan_for(M)[2]
    for _ in range(400):
        mxu_encode_tiles(tiles_main, words)
    k8_clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    # The tensor cores' own int8 product on bits expanded beforehand: the
    # dot alone, with no unpack, parity or repack (not the same function),
    # on row-major (3200, N) bits and on the transpose of contiguous (N,
    # 3200) bits (cuBLAS's column-major B); the faster is the yardstick.
    int_mm = {}
    for layout in ("row_major", "transposed"):
        bits = int8_bits(words)
        if layout == "transposed":
            bits = bits.t().contiguous().t()
        try:
            int_mm[layout] = timer.median_ms(
                lambda: torch._int_mm(m2_main, bits))
        except RuntimeError as exc:
            int_mm[layout] = f"failed: {exc}"
        del bits
    timed_layouts = {k: v for k, v in int_mm.items() if isinstance(v, float)}
    best = min(timed_layouts, key=timed_layouts.get) if timed_layouts else None

    groups16 = TW // 16
    words16 = rand_words(rng, (10, TW), device)
    planes = pack_words16(words16)
    parity_planes = planes[:4].contiguous()
    for name, kernel, plain, nbytes, nops in (
            ("pack_words16", lambda: pack_words16(words16),
             lambda: pack_words16_plain(words16), 20 * SHARD,
             10 * groups16 * TRANSPOSE16_OPS),
            ("unpack_words16", lambda: unpack_words16(parity_planes),
             lambda: unpack_words16_plain(parity_planes), 8 * SHARD,
             4 * groups16 * TRANSPOSE16_OPS)):
        b_ms, b_by = bound(nbytes, nops)
        results[name].update(ms=timer.median_ms(kernel),
                             plain_ms=timer.median_ms(plain),
                             bound_ms=b_ms, bound_by=b_by)

    # The codec: device-resident byte-sliced words (RS(10,4) on K1 over 20
    # byte rows, RS(200,56) on K8), the interleaved entry at RS(10,4), and
    # host arrays end to end.
    rs10 = ReedSolomon(10, 4, field="gf65536", device=str(device))
    rs200 = ReedSolomon(200, 56, field="gf65536", device=str(device))
    w20 = rand_words(rng, (20, TWB), device)
    bs10_ms = timer.median_ms(
        lambda: rs10._dev.matmul_words_bytesliced(rs10.G[10:], w20))
    bs200_ms = timer.median_ms(
        lambda: rs200._dev.matmul_words_bytesliced(M, words))
    inter10_ms = timer.median_ms(
        lambda: rs10._dev.matmul_words(rs10.G[10:], words16))

    def host_p50(fn, reps) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    codec_ms = {}
    for name, rsx, k, lost, reps in (
            ("rs16_10_4", rs10, 10, {0, 5, 11}, REPS),
            ("rs16_200_56", rs200, 200, set(WIDE_LOST), WIDE_REPS)):
        data = [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
                for _ in range(k)]
        enc = rsx.encode(data)
        holes = [None if i in lost else s for i, s in enumerate(enc)]
        rsx.reconstruct(holes)
        codec_ms[name] = (host_p50(lambda: rsx.encode(data), reps),
                          host_p50(lambda: rsx.reconstruct(holes), reps))

    # Planning a new recovery matrix: 56 other erasures (the other half of
    # each run), on a codec that has not seen it.
    G = generator_matrix(GF65536(), 200, 256, "cauchy")
    other = [i + 1 for i in WIDE_LOST]
    present = [i for i in range(256) if i not in set(other)][:200]
    R = reconstruction_matrix(rs200.gf, G, present, other)
    fresh = DeviceCodec(field="gf65536", device=device)
    t0 = time.monotonic()
    fresh._bits_for(R)
    expand_s = time.monotonic() - t0
    t0 = time.monotonic()
    check(fresh.route_for(R) == "mxu", "new (56,200) recovery routes mxu")
    fresh.plan_for(R)
    torch.cuda.synchronize()
    plan_s = expand_s + time.monotonic() - t0

    return {
        "phase": "gf16_times", "reps": REPS, "wide_reps": WIDE_REPS,
        "mxu_gf2_by_matrix": k8,
        "mxu_gf2_clocks_under_load": k8_clocks,
        "mxu_gf2_int_mm_ms": int_mm[best] if best else None,
        "mxu_gf2_int_mm_layout": best,
        "mxu_gf2_int_mm_by_layout": int_mm,
        "mxu_gf2_int_mm_note": ("torch._int_mm(M2, bits) on bits expanded "
                                "beforehand: the dot alone"),
        "rs16_10_4_matmul_words_bytesliced_ms": bs10_ms,
        "rs16_10_4_matmul_words_bytesliced_gbps": 10 * SHARD / bs10_ms / 1e6,
        "rs16_200_56_matmul_words_bytesliced_ms": bs200_ms,
        "rs16_200_56_matmul_words_bytesliced_gbps":
            200 * SHARD / bs200_ms / 1e6,
        "rs16_10_4_matmul_words_interleaved_ms": inter10_ms,
        "rs16_10_4_encode_ms": codec_ms["rs16_10_4"][0],
        "rs16_10_4_encode_gbps": 10 * SHARD / codec_ms["rs16_10_4"][0] / 1e6,
        "rs16_10_4_reconstruct_3_erasures_p50_ms": codec_ms["rs16_10_4"][1],
        "rs16_200_56_encode_ms": codec_ms["rs16_200_56"][0],
        "rs16_200_56_encode_gbps":
            200 * SHARD / codec_ms["rs16_200_56"][0] / 1e6,
        "rs16_200_56_reconstruct_56_erasures_p50_ms":
            codec_ms["rs16_200_56"][1],
        "rs16_recovery_expand_seconds": expand_s,
        "rs16_recovery_plan_seconds": plan_s,
    }


def stream_times(rng, timer, device, cases) -> dict:
    """Streaming encode and decode GB/s from host bytes for each of
    ``cases`` ((name, k, r, stream bytes, lost shards, field), 1 MiB
    shards), best of STREAM_REPS after a warm-up that plans the parity and
    recovery matrices, with the device's share of the wall time: the
    product alone on one chunk, device-resident, times the chunks."""
    from noise_ec_tpu_torch.parallel import StreamingDecoder, StreamingEncoder

    streams = {}
    for name, k, r, size, lost, field in cases:
        enc = StreamingEncoder(k, r, chunk_bytes=k * SHARD, field=field)
        dec = StreamingDecoder(k, r, field=field)
        present = [i for i in range(k + r) if i not in lost]
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        chunks = list(enc.encode_bytes(data))  # plans the parity matrix
        rows = list(degraded_rows(chunks, present))
        list(dec.reconstruct_stream(iter(rows[:1]), present))  # and recovery
        enc_s, dec_s = [], []
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            chunks = list(enc.encode_bytes(data))
            enc_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            list(dec.reconstruct_stream(iter(rows), present))
            dec_s.append(time.perf_counter() - t0)
        w = rand_words(rng, (1, k, TW), device)
        wp = rand_words(rng, (1, len(present), TW), device)
        enc_dev_ms = timer.median_ms(
            lambda: enc.codec.device_codec().matmul_words_batch(
                enc.codec.parity_matrix, w))
        dec_dev_ms = timer.median_ms(
            lambda: dec.codec.reconstruct_batch_words(wp, present))
        n = len(chunks)
        streams[name] = {
            "stream_bytes": size, "chunks": n, "erasures": list(lost),
            "encode_seconds": enc_s, "decode_seconds": dec_s,
            "encode_gbps": size / min(enc_s) / 1e9,
            "decode_gbps": size / min(dec_s) / 1e9,
            "encode_product_ms_per_chunk": enc_dev_ms,
            "decode_product_ms_per_chunk": dec_dev_ms,
            "encode_device_share": n * enc_dev_ms / 1e3 / min(enc_s),
            "decode_device_share": n * dec_dev_ms / 1e3 / min(dec_s),
        }
        del chunks, rows, data
    return streams


def phase_split_times(rng, device, results: dict) -> dict:
    """K5 at RS(50,20), 1 MiB shards, beside its bound, its own operation
    floor and its plain version, and on the (20, 50) recovery matrix;
    beside it the K9 -> K11 -> K9 chain on the same matrix and words (a
    yardstick from the same card); the codec on the same parity through K5
    and through the forced pipeline; K1 at its plan against K5 on RS(4,2),
    RS(10,4), RS(17,3), RS(30,10), RS(40,12) and RS(50,20) (the evidence
    for the planner's order); the seconds to plan a new RS(50,20) recovery
    matrix, and those of the factoring the K1-first planner ran for it;
    streaming encode and decode GB/s from host bytes at RS(17,3) and
    RS(50,20), with the device's share of the wall time."""
    from noise_ec_tpu_torch.gf import expand_generator_masks
    from noise_ec_tpu_torch.matrix import (
        generator_matrix,
        reconstruction_matrix,
    )
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_plan,
        fused_split_encode_words,
        fused_split_encode_words_plain,
    )
    from noise_ec_tpu_torch.ops.gf2mm import gf2_matmul_dense
    from noise_ec_tpu_torch.ops.network import compile_network, compile_split
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_sublane,
        unpack_words_sublane,
    )

    timer = Timer(device)
    codec = DeviceCodec(device=device)
    gf, G, R = rs_50_20()
    groups = TW // 8

    def matrix_bound(M):
        """One bound per matrix, whichever kernel runs it: bytes, k rows in
        and r out; operations, the XORs of the whole network factored
        uncapped (no slicing, no accumulates) and one transpose per row,
        on every 8-word group. A plan that factors worse does not loosen
        its own bound. Returns (bound_ms, bound_by, bound_xors)."""
        r, k = M.shape
        xors = compile_network(codec.bits_rows_for(M), 8 * k).cost
        return bound((k + r) * SHARD, xors * groups
                     + (k + r) * groups * TRANSPOSE_OPS) + (xors,)

    def split_floor(r, k):
        """K5's own floor: the core's dense product and the transposes."""
        return (core_floor(8 * r, 8 * k, groups)
                + (k + r) * groups * TRANSPOSE_OPS / INT_OPS_PER_S * 1e3)

    M = G[50:]
    _, threads, tiles, _ = codec.plan_for(M)
    words = rand_words(rng, (50, TW), device)
    b_ms, b_by, b_xors = matrix_bound(M)
    results["fused_split"].update(
        ms=timer.median_ms(
            lambda: fused_split_encode_words(tiles, words, 20, threads)),
        plain_ms=timer.median_ms(
            lambda: fused_split_encode_words_plain(tiles, words, 20, 512),
            PLAIN_PANEL_REPS, warmup=False),
        bound_ms=b_ms, bound_by=b_by, bound_xors=b_xors, threads=threads,
        ksl=tiles.KT // 8, WC=tiles.WC,
    )
    _, rt, rtiles, _ = codec.plan_for(R)
    r_ms, r_by, r_xors = matrix_bound(R)
    recovery = {"threads": rt, "ksl": rtiles.KT // 8,
                "bound_ms": r_ms, "bound_by": r_by, "bound_xors": r_xors,
                "own_floor_ms": split_floor(20, 50),
                "ms": timer.median_ms(
                    lambda: fused_split_encode_words(rtiles, words, 20, rt))}
    words_ms = timer.median_ms(lambda: codec.matmul_words(M, words))
    pipe_ms = timer.median_ms(
        lambda: codec.matmul_words(M, words, tier="pipeline"))

    # The yardstick: the same product unfused, K9 pack -> K11 on the
    # (160, 400) select masks -> K9 unpack.
    masks = torch.from_numpy(expand_generator_masks(gf, M)).to(device)
    W = TW // 8

    def chain():
        planes = pack_words_sublane(words).reshape(400, W)
        return unpack_words_sublane(
            gf2_matmul_dense(masks, planes).reshape(20, 8, W))

    check(torch.equal(chain(), fused_split_encode_words(tiles, words, 20,
                                                        threads)),
          "K9 -> K11 -> K9 vs K5 on RS(50,20)")
    chain_ms = timer.median_ms(chain)

    k1_vs_k5 = {}
    for k, r in ((4, 2), (10, 4), (17, 3), (30, 10), (40, 12), (50, 20)):
        Mx = generator_matrix(gf, k, k + r, "cauchy")[k:]
        kind, t5, p5, _ = codec.plan_for(Mx)
        check(kind == "split", f"RS({k},{r}) plans onto K5")
        w = rand_words(rng, (k, TW), device)
        bms, bby, bxors = matrix_bound(Mx)
        row = {"bound_ms": bms, "bound_by": bby, "bound_xors": bxors,
               "k5": {"threads": t5, "ksl": p5.KT // 8,
                      "own_floor_ms": split_floor(r, k),
                      "ms": timer.median_ms(
                          lambda: fused_split_encode_words(p5, w, r, t5))}}
        if fused_plan(codec.bits_rows_for(Mx), 8 * k) is not None:
            _, t1, p1, _ = codec.plan_for(Mx, "fused")
            check(torch.equal(fused_encode_words(p1, w, r, t1),
                              fused_split_encode_words(p5, w, r, t5)),
                  f"RS({k},{r}) K1 vs K5")
            row["k1"] = {"threads": t1, **xornet_plan(t1, p1, TW // 8),
                         "ms": timer.median_ms(
                             lambda: fused_encode_words(p1, w, r, t1))}
        k1_vs_k5[f"RS({k},{r})"] = row

    # The same race at the main path's small shards: the plugin's RS(4,2)
    # on a 64 KiB message (16 KiB shards) and 64 KiB FEC and hardware-check
    # shares. A words entry pads a shard to the lane quantum (32 KiB), so
    # the kernels see 8,192 words at 16 and 32 KiB shards and 16,384 at
    # 64 KiB. K5's default K split applies (a memset and atomic XORs where
    # the grid is narrow).
    k1_vs_k5_small = {}
    for k, r in ((4, 2), (10, 4), (17, 3)):
        Mx = generator_matrix(gf, k, k + r, "cauchy")[k:]
        _, t5, p5, _ = codec.plan_for(Mx)
        _, t1, p1, _ = codec.plan_for(Mx, "fused")
        for tw in (8192, 16384):
            w = rand_words(rng, (k, tw), device)
            check(torch.equal(fused_encode_words(p1, w, r, t1),
                              fused_split_encode_words(p5, w, r, t5)),
                  f"RS({k},{r}) K1 vs K5 at {tw} words")
            k1_vs_k5_small[f"RS({k},{r}) {4 * tw} B"] = {
                "k1": xornet_plan(t1, p1, tw // 8),
                "k1_ms": timer.median_ms(
                    lambda: fused_encode_words(p1, w, r, t1)),
                "k5_ms": timer.median_ms(
                    lambda: fused_split_encode_words(p5, w, r, t5))}

    # Planning a new RS(50,20) recovery matrix (ten other data and parity
    # shards lost) on a codec that has not seen it, and the factoring the
    # K1-first planner ran before it fell through to K5: K1's whole
    # network (and its capped retries), then K5's 8- and 16-row slices.
    other = [i + 1 for i in SPLIT_LOST]
    present = [i for i in range(70) if i not in set(other)][:50]
    Rn = reconstruction_matrix(gf, G, present, other)
    fresh = DeviceCodec(device=device)
    t0 = time.monotonic()
    check(fresh.plan_for(Rn)[0] == "split", "new recovery plans onto K5")
    torch.cuda.synchronize()
    plan_s = time.monotonic() - t0
    br = fresh.bits_rows_for(Rn)
    t0 = time.monotonic()
    k1_plan = fused_plan(br, 400) is not None
    for ksl in (8, 16):
        compile_split(br, 50, ksl)
    factoring_s = time.monotonic() - t0

    streams = stream_times(rng, timer, device, (
        ("rs_17_3", 17, 3, STREAM_17_3, LOST_17_3, "gf256"),
        ("rs_50_20", 50, 20, STREAM_50_20, SPLIT_LOST, "gf256")))
    return {
        "phase": "split_times", "reps": REPS, "stream_reps": STREAM_REPS,
        "rs_50_20_recovery_k5": recovery,
        "rs_50_20_matmul_words_ms": words_ms,
        "rs_50_20_matmul_words_gbps": 50 * SHARD / words_ms / 1e6,
        "rs_50_20_matmul_words_pipeline_ms": pipe_ms,
        "rs_50_20_matmul_words_bound_ms": b_ms,
        "rs_50_20_k9_k11_k9_ms": chain_ms,
        "rs_50_20_new_recovery_plan_seconds": plan_s,
        "rs_50_20_k1_first_factoring_seconds": factoring_s,
        "rs_50_20_new_recovery_k1_plan": k1_plan,
        "fused_split_own_floor_ms": split_floor(20, 50),
        "k1_vs_k5": k1_vs_k5, "k1_vs_k5_small": k1_vs_k5_small,
        "streams": streams,
    }


def phase_words16_times(rng, device, results: dict) -> dict:
    """The m = 16 forms at 1 MiB shards beside their bounds and plain
    versions: K5@16 on GF(2^16) RS(30,10)'s parity (the stream's matrix),
    K1@16 on RS(10,4) (forced), the lane pack at RS(10,4)'s shapes (10 rows
    in, 4 out) and the blocked pack at RS(50,20)'s (50 in, 20 out). The
    interleaved words entry per tier at RS(10,4) and RS(30,10), beside the
    byte-sliced entry on the same matrix and the matrix's bound, and at
    RS(10,4) beside K10 -> K4 -> K10, the route the entry took before the
    m = 16 forms. Stream encode and decode GB/s from host bytes for the
    two GF(2^16) streams, with the device's share of the wall time."""
    from noise_ec_tpu_torch.gf import GF65536
    from noise_ec_tpu_torch.matrix import generator_matrix
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import (
        fused_encode_words,
        fused_encode_words_plain,
        fused_plan,
        fused_split_encode_words,
        fused_split_encode_words_plain,
    )
    from noise_ec_tpu_torch.ops.gf2mm import gf2_matmul_sparse
    from noise_ec_tpu_torch.ops.network import compile_network
    from noise_ec_tpu_torch.ops.pack import (
        lane_tl,
        pack_words16,
        pack_words_lanes,
        pack_words_lanes_blocked,
        pack_words_lanes_blocked_plain,
        pack_words_lanes_plain,
        unpack_words16,
        unpack_words_lanes,
        unpack_words_lanes_blocked,
        unpack_words_lanes_blocked_plain,
        unpack_words_lanes_plain,
        words16_to_bytesliced,
    )

    timer = Timer(device)
    codec16 = DeviceCodec(field="gf65536", device=device)
    gf16 = GF65536()
    tl = lane_tl(TW, 16)  # 512 at 1 MiB shards

    def matrix_bound16(M):
        """The matrix's bound at 16 planes a symbol, whichever kernel runs
        it: bytes, k rows in and r out; operations, the XORs of the whole
        network factored uncapped on every plane word and one 16-word
        transpose (four delta-swap rounds) per row and group. Returns
        (bound_ms, bound_by, bound_xors)."""
        r, k = M.shape
        xors = compile_network(codec16.bits_rows_for(M), 16 * k).cost
        return bound((k + r) * SHARD, xors * GROUPS16
                     + (k + r) * GROUPS16 * TRANSPOSE16_OPS) + (xors,)

    mats = {(k, r): generator_matrix(gf16, k, k + r, "cauchy")[k:]
            for k, r in ((10, 4), (30, 10))}
    words = {key: rand_words(rng, (key[0], TW), device) for key in mats}

    # K5@16 at RS(30,10), K1@16 at RS(10,4).
    M, w = mats[(30, 10)], words[(30, 10)]
    _, threads, tiles, _ = codec16.plan_for(M)
    b_ms, b_by, b_xors = matrix_bound16(M)
    results["fused_split16"].update(
        ms=timer.median_ms(
            lambda: fused_split_encode_words(tiles, w, 10, threads, m=16)),
        plain_ms=timer.median_ms(
            lambda: fused_split_encode_words_plain(tiles, w, 10, tl, 16),
            PLAIN_PANEL_REPS, warmup=False),
        bound_ms=b_ms, bound_by=b_by, bound_xors=b_xors, threads=threads,
        ksl=tiles.KT // 16, WC=tiles.WC, matrix="GF(2^16) RS(30,10) parity")
    M, w = mats[(10, 4)], words[(10, 4)]
    _, t1, p1, _ = codec16.plan_for(M, "fused")
    b_ms, b_by, b_xors = matrix_bound16(M)
    results["fused_encode16"].update(
        ms=timer.median_ms(lambda: fused_encode_words(p1, w, 4, t1, m=16)),
        plain_ms=timer.median_ms(
            lambda: fused_encode_words_plain(p1, w, 4, tl, 16)),
        bound_ms=b_ms, bound_by=b_by, bound_xors=b_xors, threads=t1,
        **xornet_plan(t1, p1, GROUPS16), matrix="GF(2^16) RS(10,4) parity")

    # The lane pack at RS(10,4)'s shapes (the forced pipeline's), at the
    # port's TL; the blocked pack at RS(50,20)'s.
    planes = pack_words_lanes(w, tl, 16)
    parity_planes = planes[:4].contiguous()
    w50 = rand_words(rng, (50, TW), device)
    bplanes = pack_words_lanes_blocked(w50, 16)
    bparity = bplanes[:20].contiguous()
    for name, kernel, plain, rows in (
            ("pack_lanes16", lambda: pack_words_lanes(w, tl, 16),
             lambda: pack_words_lanes_plain(w, tl, 16), 10),
            ("unpack_lanes16", lambda: unpack_words_lanes(parity_planes, tl),
             lambda: unpack_words_lanes_plain(parity_planes, tl), 4),
            ("pack_lanes_blocked16",
             lambda: pack_words_lanes_blocked(w50, 16),
             lambda: pack_words_lanes_blocked_plain(w50, 16), 50),
            ("unpack_lanes_blocked16",
             lambda: unpack_words_lanes_blocked(bparity),
             lambda: unpack_words_lanes_blocked_plain(bparity), 20)):
        b_ms, b_by = bound(2 * rows * SHARD,
                           rows * GROUPS16 * TRANSPOSE16_OPS)
        results[name].update(ms=timer.median_ms(kernel),
                             plain_ms=timer.median_ms(plain),
                             bound_ms=b_ms, bound_by=b_by, rows=rows)
    del bplanes, bparity, w50

    # The interleaved entry per tier, beside the byte-sliced entry.
    entry = {}
    for (k, r), M in mats.items():
        w = words[(k, r)]
        wb = words16_to_bytesliced(w)
        b_ms, b_by, b_xors = matrix_bound16(M)
        row = {"bound_ms": b_ms, "bound_by": b_by, "bound_xors": b_xors,
               "bytesliced_ms": timer.median_ms(
                   lambda: codec16.matmul_words_bytesliced(M, wb))}
        for tier in (None, "fused", "pipeline"):
            if tier == "fused" and fused_plan(codec16.bits_rows_for(M),
                                              16 * k) is None:
                row["fused_ms"] = None  # no K1 plan holds the network
                continue
            row[f"{tier or 'planned'}_ms"] = timer.median_ms(
                lambda: codec16.matmul_words(M, w, tier=tier))
        row["planned_kind"] = codec16.plan_for(M)[0]
        row["planned_over_bytesliced"] = row["planned_ms"] / row[
            "bytesliced_ms"]
        if (k, r) == (10, 4):
            _, tp, prog, _ = codec16.plan_for(M, "pipeline")

            def tier3():
                x = pack_words16(w).reshape(160, 8, GROUPS16 // 8)
                return unpack_words16(
                    gf2_matmul_sparse(prog, x, tp).reshape(4, 16, GROUPS16))

            check(torch.equal(tier3(), codec16.matmul_words(M, w)),
                  "K10 -> K4 -> K10 vs the interleaved entry at RS(10,4)")
            row["k10_k4_k10_ms"] = timer.median_ms(tier3)
        entry[f"RS({k},{r})"] = row

    streams = stream_times(rng, timer, device, (
        ("rs16_30_10", 30, 10, STREAM16_30_10, LOST16_30_10, "gf65536"),
        ("rs16_50_20", 50, 20, STREAM_50_20, SPLIT_LOST, "gf65536")))
    return {"phase": "words16_times", "reps": REPS,
            "stream_reps": STREAM_REPS, "interleaved_by_tier": entry,
            "streams": streams}


def phase_dense_times(rng, device, results: dict) -> dict:
    """K9 at RS(10,4), 1 MiB shards (pack 10 rows, unpack the 4 parity
    rows), and K11 and K12 on RS(10,4)'s (32, 80) masks over 32,768-word
    planes, each beside its bound and its plain version; K11 also on
    RS(50,20)'s (160, 400) masks, the wide runtime-matrix use. K11's and
    K12's rows name their launch (:func:`dense_plan`)."""
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.ops.gf2mm import (
        gf2_matmul_dense,
        gf2_matmul_dense_plain,
        gf2_matmul_dense_tiled,
        gf2_matmul_dense_tiled_plain,
    )
    from noise_ec_tpu_torch.ops.pack import (
        pack_words_sublane,
        pack_words_sublane_plain,
        unpack_words_sublane,
        unpack_words_sublane_plain,
    )

    timer = Timer(device)
    groups = TW // 8
    words = rand_words(rng, (10, TW), device)
    planes = pack_words_sublane(words)
    parity_planes = planes[:4].contiguous()
    gf = GF256()
    m = torch.from_numpy(dense_masks(gf, 10, 4)[1]).to(device)
    flat = planes.reshape(80, W_PLANE)
    tiled = flat.reshape(80, 8, W_PLANE // 8)
    cases = {
        "pack_sublane": (
            lambda: pack_words_sublane(words),
            lambda: pack_words_sublane_plain(words),
            bound(20 * SHARD, 10 * groups * TRANSPOSE_OPS)),
        "unpack_sublane": (
            lambda: unpack_words_sublane(parity_planes),
            lambda: unpack_words_sublane_plain(parity_planes),
            bound(8 * SHARD, 4 * groups * TRANSPOSE_OPS)),
        "gf2mm_dense": (
            lambda: gf2_matmul_dense(m, flat),
            lambda: gf2_matmul_dense_plain(m, flat),
            dense_bound(32, 80, W_PLANE)),
        "gf2mm_dense_tiled": (
            lambda: gf2_matmul_dense_tiled(m, tiled),
            lambda: gf2_matmul_dense_tiled_plain(m, tiled),
            dense_bound(32, 80, W_PLANE)),
    }
    for name, (kernel, plain, (b_ms, b_by)) in cases.items():
        results[name].update(
            ms=timer.median_ms(kernel), plain_ms=timer.median_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
        )
    for name in ("gf2mm_dense", "gf2mm_dense_tiled"):
        results[name]["launch"] = dense_plan(m, flat)
    m50 = torch.from_numpy(dense_masks(gf, 50, 20)[1]).to(device)
    planes50 = rand_words(rng, (400, W_PLANE), device)
    b_ms, b_by = dense_bound(160, 400, W_PLANE)
    wide = {"ms": timer.median_ms(lambda: gf2_matmul_dense(m50, planes50)),
            "plain_ms": timer.median_ms(
                lambda: gf2_matmul_dense_plain(m50, planes50)),
            "bound_ms": b_ms, "bound_by": b_by,
            "launch": dense_plan(m50, planes50)}
    return {"phase": "dense_times", "reps": REPS,
            "gf2mm_dense_rs_50_20_masks": wide}


def phase_fec_times(rng, device) -> dict:
    """FEC(10, 14) decode at 1 MiB shares, median of FEC_REPS warm decodes
    on the host clock, per :func:`fec_cases` case and route (the host
    route's syndrome, row products and decode1 fold on the native shim,
    with its calls counted per case), and GF(2^16)
    FEC(10, 14) with one wholly corrupt share on the device route; beside
    each device-route case, the CUDA-event time of its product on the
    card alone, from words already there: the decode1 fold
    (``decode1_words``, ``decode1_words_bytesliced``) or the [A | I]
    syndrome."""
    from noise_ec_tpu_torch.codec import FEC
    from noise_ec_tpu_torch.ops.pack import pack_u16_bytesliced

    timer = Timer(device)
    payload = rng.integers(0, 256, size=10 * SHARD, dtype=np.uint8).tobytes()

    def host_p50(fn) -> float:
        check(fn() == payload, "FEC decode returns the payload")
        times = []
        for _ in range(FEC_REPS):
            t0 = time.perf_counter()
            got = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            check(got == payload, "FEC decode returns the payload")
        return statistics.median(times)

    fecs = {route: FEC(10, 14, bw_route=route)
            for route in ("device", "host")}
    shares = fecs["device"].encode_shares(payload)
    cases = fec_cases(rng, shares, 10)
    dev = fecs["device"]._rs._dev
    A = fecs["device"]._golden.G[10:]  # the basis is the data rows
    aug = np.concatenate([A, np.eye(4, dtype=np.uint8)], axis=1)

    def device_words(case) -> torch.Tensor:
        rows = np.stack([np.frombuffer(s.data, np.uint8) for s in case])
        return torch.from_numpy(rows.view(np.int32)).to(dev.device)

    w_whole = device_words(cases["whole_share"])
    w_scat = device_words(cases["scattered"])
    products = {
        "in_order_k": None,
        "whole_share": lambda: dev.decode1_words(A, 1, w_whole),
        "scattered": lambda: dev.matmul_words(aug, w_scat),
    }
    # The host route runs on the native shim (matrix/bw.py): count its
    # calls per case, so the line says which of its kernels ran.
    from noise_ec_tpu_torch import shim

    shim_calls: dict = {}
    for fn in ("gf_syndrome_rows", "gf_matmul_rows", "gf_decode1_fused"):
        real = getattr(shim, fn)

        def counted(*a, _real=real, _fn=fn, **kw):
            shim_calls[_fn] = shim_calls.get(_fn, 0) + 1
            return _real(*a, **kw)

        setattr(shim, fn, counted)
    out = {}
    try:
        for name, case in cases.items():
            device_p50 = host_p50(lambda: fecs["device"].decode(case))
            shim_calls.clear()
            host_p50_ms = host_p50(lambda: fecs["host"].decode(case))
            out[name] = {
                "device_route_p50_ms": device_p50,
                "host_route_p50_ms": host_p50_ms,
                "host_route_shim_calls": dict(shim_calls),
                "device_product_ms": (timer.median_ms(products[name])
                                      if products[name] else None),
            }
            if name != "in_order_k":
                check(shim_calls, f"{name}: the host route ran on the shim")
    finally:
        for fn in ("gf_syndrome_rows", "gf_matmul_rows", "gf_decode1_fused"):
            setattr(shim, fn, getattr(shim.binding, fn))

    fec16 = FEC(10, 14, field="gf65536", bw_route="device")
    case16 = fec_cases(rng, fec16.encode_shares(payload), 10)["whole_share"]
    dev16 = fec16._rs._dev
    rows16 = np.stack([np.frombuffer(s.data, "<u2") for s in case16])
    w28 = torch.from_numpy(
        pack_u16_bytesliced(rows16).view(np.int32)).to(dev16.device)
    A16 = fec16._golden.G[10:]
    out["gf65536_whole_share"] = {
        "device_route_p50_ms": host_p50(lambda: fec16.decode(case16)),
        "device_product_ms": timer.median_ms(
            lambda: dev16.decode1_words_bytesliced(A16, 1, w28)),
    }
    return {"phase": "fec_times", "reps": FEC_REPS,
            "payload_bytes": len(payload), "shares": 14, "cases": out}


def phase_panel_sweep(rng, device) -> dict:
    """K7 under other tile shapes than the planner's (K tile KB, rows a
    block RB, column warps WC) on each matrix of :func:`panel_matrices`,
    and K5 under other shapes (phase rows ksl, WC) on RS(50,20)'s parity
    at 1 MiB shards: the evidence for the planners' shapes. Every shape's
    product is held equal to the first."""
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.fused import fused_split_encode_words
    from noise_ec_tpu_torch.ops.gf2tile import (
        MAX_WARPS,
        ROW_BLOCK,
        build_tiles,
        row_groups,
    )
    from noise_ec_tpu_torch.ops.network import SMEM_BYTES
    from noise_ec_tpu_torch.ops.panel import gf2_matmul_panel

    timer = Timer(device)
    codec = DeviceCodec(device=device)
    rows = []
    for name, (M, tw) in panel_matrices(codec).items():
        bits_rows = codec.bits_rows_for(M)
        C = 8 * M.shape[1]
        nrb = -(-len(bits_rows) // ROW_BLOCK)
        planes = rand_words(rng, (C, 8, tw // 64), device)
        want = None
        for KB, WR, WC in itertools.product(
                (8, 16, 32, 64), sorted({row_groups(nrb * ROW_BLOCK)[1],
                                         -(-nrb // 2)}), (1, 2, 4)):
            if WR * WC > MAX_WARPS:
                continue
            tiles = build_tiles(bits_rows, C, KB, WR=WR, WC=WC)
            if tiles.ring_bytes > SMEM_BYTES:
                continue
            tiles = tiles.to(device)
            out = gf2_matmul_panel(tiles, planes, tiles.threads)
            if want is None:
                want = out
            check(torch.equal(out, want),
                  f"sweep {name} KB={KB} WR={WR} WC={WC}")
            rows.append({
                "kernel": "K7", "matrix": name, "KB": KB, "RB": tiles.RGR,
                "WC": WC, "threads": tiles.threads,
                "ring_bytes": tiles.ring_bytes, "ms": timer.median_ms(
                    lambda: gf2_matmul_panel(tiles, planes, tiles.threads),
                    5)})
    gf, G, _ = rs_50_20()
    bits_rows = codec.bits_rows_for(G[50:])
    words = rand_words(rng, (50, TW), device)
    want = None
    for ksl, WC in itertools.product((2, 4, 8, 16), (1, 2, 3)):
        tiles = build_tiles(bits_rows, 400, 8 * ksl, WC=WC)
        if tiles.ring_bytes > SMEM_BYTES:
            continue
        tiles = tiles.to(device)
        out = fused_split_encode_words(tiles, words, 20, tiles.threads)
        if want is None:
            want = out
        check(torch.equal(out, want), f"sweep K5 ksl={ksl} WC={WC}")
        rows.append({
            "kernel": "K5", "matrix": "RS(50,20) parity", "ksl": ksl,
            "WC": WC, "threads": tiles.threads,
            "ring_bytes": tiles.ring_bytes,
            "ms": timer.median_ms(lambda: fused_split_encode_words(
                tiles, words, 20, tiles.threads), 5)})
    return {"phase": "panel_sweep", "rows": rows}


def device_us(fn, flush: torch.Tensor, name: str, reps: int = 10) -> float:
    """Device time a call of the kernels whose name holds ``name``, from a
    torch.profiler trace of ``reps`` calls each after an L2 flush
    (microseconds); 0.0 if three traces in a row record none of them (a
    trace can come back without device events). Taken after the event
    timings: the profiler's teardown slows the host for a while."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if name in ev.key:
                total += t
        if total:
            break
    return total / reps


def phase_dense_sweep(rng, device) -> dict:
    """K11 under other launch shapes than the planner's (K tile KT, column
    warps WC, warps along K WK, K split) on RS(10,4)'s (32, 80) and
    RS(50,20)'s (160, 400) select masks over 32,768-word planes and on the
    (32, 80) masks over 262,144-word planes: the evidence for
    ``dense_shape``'s constants, each shape held equal to the plain
    version. Then the probes of ``csrc/dense_probe.cu`` at the planner's
    shape on the first two: K11 whole, without its product (the copies
    alone), without its copies (the product on stale words), with only the
    plane copies, and without the plane copies, by CUDA events and by
    torch.profiler's device time."""
    from noise_ec_tpu_torch.gf import GF256
    from noise_ec_tpu_torch.ops import _build
    from noise_ec_tpu_torch.ops.gf2mm import (
        _dense,
        dense_copy_words,
        gf2_matmul_dense_plain,
    )
    from noise_ec_tpu_torch.ops.gf2tile import (
        DENSE_KT,
        MAX_WARPS,
        dense_shape,
        dense_smem_bytes,
        row_groups,
    )
    from noise_ec_tpu_torch.ops.network import SMEM_BYTES

    timer = Timer(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gf = GF256()
    m10 = torch.from_numpy(dense_masks(gf, 10, 4)[1]).to(device)
    m50 = torch.from_numpy(dense_masks(gf, 50, 20)[1]).to(device)
    cases = {"(32,80) x 32768": (m10, W_PLANE, DENSE_KT, (1, 2)),
             "(160,400) x 32768": (m50, W_PLANE, DENSE_KT, (1, 2)),
             "(32,80) x 262144": (m10, 8 * W_PLANE, (16, 32), (1,))}
    rows, operands = [], {}
    for name, (m, W, kts, splits) in cases.items():
        R, C = m.shape
        planes = rand_words(rng, (C, W), device)
        want = gf2_matmul_dense_plain(m, planes)
        operands[name] = (m, planes)
        WR = row_groups(R)[1]
        for KT, WC, WK, ks in itertools.product(kts, (1, 2, 3, 4), (1, 2, 4),
                                                splits):
            if (WR * WC * WK > MAX_WARPS
                    or dense_smem_bytes(KT, WR, WC, WK) > SMEM_BYTES):
                continue
            shape = (KT, WR, WC, WK, ks)
            check(torch.equal(_dense(m, planes, "gf2mm_dense", shape), want),
                  f"dense sweep {name} {shape}")
            rows.append({"masks": name, "KT": KT, "WC": WC, "WK": WK,
                         "ksplit": ks, "ms": timer.median_ms(
                             lambda: _dense(m, planes, "gf2mm_dense", shape),
                             5)})
        rows.append({"masks": name, "planned": dense_shape(R, C, W, sms)})
    lib = _build.probe_library()
    drops = {"whole": 0, "copies, no product": 1,
             "product, no copies": 2 | 4, "plane copies only": 1 | 4,
             "masks and product, no plane copies": 2}

    def prober(m, planes, shape, drop):
        (R, C), W = m.shape, planes.shape[1]

        def probe():
            alloc = torch.zeros if shape[-1] > 1 else torch.empty
            out = alloc((R, W), dtype=torch.int32, device=device)
            _build.launch("ec_dense_probe", planes, _build.ptr(m),
                          _build.ptr(planes), _build.ptr(out), R, C, W,
                          m.stride(0), planes.stride(0), *shape,
                          dense_copy_words(planes), drop, lib=lib)
            return out
        return probe

    probes = []
    for name in list(cases)[:2]:
        m, planes = operands[name]
        shape = dense_shape(*m.shape, planes.shape[1], sms)
        check(torch.equal(prober(m, planes, shape, 0)(),
                          _dense(m, planes, "gf2mm_dense")),
              f"dense probe {name} whole vs K11")
        for what, drop in drops.items():
            fn = prober(m, planes, shape, drop)
            # Without its product a probe stores zeros: the drop took.
            check(not drop & 1 or not fn().any(),
                  f"dense probe {name} {what} leaves the product out")
            probes.append({"masks": name, "shape": list(shape),
                           "probe": what, "fn": fn,
                           "ms": timer.median_ms(fn)})
    for row in probes:
        row["device_us"] = device_us(row.pop("fn"), timer.flush,
                                     "masked_kernel")
    return {"phase": "dense_sweep", "rows": rows, "probes": probes,
            "bound_ms": {name: dense_bound(*operands[name][0].shape,
                                           operands[name][1].shape[1])[0]
                         for name in cases}}


def pack_cases(rng, device) -> dict:
    """The twelve pack rows of the kernels table at the shapes the times
    phases take them (1 MiB shards): name -> (the call, its input, the
    profiler name of its kernel, rows). K2/K3 and their m = 16 forms at
    RS(10,4)'s shapes (10 rows in, 4 out), K6 at RS(200,56)'s (200, 56),
    K6@16 at RS(50,20)'s (50, 20), K9 and K10 at RS(10,4)'s."""
    from noise_ec_tpu_torch.ops.pack import (
        blocked_lane_tl,
        pack_words16,
        pack_words_lanes,
        pack_words_lanes_blocked,
        pack_words_sublane,
        unpack_words16,
        unpack_words_lanes,
        unpack_words_lanes_blocked,
        unpack_words_sublane,
    )

    def words(rows):
        return rand_words(rng, (rows, TW), device)

    def lanes(rows, m):
        return rand_words(rng, (rows, m, 8, TW // (8 * m)), device)

    w10, w200, w50 = words(10), words(200), words(50)
    l4, l4_16 = lanes(4, 8), lanes(4, 16)
    b56, b20 = lanes(56, 8), lanes(20, 16)
    check(blocked_lane_tl(TW) == 256 and blocked_lane_tl(TW, 16) == 128,
          "the blocked TLs at 1 MiB shards")
    g4 = rand_words(rng, (4, 8, TW // 8), device)
    g4_16 = rand_words(rng, (4, 16, TW // 16), device)
    return {
        "pack_lanes": (lambda: pack_words_lanes(w10, 512), w10,
                       "lanes_kernel", 10),
        "unpack_lanes": (lambda: unpack_words_lanes(l4, 512), l4,
                         "lanes_kernel", 4),
        "pack_lanes16": (lambda: pack_words_lanes(w10, 512, 16), w10,
                         "lanes_kernel", 10),
        "unpack_lanes16": (lambda: unpack_words_lanes(l4_16, 512), l4_16,
                           "lanes_kernel", 4),
        "pack_lanes_blocked": (lambda: pack_words_lanes_blocked(w200), w200,
                               "lanes_kernel", 200),
        "unpack_lanes_blocked": (lambda: unpack_words_lanes_blocked(b56), b56,
                                 "lanes_kernel", 56),
        "pack_lanes_blocked16": (lambda: pack_words_lanes_blocked(w50, 16),
                                 w50, "lanes_kernel", 50),
        "unpack_lanes_blocked16": (lambda: unpack_words_lanes_blocked(b20),
                                   b20, "lanes_kernel", 20),
        "pack_sublane": (lambda: pack_words_sublane(w10), w10,
                         "groups_kernel", 10),
        "unpack_sublane": (lambda: unpack_words_sublane(g4), g4,
                           "groups_kernel", 4),
        "pack_words16": (lambda: pack_words16(w10), w10, "groups_kernel", 10),
        "unpack_words16": (lambda: unpack_words16(g4_16), g4_16,
                           "groups_kernel", 4),
    }


def phase_pack_sweep(rng, device) -> dict:
    """The twelve packs (:func:`pack_cases`) by CUDA events and by
    torch.profiler's device time, each beside a copy of its input's bytes
    (``torch.empty_like(src).copy_(src)``, the profiler's "Memcpy DtoD"):
    a pass that reads and writes each word once, the packs' practical
    floor. The copy is a yardstick only; the port never calls it. Then K9
    and K10 (pack and unpack) at every V and block size of their launch
    menu on the planned grid for that block, each held equal to the plain
    version first."""
    from noise_ec_tpu_torch.ops.pack import (
        GROUP_THREADS,
        GROUP_VECS,
        _groups,
        _pack_groups_plain,
        _unpack_groups_plain,
        groups_launch,
    )

    timer = Timer(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows, sweep = [], []
    cases = pack_cases(rng, device)
    for name, (fn, src, kname, nrows) in cases.items():
        def copy(src=src):
            return torch.empty_like(src).copy_(src)

        nbytes = 2 * src.numel() * 4
        rows.append({"kernel": name, "rows": nrows,
                     "shape": list(src.shape), "fn": fn, "copy": copy,
                     "kname": kname, "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "ms": timer.median_ms(fn),
                     "copy_ms": timer.median_ms(copy)})
    for name, group, pack in (("pack_sublane", 8, True),
                              ("unpack_sublane", 8, False),
                              ("pack_words16", 16, True),
                              ("unpack_words16", 16, False)):
        src = cases[name][1]
        want = (_pack_groups_plain(src, group) if pack
                else _unpack_groups_plain(src))
        TW = src.numel() // src.shape[0]
        for V, threads in itertools.product(GROUP_VECS, GROUP_THREADS):
            def fn(src=src, group=group, pack=pack, V=V, threads=threads,
                   name=name):
                return _groups(src, group, pack, name, V, threads)

            check(torch.equal(fn(), want), f"pack sweep {name} V={V} "
                  f"threads={threads}")
            sweep.append({"kernel": name, "V": V, "threads": threads,
                          "grid": list(groups_launch(
                              src.shape[0], TW, group, V, sms, threads)[1:]),
                          "planned": groups_launch_of(src, group) == {
                              "V": V, "threads": threads, "grid": list(
                                  groups_launch(src.shape[0], TW, group, V,
                                                sms, threads)[1:])},
                          "fn": fn, "ms": timer.median_ms(fn)})
    # Device times after every event timing: a trace slows the host after.
    for row in rows:
        row["device_us"] = device_us(row.pop("fn"), timer.flush,
                                     row.pop("kname"))
        row["copy_device_us"] = device_us(row.pop("copy"), timer.flush,
                                          "Memcpy DtoD")
        if row["device_us"] and row["copy_device_us"]:
            row["over_copy"] = row["device_us"] / row["copy_device_us"]
            row["share_of_bound"] = row["bound_ms"] * 1e3 / row["device_us"]
    for row in sweep:
        row["device_us"] = device_us(row.pop("fn"), timer.flush,
                                     "groups_kernel")
    return {"phase": "pack_sweep", "rows": rows, "groups_sweep": sweep}


def phase_mxu_sweep(rng, device) -> dict:
    """K8 at every width of ``ops/mxu.py`` N_MENU on RS(200,56)'s GF(2^16)
    parity and the dense (200, 200) GF(2^8) matrix at 1 MiB shards (the
    evidence for ``tile_width``), each width first held equal to the plain
    version on a batch of two at a ragged width. Then the probes of
    ``csrc/mxu_probe.cu``: on RS(200,56) at N = 128 and 224, K8 with its A
    fragments held constant, without its M2 copies, and both; and a bare
    wgmma loop's int8 rate on every SM, against the rate of the bound."""
    from noise_ec_tpu_torch.ops import _build
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.ops.mxu import (
        N_MENU,
        build_mxu_tiles,
        mxu_encode_tiles,
        mxu_encode_words_bits_plain,
    )

    timer = Timer(device)
    mats = k8_matrices(rng)
    lib = _build.probe_library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows, probes = [], []
    for name, codec in (
            ("rs16_200_56_parity", DeviceCodec(field="gf65536",
                                               device=device)),
            ("dense_200_200_gf256", DeviceCodec(device=device))):
        field, M = mats[name]
        planned = codec.plan_for(M)[2]
        m2, r, k = planned.matrix(), planned.r, planned.k
        words = k8_words(rng, planned, field, device)
        want = mxu_encode_tiles(planned, words)
        small = rand_words(rng, (2, k, 352), device)
        small_want = mxu_encode_words_bits_plain(m2, small, r, k)
        for N in N_MENU:
            tiles = build_mxu_tiles(m2, r, k, N)
            check(torch.equal(mxu_encode_tiles(tiles, small), small_want),
                  f"sweep {name} N={N} ragged batch")
            check(torch.equal(mxu_encode_tiles(tiles, words), want),
                  f"sweep {name} N={N}")
            rows.append({
                "matrix": name, "N": N, "row_tiles": tiles.T,
                "planned": N == planned.N, "ms": timer.median_ms(
                    lambda: mxu_encode_tiles(tiles, words), 5)})
            if name != "rs16_200_56_parity" or N == 32:
                continue
            out = torch.empty_like(want)

            def run(probe):
                _build.launch(
                    "ec_mxu_probe", words, _build.ptr(tiles.tiles),
                    _build.ptr(words), _build.ptr(out), 1, r, k,
                    words.shape[1], N, tiles.T, tiles.NCH, sms, probe,
                    lib=lib)

            run(0)
            check(torch.equal(out, want), f"probe build of K8 N={N}")
            for probe, what in ((0, "K8"), (1, "A fragments constant"),
                                (2, "no M2 copies"), (3, "both")):
                probes.append({"matrix": name, "N": N, "probe": what,
                               "ms": timer.median_ms(lambda: run(probe), 5)})
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    iters = 4000
    for N, groups in ((128, 4), (224, 2)):
        ms = timer.median_ms(lambda: _build.launch(
            "ec_wgmma_peak", sink, N, sms, iters, _build.ptr(sink), lib=lib),
            5)
        ops = sms * groups * iters * 4 * 2 * 64 * N * 32
        probes.append({"probe": "bare wgmma", "N": N, "warpgroups": groups,
                       "blocks": sms, "ms": ms,
                       "int8_ops_per_s": ops / ms * 1e3,
                       "share_of_bound_rate": ops / ms * 1e3
                       / INT8_OPS_PER_S})
    return {"phase": "mxu_sweep", "rows": rows, "probes": probes,
            "ptxas_probe": [ln.strip() for ln in _build.build_log.get(
                "mxu_probe", "").splitlines() if "spill" in ln]}


MESH_POSITIONS = 4        # cuda:0 listed four times: one stream a position
MESH_DONATED_STEPS = 50   # steady-state donated batch encodes
MESH_WIDE_SHARD = 256 << 10   # RS(200,56) builder shards (4 x 200 MiB in)
MULTIHOST_TIMEOUT_S = 120.0

# One process joins a world of one over NCCL on the card and runs one
# sharded encode through the global mesh (the all-gather over the group
# runs, with one rank). Prints one JSON line.
_MULTIHOST_CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from noise_ec_tpu_torch.matrix import host_matvec
from noise_ec_tpu_torch.parallel import multihost
from noise_ec_tpu_torch.parallel.batch import BatchCodec
port, seed, tw = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
multihost.initialize(f"127.0.0.1:{port}", 1, 0)
n = len(multihost.global_devices())
mesh = multihost.global_mesh(("batch", "row"), (1, n))
bc = BatchCodec(10, 4)
words = np.random.default_rng(seed).integers(
    0, 1 << 32, size=(2, 10, tw), dtype=np.uint64).astype(np.uint32)
enc = bc.make_sharded_encoder_words(mesh, row_axis="row")
out = multihost.fetch_to_every_host(
    enc(multihost.replicate_to_global(words, mesh)))
cols = 16384
ok = all(np.array_equal(
    np.ascontiguousarray(out[b, :, :cols]).view(np.uint8),
    host_matvec(bc.gf, bc.parity_matrix,
                np.ascontiguousarray(words[b, :, :cols]).view(np.uint8)))
    for b in range(2))
print(json.dumps({"backend": dist.get_backend(),
                  "world": dist.get_world_size(), "positions": n,
                  "mesh": mesh.shape, "home": str(mesh.home),
                  "shape": list(out.shape), "equal_to_host": ok}))
dist.destroy_process_group()
"""


def device_words(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Random int32 words made on the card from ``gen`` (seeded from the
    run's seed): the mesh phase's inputs run to gigabytes."""
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                         device=device, generator=gen)


def mesh_counters() -> dict:
    from noise_ec_tpu_torch.obs import default_registry

    reg = default_registry()
    return {
        "shard_map": reg.counter("noise_ec_mesh_sharded_dispatches_total")
        .labels(mode="shard_map").value,
        "reshard": reg.counter("noise_ec_mesh_reshard_total").labels().value,
        "tile_dispatches": sum(c.value for _, c in reg.counter(
            "noise_ec_kernel_tile_dispatches_total").children()),
    }


def multihost_world_of_one(rng) -> dict:
    """``multihost.initialize`` as a world of one over NCCL in a child
    process, with ``global_mesh``, ``replicate_to_global``,
    ``fetch_to_every_host`` and one sharded encode at 1 MiB shards."""
    port = free_ports(1)[0]
    proc = subprocess.run(
        [sys.executable, "-c", _MULTIHOST_CHILD, str(port),
         str(int(rng.integers(1 << 30))), str(TW)],
        capture_output=True, text=True, timeout=MULTIHOST_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in [os.environ.get("PYTHONPATH")] if p])))
    check(proc.returncode == 0,
          f"multihost child exited {proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(res["backend"] == "nccl" and res["world"] == 1,
          f"a world of one over NCCL: {res}")
    check(res["equal_to_host"], "the multihost encode equals the host")
    return res


def phase_mesh(rng, device) -> dict:
    """The mesh tier and the sharded builders on the one card.

    The default router on a one-card host is disabled and the
    ``noise_ec_mesh_devices`` gauge reads 1. A router configured over
    ``cuda:0`` listed four times (each position its own stream) then runs,
    byte-equal to the single-device route and to the host arithmetic on a
    64 KiB slice: RS(10,4) and RS(50,20) words batches at 1 MiB shards, B
    = 5 and B = 8 (K5 on every shard); an RS(229,6) panel batch (K6 -> K7
    -> K6, tile-labelled); a GF(2^16) RS(10,4) byte-sliced stripes batch
    (K5); a chained encode -> decode1 with the reshard counter still; and
    ``make_sharded_encoder_words`` over a (2, 2) mesh, RS(10,4) (K5) and
    the near-limit RS(200,56) (K8 per row slice). Each run's launches are
    counted per shard. Then the multihost world of one over NCCL, the
    peak memory over 50 donated steady-state batch encodes (it must not
    grow after the first), and the sharded against the unsharded batch
    time: four positions of one card show the overhead of the split, not
    multi-GPU speed."""
    from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
    from noise_ec_tpu_torch.obs import default_registry
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
    from noise_ec_tpu_torch.parallel.batch import BatchCodec
    from noise_ec_tpu_torch.parallel.mesh import (
        configure_mesh_router,
        make_mesh,
        mesh_router,
        reset_mesh_router,
    )

    reg = default_registry()
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    parts, t_part = {}, [time.monotonic()]

    def part(name):
        now = time.monotonic()
        parts[name] = now - t_part[0]
        t_part[0] = now

    reset_mesh_router()
    default = mesh_router()
    gauge = dict(reg.gauge("noise_ec_mesh_devices").children())[()].read()
    check(not default.enabled and gauge == 1,
          f"the default router on {torch.cuda.device_count()} card(s) is "
          f"disabled ({default.enabled}) and the gauge reads 1 ({gauge})")
    report = {"phase": "mesh", "card": nvidia_smi(),
              "default_router": {"enabled": default.enabled,
                                 "mesh_devices": gauge},
              "positions": MESH_POSITIONS, "panel_entries": True,
              "warm_stripes": True}
    codec = DeviceCodec(device=device)
    codec16 = DeviceCodec(field="gf65536", device=device)
    router = configure_mesh_router(devices=[device] * MESH_POSITIONS,
                                   enable=True)
    streams = [router.mesh_for(MESH_POSITIONS).stream(i)
               for i in range(MESH_POSITIONS)]
    check(len({s.cuda_stream for s in streams}) == MESH_POSITIONS
          and torch.cuda.current_stream(device).cuda_stream not in
          {s.cuda_stream for s in streams},
          "each position runs on its own stream")
    by_run, cols = {}, HOST_SLICE // 4

    def counted(name, fn, kernel, per_shard=1):
        """``fn`` with the launch counts zeroed just before and read just
        after; ``kernel`` must have launched ``per_shard`` times a
        position."""
        reset_launch_counts()
        before = mesh_counters()
        out = fn()
        torch.cuda.synchronize()
        after = mesh_counters()
        launches = {k: v for k, v in launch_counts().items() if v}
        by_run[name] = {"launches": launches,
                        **{k: after[k] - before[k] for k in after}}
        check(launches.get(kernel, 0) == per_shard * MESH_POSITIONS,
              f"{name}: {kernel} launched {per_shard} a shard "
              f"({launches})")
        return out

    def unsharded(fn):
        router.enabled = False
        try:
            return fn()
        finally:
            router.enabled = True

    def host_equal(M, words, out, gf=None):
        gf = codec.gf if gf is None else gf
        for b in (0, words.shape[0] - 1):
            want = host_matvec(gf, M, words[b, :, :cols].cpu().numpy()
                               .view(np.uint8))
            check(np.array_equal(out[b, :, :cols].cpu().numpy()
                                 .view(np.uint8), want), "host slice")

    for k, r in ((10, 4), (50, 20)):
        G = generator_matrix(codec.gf, k, k + r, "cauchy")
        for B in (5, 8):
            words = device_words(gen, (B, k, TW), device)
            name = f"rs_{k}_{r}_b{B}"
            got = counted(name, lambda: codec.matmul_words_batch(
                G[k:], words), "fused_split")
            check(torch.equal(got, unsharded(
                lambda: codec.matmul_words_batch(G[k:], words))),
                f"{name} equals the single-device route")
            host_equal(G[k:], words, got)
            check(by_run[name]["shard_map"] == 1, f"{name} sharded once")
    part("words_batches")

    G229 = generator_matrix(codec.gf, 229, 235, "cauchy")
    w229 = device_words(gen, (4, 229, (64 << 10) // 4), device)
    got = counted("rs_229_6_b4", lambda: codec.matmul_words_batch(
        G229[229:], w229), "gf2mm_panel")
    check(by_run["rs_229_6_b4"]["launches"].get("pack_lanes_blocked") == 4,
          "K6 packed every shard")
    check(by_run["rs_229_6_b4"]["tile_dispatches"] == 1,
          "the sharded panel dispatch carries a tile label")
    check(torch.equal(got, unsharded(
        lambda: codec.matmul_words_batch(G229[229:], w229))),
        "RS(229,6) equals the single-device route")
    host_equal(G229[229:], w229, got)
    part("panel_batch")

    G16 = generator_matrix(codec16.gf, 10, 14, "cauchy")
    Ds = [rng.integers(0, 1 << 16, size=(10, SHARD // 2)).astype(np.uint16)
          for _ in range(5)]
    got16 = counted("gf16_rs_10_4_b5", lambda: codec16.matmul_stripes_many(
        G16[10:], Ds), "fused_split")
    single16 = unsharded(lambda: codec16.matmul_stripes_many(G16[10:], Ds))
    for D, g, s in zip(Ds, got16, single16):
        check(np.array_equal(g, s), "GF(2^16) equals the single-device route")
        check(np.array_equal(g[:, :cols], host_matvec(
            codec16.gf, G16[10:], D[:, :cols])), "GF(2^16) host slice")
    part("gf16_batch")

    G = generator_matrix(codec.gf, 10, 14, "cauchy")
    words = device_words(gen, (8, 10, TW), device)
    flip = int(np.uint32(0xA5A5A5A5).view(np.int32))

    def chained():
        parity = router.matmul_words_batch(codec, G[10:], words)
        data = router.shard(words)

        def assemble(d, p):
            full = torch.cat([d, p], dim=1)
            full[:, 5] ^= flip
            return full

        return router.decode1_words_batch(codec, G[10:], 5,
                                          data.map(assemble, parity))

    corrected, bad = counted("chained_encode_decode1", chained,
                             "fused_split", per_shard=2)
    check(by_run["chained_encode_decode1"]["reshard"] == 1,
          "only the encode's plain-tensor input resharded")
    check(not bad.to_tensor().any().item(), "decode1 verifies everywhere")
    check(torch.equal(corrected.to_tensor(), words[:, 5]),
          "decode1 corrects the flipped row")
    part("chained")

    mesh22 = make_mesh(("batch", "row"), (2, 2), [device] * MESH_POSITIONS)
    bc = BatchCodec(10, 4)
    got = counted("builder_rs_10_4", lambda: bc.make_sharded_encoder_words(
        mesh22, row_axis="row")(words[:4]), "fused_split")
    check(torch.equal(got, unsharded(lambda: codec.matmul_words_batch(
        G[10:], words[:4]))), "the (2,2) builder equals the codec")
    bc200 = BatchCodec(200, 56)
    w200 = device_words(gen, (4, 200, MESH_WIDE_SHARD // 4), device)
    got = counted("builder_rs_200_56_k8", lambda: bc200.make_sharded_encoder_words(
        mesh22, row_axis="row")(w200), "mxu_gf2")
    host_equal(bc200.parity_matrix, w200, got)
    part("builders")
    report["by_run"] = by_run
    report["multihost"] = multihost_world_of_one(rng)
    part("multihost")

    # Steady state: 50 donated batch encodes, each input made and dropped
    # in turn; the peak must not grow after the first.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    peaks = []
    for _ in range(MESH_DONATED_STEPS):
        x = device_words(gen, (8, 10, TW), device)
        out = codec.matmul_words_batch(G[10:], x, donate=True)
        del x, out
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(device))
    check(max(peaks[1:]) <= peaks[0],
          f"the donated steady state's peak grew: {peaks[0]} -> "
          f"{max(peaks[1:])}")
    report["donated_peak_bytes"] = {"first": peaks[0], "max_after": max(
        peaks[1:]), "steps": MESH_DONATED_STEPS}
    part("donated")

    timer = Timer(device)
    sharded_ms = timer.median_ms(
        lambda: codec.matmul_words_batch(G[10:], words))
    single_ms = unsharded(lambda: timer.median_ms(
        lambda: codec.matmul_words_batch(G[10:], words)))
    report["times"] = {
        "card": report["card"], "case": "RS(10,4) matmul_words_batch, "
        "B = 8 at 1 MiB shards", "sharded_ms": sharded_ms,
        "unsharded_ms": single_ms,
        "note": "four positions of one card: the overhead of the split, "
                "not multi-GPU speed"}
    part("times")
    report["part_seconds"] = parts
    reset_mesh_router()
    return report


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def obs_counts() -> dict:
    """Per public entry, the ``noise_ec_kernel_calls_total`` calls and the
    ``noise_ec_device_op_seconds`` observations recorded so far, and the
    codec breaker's refusals by reason."""
    from noise_ec_tpu_torch.obs import default_registry

    reg = default_registry()
    refused = reg.counter("noise_ec_codec_refused_total")
    return {
        "tiles": {key: c.value for key, c in reg.counter(
            "noise_ec_kernel_tile_dispatches_total").children()},
        "pool_hits": reg.counter(
            "noise_ec_device_buffer_pool_hits_total").labels().value,
        "calls": {key[0]: c.value for key, c in reg.counter(
            "noise_ec_kernel_calls_total").children()},
        "ops": {key: h.count for key, h in reg.histogram(
            "noise_ec_device_op_seconds").children()},
        "refused": {r: refused.labels(reason=r).value
                    for r in ("error", "open")},
    }


def phase_health(before: dict, report: dict) -> dict:
    """After every phase: no product ran on the host (the reference's
    ``noise_ec_codec_fallback_total`` reads 0 for every reason: the port
    never records it), the codec breaker refused exactly the products the
    phase meant it to (``report["expect_refused"]``, else none), the
    breaker is closed, the device gate is idle, every public-entry call
    the phase made was timed by ``device_op`` (compile plus execute
    observations equal the calls, less the calls the phase made fail on
    purpose, ``report["failed_calls"]``), and each entry it used has
    execute-route observations. Every panel dispatch's tile label names a
    K7 plan; a phase that drives panel-routed entries
    (``report["panel_entries"]``) labelled some, and one that repeats its
    stripes shapes (``report["warm_stripes"]``) reused staging pages
    (``noise_ec_device_buffer_pool_hits_total`` moved). Raises on a
    miss."""
    from noise_ec_tpu_torch.obs import default_registry
    from noise_ec_tpu_torch.ops.dispatch import codec_breaker, device_gate

    reg = default_registry()
    fallback = reg.counter("noise_ec_codec_fallback_total")
    fallbacks = {reason: fallback.labels(reason=reason).value
                 for reason in ("error", "open")}
    check(all(v == 0 for v in fallbacks.values()),
          f"no product fell back to the host: {fallbacks}")
    after = obs_counts()
    refused = {r: n - before["refused"][r]
               for r, n in after["refused"].items()}
    want = report.get("expect_refused", {"error": 0, "open": 0})
    check(refused == want, f"the breaker refused {refused}, expected {want}")
    state = codec_breaker().state()
    check(state == "closed", f"the codec breaker is closed ({state})")
    gate = device_gate()
    check(gate.in_flight == 0 and gate.waiters == 0,
          f"the device gate is idle ({gate.in_flight} in flight, "
          f"{gate.waiters} waiting)")
    failed = report.get("failed_calls", {})
    entries = {}
    for entry, n in after["calls"].items():
        calls = n - before["calls"].get(entry, 0)
        if calls <= 0:
            continue
        seen = {route: after["ops"].get((entry, route), 0)
                - before["ops"].get((entry, route), 0)
                for route in ("compile", "execute")}
        check(seen["compile"] + seen["execute"]
              == calls - failed.get(entry, 0),
              f"every {entry} call timed ({calls} calls, "
              f"{failed.get(entry, 0)} failed on purpose, {seen})")
        check(after["ops"].get((entry, "execute"), 0) > 0,
              f"{entry} has execute-route observations")
        entries[entry] = {"calls": calls, **seen}
    tiles = {f"{key[0]}/{key[1]}": n - before["tiles"].get(key, 0)
             for key, n in after["tiles"].items()
             if n - before["tiles"].get(key, 0) > 0}
    for name in tiles:
        check(re.fullmatch(r"[a-z_0-9]+/kt\d+_rg\d+_wr\d+_wc\d+_g\d+",
                           name) is not None,
              f"tile label {name} names a K7 plan")
    if report.get("panel_entries"):
        check(tiles, "the panel dispatches carry a tile label")
    pool_hits = after["pool_hits"] - before["pool_hits"]
    if report.get("warm_stripes"):
        check(pool_hits > 0, "warm stripes calls reused staging pages")
    return {"fallbacks": fallbacks, "refused": refused, "breaker": state,
            "entries": entries, "tiles": tiles, "pool_hits": pool_hits}


def phase_resilience(rng) -> dict:
    """The codec breaker on the card, RS(10,4) at 1 MiB shards.

    With ``DeviceCodec.matmul_stripes_many`` patched to raise
    ``RuntimeError``: exactly two attempts, the trip, and
    ``CodecUnavailableError`` chained to the fault with ``reason="error"``
    +1; then encode and reconstruct refused at once with ``reason="open"``;
    the codec's host arithmetic (``codec/rs.py``'s ``native_matvec``, the
    numpy backend's product) runs no product throughout. With the patch
    lifted, the prober's canary (on the card) re-closes the breaker within
    30 s, and the next encode and reconstruct run on the device (K5) with
    the bytes of ``host_matvec``. A launch patched to raise
    ``KernelLaunchError`` propagates with the breaker closed and the
    counters unchanged. Then 8 threads of RS(10,4) encodes, 4 in the live
    lane and 4 in the background lane, through a capacity-2 gate: every
    result byte-equal, each lane's grants counted. The breaker and the
    gate are reset at the end; the health check after the phase reads
    the refusals and the failed launch it expects from the report."""
    import noise_ec_tpu_torch.codec.rs as rs_module
    from noise_ec_tpu_torch.codec import ReedSolomon
    from noise_ec_tpu_torch.matrix import host_matvec
    from noise_ec_tpu_torch.obs import default_event_log, default_registry
    from noise_ec_tpu_torch.ops import _build, launch_counts, \
        reset_launch_counts
    from noise_ec_tpu_torch.ops.coalesce import qos_lane
    from noise_ec_tpu_torch.ops.dispatch import (
        CodecUnavailableError,
        DeviceCodec,
        configure_codec_breaker,
        configure_device_gate,
    )

    reg = default_registry()
    refused = reg.counter("noise_ec_codec_refused_total")

    def counts():
        return {r: refused.labels(reason=r).value for r in ("error", "open")}

    def refuses(fn):
        try:
            fn()
        except CodecUnavailableError as exc:
            return exc
        return None

    br = configure_codec_breaker(reset_timeout=0.5, max_reset_timeout=4.0)
    rs = ReedSolomon(10, 4)
    data = [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
            for _ in range(10)]
    D = np.stack(data)
    parity = host_matvec(rs.gf, rs.G[10:], D)
    lost = (0, 5, 11)
    damaged = [None if i in lost else s for i, s in
               enumerate(data + list(parity))]
    report = {"phase": "resilience", "code": "RS(10,4)",
              "shard_bytes": SHARD}
    by_path = {}

    attempts = {"n": 0}
    host_runs = {"n": 0}
    real = DeviceCodec.matmul_stripes_many
    real_host = rs_module.native_matvec

    def injected(self, M, Ds):
        if self is rs._dev:  # the prober's canary has a codec of its own
            attempts["n"] += 1
        raise RuntimeError("injected device fault")

    def host_spy(*a, **k):
        host_runs["n"] += 1
        return real_host(*a, **k)

    c0 = counts()
    DeviceCodec.matmul_stripes_many = injected
    rs_module.native_matvec = host_spy
    try:
        exc = refuses(lambda: rs.encode(data))
        check(exc is not None and isinstance(exc.__cause__, RuntimeError),
              f"the encode raised CodecUnavailableError from the fault "
              f"({exc!r})")
        check(attempts["n"] == 2, f"two attempts ({attempts['n']})")
        check(br.state() == "open", "the breaker tripped")
        check(counts() == {"error": c0["error"] + 1, "open": c0["open"]},
              "reason=error +1")
        t_trip = time.monotonic()
        check(refuses(lambda: rs.encode(data)) is not None,
              "open: the next encode is refused")
        check(attempts["n"] == 2, "open: the device is not tried")
        check(counts()["open"] == c0["open"] + 1,
              "reason=open on the next call")
        check(refuses(lambda: rs.reconstruct(damaged)) is not None,
              "open: the reconstruct is refused")
        check(counts()["open"] == c0["open"] + 2, "reconstruct counted open")
    finally:
        DeviceCodec.matmul_stripes_many = real
    report["refuse"] = {"attempts": attempts["n"],
                        "refused": {r: counts()[r] - c0[r] for r in c0},
                        "events": len(default_event_log().dump(
                            name="codec.refused"))}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not br.closed:
        time.sleep(0.02)
    check(br.closed, f"the prober re-closed the breaker in 30 s "
          f"({br.snapshot()})")
    from noise_ec_tpu_torch.ops import dispatch

    check(dispatch._probe_target.type == "cuda",
          "the canary ran on the card")
    report["reclose_seconds"] = time.monotonic() - t_trip
    report["restore_events"] = len(default_event_log().dump(
        name="codec.restore"))
    check(report["restore_events"] >= 1, "codec.restore event")
    try:
        reset_launch_counts()
        enc3 = rs.encode(data)
        rec3 = rs.reconstruct(damaged)
        torch.cuda.synchronize()
        by_path["after_reclose"] = launch_counts()
    finally:
        rs_module.native_matvec = real_host
    check(host_runs["n"] == 0,
          f"the codec ran no product on the host ({host_runs['n']})")
    check(by_path["after_reclose"]["fused_split"] >= 1
          and sum(by_path["after_reclose"].values()) >= 2,
          "the encode (K5) and reconstruct after the re-close ran on the "
          "card")
    check(all(np.array_equal(a, b) for a, b in zip(enc3[10:], parity)),
          "device encode after the re-close == host_matvec")
    check(all(np.array_equal(rec3[i], enc3[i]) for i in lost),
          "device reconstruct after the re-close")
    report["expect_refused"] = {"error": 1, "open": 2}

    real_launch = _build.launch
    tried = {"n": 0}

    def refuse(fn, *args, **kw):
        tried["n"] += 1
        raise _build.KernelLaunchError(f"{fn}: injected refusal")

    c1 = counts()
    _build.launch = refuse
    try:
        rs.encode(data)
    except _build.KernelLaunchError:
        raised = True
    else:
        raised = False
    finally:
        _build.launch = real_launch
    check(raised and tried["n"] == 1,
          f"KernelLaunchError propagates at once ({tried['n']} launches)")
    check(br.state() == "closed" and counts() == c1,
          "the launch error left the breaker closed, counters unchanged")
    report["launch_error"] = {"propagated": raised, "launches": tried["n"],
                              "breaker": br.state()}
    # The refused launch's matmul_stripes call was counted and, having
    # raised, not timed.
    report["failed_calls"] = {"matmul_stripes": 1}

    gate = configure_device_gate(capacity=2)
    grants = reg.counter("noise_ec_lane_grants_total")
    g0 = {lane: grants.labels(lane=lane).value
          for lane in ("live", "background")}
    datas = [[rng.integers(0, 256, size=SHARD, dtype=np.uint8)
              for _ in range(10)] for _ in range(8)]
    wants = [host_matvec(rs.gf, rs.G[10:], np.stack(d)) for d in datas]
    results, errors = [None] * 8, []

    def worker(i):
        try:
            with qos_lane("live" if i < 4 else "background", tenant=str(i)):
                for _ in range(3):
                    results[i] = rs.encode(datas[i])[10:]
        except BaseException as exc:  # noqa: BLE001 — checked below
            errors.append(exc)

    reset_launch_counts()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        check(not t.is_alive(), "a lane thread finished")
    torch.cuda.synchronize()
    by_path["lanes"] = launch_counts()
    check(not errors, f"lane threads: {errors}")
    for got, want in zip(results, wants):
        check(np.array_equal(np.stack(got), want), "lane encode byte-equal")
    lane_grants = {lane: grants.labels(lane=lane).value - g0[lane]
                   for lane in ("live", "background")}
    check(all(v > 0 for v in lane_grants.values()),
          f"each lane's grants counted: {lane_grants}")
    check(gate.in_flight == 0 and gate.waiters == 0, "the gate drained")
    report["lanes"] = {"threads": 8, "capacity": 2, "grants": lane_grants,
                       "waits": gate.waits}
    # A fresh breaker and gate for the next phase (the health check reads
    # every counter as a difference across the phase).
    configure_codec_breaker(reset_timeout=5.0, max_reset_timeout=60.0)
    configure_device_gate()
    report["by_path"] = by_path
    report["launches"] = {name: sum(c[name] for c in by_path.values())
                          for name in by_path["lanes"]}
    return report


# The three LRC deployments of the lrc phase: (name, k, local groups,
# global parities, source).
LRC_CONFIGS = (
    ("LRC(12,2,2)", 12, 2, 2,
     "Huang et al., Erasure Coding in Windows Azure Storage, 2012"),
    ("LRC(40,8,8)", 40, 8, 8, "docs/lrc.md:72"),
    ("LRC(200,10,46)", 200, 10, 46, "docs/lrc.md:111, the archive tier"),
)


def phase_lrc(rng) -> dict:
    """``LocalReconstructionCode`` on the card at 1 MiB shards, each case
    held byte-equal to the port's ``backend="numpy"`` LRC with the same
    tier counters: encode (on a 64 KiB slice of every shard past 64 data
    shards, as for RS(200,56)), every single loss of every group cell
    healed locally from k/g reads, two losses in one cell through the
    global reconstruct, and ``repair_many`` of three stripes (one local
    loss a cell in two cells). Launch counts are zeroed before each path
    and read after; prints each matrix's route and the encode GB/s,
    local-heal p50 and global-reconstruct p50 beside the card's name and
    power limit."""
    from noise_ec_tpu_torch.codec import LocalReconstructionCode
    from noise_ec_tpu_torch.obs import default_registry
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts

    reg = default_registry()
    heals = reg.counter("noise_ec_lrc_repairs_total")
    reads = reg.counter("noise_ec_lrc_repair_shards_read_total")

    def tiers():
        return tuple(fam.labels(tier=t).value for fam in (heals, reads)
                     for t in ("local", "global"))

    def counted(fn):
        t0 = tiers()
        out = fn()
        return out, tuple(b - a for a, b in zip(t0, tiers()))

    def run_path(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    def p50_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    report = {"phase": "lrc", "shard_bytes": SHARD, "nvidia_smi":
              nvidia_smi(), "configs": {}}
    by_path = {}
    for name, k, g, r, source in LRC_CONFIGS:
        lrc = LocalReconstructionCode(k, g, r)  # device="cuda"
        ref = LocalReconstructionCode(k, g, r, backend="numpy")
        gs = k // g
        data = [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
                for _ in range(k)]
        cell0 = lrc.cell(0)
        two = {cell0[0], cell0[1]}
        present = [i for i in range(lrc.n) if i not in two]
        from noise_ec_tpu_torch.matrix import reconstruction_matrix

        global_R = None
        for cand in itertools.combinations(present, k):
            try:
                global_R = reconstruction_matrix(lrc.gf, lrc.G, list(cand),
                                                 sorted(two))
                break
            except np.linalg.LinAlgError:
                continue
        routes = {
            "parity": lrc._dev.route_for(lrc.G[k:]),
            "local_heal": lrc._dev.route_for(lrc._local_row),
            "global_reconstruct": lrc._dev.route_for(global_R),
        }
        print(json.dumps({"lrc": name, "route_for": routes}), flush=True)
        cfg = {"k": k, "groups": g, "global_parities": r, "n": lrc.n,
               "source": source, "route_for": routes}

        enc, by_path[f"{name} encode"] = run_path(lambda: lrc.encode(data))
        cut = HOST_SLICE if k > 64 else SHARD
        want = ref.encode([d[:cut] for d in data])
        check(all(np.array_equal(a[:cut], b) for a, b in zip(enc, want)),
              f"{name} encode vs the numpy LRC")
        check(lrc.verify(enc), f"{name} verify")

        def local_heals():
            for grp in range(g):
                for i in lrc.cell(grp):
                    shards = [None if j == i else s
                              for j, s in enumerate(enc)]
                    got, dev_tiers = counted(lambda: lrc.reconstruct(shards))
                    ref_out, ref_tiers = counted(
                        lambda: ref.reconstruct(shards))
                    check(np.array_equal(got[i], enc[i])
                          and np.array_equal(got[i], ref_out[i]),
                          f"{name} local heal of shard {i}")
                    check(dev_tiers == ref_tiers == (1, 0, gs, 0),
                          f"{name} shard {i}: one local heal, {gs} reads "
                          f"({dev_tiers} vs {ref_tiers})")
            return g * (gs + 1)

        cfg["local_heals"], by_path[f"{name} local"] = run_path(local_heals)
        damaged = [None if i in two else s for i, s in enumerate(enc)]
        (rec, dev_tiers), by_path[f"{name} global"] = run_path(
            lambda: counted(lambda: lrc.reconstruct(damaged)))
        ref_rec, ref_tiers = counted(lambda: ref.reconstruct(damaged))
        check(all(np.array_equal(rec[i], enc[i])
                  and np.array_equal(rec[i], ref_rec[i]) for i in two),
              f"{name} two losses in one cell, global reconstruct")
        check(dev_tiers == ref_tiers and dev_tiers[:2] == (0, 2),
              f"{name} global tier counters ({dev_tiers} vs {ref_tiers})")

        # repair_many: three stripes, one loss in each of two cells.
        members, truths = [], []
        lost_many = [lrc.cell(0)[1], lrc.cell(g - 1)[0]]
        for b in range(3):
            stripe = enc if b == 0 else lrc.encode(
                [rng.integers(0, 256, size=SHARD, dtype=np.uint8)
                 for _ in range(k)])
            full = [np.ascontiguousarray(s).tobytes() for s in stripe]
            truths.append(full)
            members.append([None if i in lost_many else s
                            for i, s in enumerate(full)])
        trusted = [i for i in range(lrc.n) if i not in lost_many]
        (fixed, dev_tiers), by_path[f"{name} repair_many"] = run_path(
            lambda: counted(lambda: lrc.repair_many(members, trusted,
                                                    lost_many)))
        ref_fixed, ref_tiers = counted(
            lambda: ref.repair_many(members, trusted, lost_many))
        check(fixed == ref_fixed and all(
            out[i] == full[i] for out, full in zip(fixed, truths)
            for i in lost_many), f"{name} repair_many")
        check(dev_tiers == ref_tiers == (6, 0, 6 * gs, 0),
              f"{name} repair_many tiers ({dev_tiers} vs {ref_tiers})")
        for path in ("encode", "local", "global", "repair_many"):
            check(sum(by_path[f"{name} {path}"].values()) > 0,
                  f"{name} {path} launched kernels")

        enc_ms = p50_ms(lambda: lrc.encode(data), 5)
        one = [None if j == cell0[0] else s for j, s in enumerate(enc)]
        cfg.update({
            "encode_p50_ms": enc_ms,
            "encode_gbps": k * SHARD / enc_ms / 1e6,
            "local_heal_p50_ms": p50_ms(lambda: lrc.reconstruct(one), 9),
            "global_reconstruct_p50_ms": p50_ms(
                lambda: lrc.reconstruct(damaged), 5),
        })
        report["configs"][name] = cfg
        del enc, members, truths, fixed, ref_fixed, data
    report["by_path"] = by_path
    names = next(iter(by_path.values()))
    report["launches"] = {n: sum(c[n] for c in by_path.values())
                          for n in names}
    return report


NODE_SENDERS = 4         # bench.py's host node round trip (bench.py:325-430)
NODE_MSGS = 24           # messages a sender
NODE_MSG_BYTES = 64 << 10
NODE_OBJECT_BYTES = 64 * MIB   # bench.py's large object (bench.py:470-527)
NODE_CHUNK = 4 * MIB
NODE_OBJECT_REPS = 3     # best of
NODE_WAIT_S = 120.0      # the ceiling of every wait on a node
NODE_CLI_SEND_S = 300.0  # a 64 MiB /send between two CLI processes


def wait_until(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"{what} within {timeout:g} s")
        time.sleep(0.005)


def e2e_ok_counts() -> tuple:
    """The bucket bounds and raw counts of
    ``noise_ec_e2e_latency_seconds{outcome="ok"}`` so far."""
    from noise_ec_tpu_torch.obs import default_registry

    h = default_registry().histogram("noise_ec_e2e_latency_seconds").labels(
        outcome="ok")
    return h.bounds, list(h.snapshot()["counts"])


def stage_sums() -> dict:
    """Per span stage, the count and seconds summed so far in
    ``noise_ec_stage_seconds`` (the tracer's stage histogram)."""
    from noise_ec_tpu_torch.obs import default_registry

    fam = default_registry().histogram("noise_ec_stage_seconds")
    return {key[0]: (h.count, h.sum) for key, h in fam.children()}


def stage_delta(before: dict) -> dict:
    """Each stage's spans and milliseconds since ``before``: the host
    time the node's spans cover, by stage (they nest: prepare holds sign
    and encode)."""
    out = {}
    for stage, (n, secs) in stage_sums().items():
        n0, s0 = before.get(stage, (0, 0.0))
        if n > n0:
            out[stage] = {"spans": n - n0, "ms": (secs - s0) * 1e3}
    return out


def node_roundtrip(rng, backend: str, timer) -> dict:
    """NODE_SENDERS port nodes over real TCP on 127.0.0.1, each sending
    NODE_MSGS distinct 64 KiB messages at the reference's default RS(4,2)
    on its own thread into one receiver (recv_shards=2), after one warm
    message each: msg/s and MB/s on the host clock, p50 and p99 of the
    receive path's e2e histogram over the timed window, every payload
    byte-equal, the window's kernel launches, and on the device backend
    the K5 product of one message timed alone (CUDA events, device-resident
    words) times the encodes, over the wall time."""
    from noise_ec_tpu_torch.host.plugin import ShardPlugin
    from noise_ec_tpu_torch.host.transport import TCPNetwork
    from noise_ec_tpu_torch.obs.metrics import percentile_from
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts

    total = NODE_SENDERS * NODE_MSGS
    got: dict = {}
    lock = threading.Lock()
    done = threading.Event()
    want = [NODE_SENDERS]

    def on_message(m, s):
        with lock:
            got[bytes(m[:8])] = m
            if len(got) >= want[0]:
                done.set()

    nets = []
    try:
        recv = TCPNetwork(host="127.0.0.1", port=0, discovery=False,
                          recv_shards=2)
        nets.append(recv)
        recv.add_plugin(ShardPlugin(backend=backend, on_message=on_message))
        recv.listen()
        senders = []
        for _ in range(NODE_SENDERS):
            net = TCPNetwork(host="127.0.0.1", port=0, discovery=False)
            nets.append(net)
            net.add_plugin(ShardPlugin(backend=backend))
            net.listen()
            net.bootstrap([recv.id.address])
            senders.append(net)
        wait_until(lambda: len(recv.peers) >= NODE_SENDERS, NODE_WAIT_S,
                   f"{NODE_SENDERS} senders registered")
        base = rng.integers(0, 256, size=NODE_MSG_BYTES, dtype=np.uint8)

        def payload(i: int, m: int) -> bytes:
            # Distinct payloads: identical bytes share a signature, and
            # the receiver's replay window would drop the repeats.
            b = base.copy()
            b[:8] = np.frombuffer((i << 32 | m).to_bytes(8, "little"),
                                  np.uint8)
            return b.tobytes()

        errors = []

        def send(i: int, first: int, count: int) -> None:
            try:
                plugin = senders[i].plugins[0]
                for m in range(first, first + count):
                    plugin.shard_and_broadcast(senders[i], payload(i, m))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(repr(exc))

        for i in range(NODE_SENDERS):  # warm: codecs, plans, key tables
            send(i, 0, 1)
        check(done.wait(NODE_WAIT_S) and not errors,
              f"{backend} node warm-up delivered ({errors})")
        with lock:
            got.clear()
            want[0] = total
            done.clear()
        bounds, e2e0 = e2e_ok_counts()
        stages0 = stage_sums()
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i, 1, NODE_MSGS))
                   for i in range(NODE_SENDERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(NODE_WAIT_S)
        delivered = done.wait(NODE_WAIT_S)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launch_counts()
        check(not any(t.is_alive() for t in threads) and not errors,
              f"{backend} node senders finished ({errors})")
        check(delivered and len(got) == total,
              f"{backend} node delivered {len(got)}/{total} messages")
        check(all(got.get(payload(i, m)[:8]) == payload(i, m)
                  for i in range(NODE_SENDERS)
                  for m in range(1, NODE_MSGS + 1)),
              f"{backend} node payloads byte-equal")
        _, e2e1 = e2e_ok_counts()
        e2e = [b - a for a, b in zip(e2e0, e2e1)]
        check(sum(e2e) == total, f"{backend} node e2e events ({sum(e2e)})")
        plugins = [n.plugins[0] for n in nets]
        limited = sum(p.counters.get("geometry_rate_limited")
                      for p in plugins)
        host_codecs = sum(len(p._fec_host_cache) for p in plugins)
        check(limited == 0 and host_codecs == 0,
              f"{backend} node: no geometry rate-limited ({limited}), no "
              f"host-only codec ({host_codecs})")
        out = {
            "backend": backend, "senders": NODE_SENDERS,
            "messages": total, "message_bytes": NODE_MSG_BYTES,
            "geometry": [4, 6], "recv_shards": 2, "wall_seconds": wall,
            "msgs_per_s": total / wall,
            "mb_per_s": total * NODE_MSG_BYTES / wall / 1e6,
            "e2e_p50_ms": percentile_from(bounds, e2e, 0.50) * 1e3,
            "e2e_p99_ms": percentile_from(bounds, e2e, 0.99) * 1e3,
            "geometry_rate_limited": limited, "host_only_codecs": host_codecs,
            "stages": stage_delta(stages0), "launches": launches,
        }
        if backend == "device":
            check(launches["fused_split"] > 0,
                  "the device-backend node launched K5")
            fec = senders[0].plugins[0]._fec_cache[(4, 6)]
            dev = fec._rs._dev
            words = rand_words(rng, (1, 4, NODE_MSG_BYTES // 16), dev.device)
            ms = timer.median_ms(
                lambda: dev.matmul_words_batch(fec._rs.G[4:], words))
            out["encode_product_ms"] = ms
            out["device_share"] = total * ms / 1e3 / wall
        else:
            check(sum(launches.values()) == 0,
                  "the numpy-backend node launched no kernel")
        return out
    finally:
        for net in nets:
            net.close()


def node_object(rng, backend: str, timer) -> dict:
    """One 64 MiB object node to node at RS(10,14) in 4 MiB chunks through
    ``stream_and_broadcast`` (two in-process nodes on a loopback hub, as
    bench.py:470-527 runs it), after a full-size warm pass: best of
    NODE_OBJECT_REPS on the host clock with distinct payloads, each
    delivered once and byte-equal (``on_object``), the launches, and on
    the device backend the K5 product of one chunk timed alone times the
    chunks, over the best wall time."""
    from noise_ec_tpu_torch.host.plugin import ShardPlugin
    from noise_ec_tpu_torch.host.transport import (
        LoopbackHub,
        LoopbackNetwork,
        format_address,
    )
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts

    hub = LoopbackHub()
    a = LoopbackNetwork(hub, format_address("tcp", "localhost", 3100))
    b = LoopbackNetwork(hub, format_address("tcp", "localhost", 3101))
    got = []
    a.add_plugin(ShardPlugin(backend=backend, minimum_needed_shards=10,
                             total_shards=14))
    b.add_plugin(ShardPlugin(backend=backend, minimum_needed_shards=10,
                             total_shards=14,
                             on_object=lambda m, s: got.append(m)))
    send = a.plugins[0]
    big = rng.integers(0, 256, size=NODE_OBJECT_BYTES,
                       dtype=np.uint8).tobytes()
    warm = big[2:] + b"\0\0"
    chunks = send.stream_and_broadcast(a, warm, chunk_bytes=NODE_CHUNK)
    check(len(got) == 1 and got[0] == warm, f"{backend} object warm pass")
    reset_launch_counts()
    stages0 = stage_sums()
    seconds = []
    for trial in range(NODE_OBJECT_REPS):
        data = big if trial == 0 else big[trial:] + bytes([trial]) * trial
        got.clear()
        t0 = time.perf_counter()
        send.stream_and_broadcast(a, data, chunk_bytes=NODE_CHUNK)
        seconds.append(time.perf_counter() - t0)
        check(len(got) == 1 and got[0] == data,
              f"{backend} object {trial} delivered once, byte-equal")
    torch.cuda.synchronize()
    launches = launch_counts()
    plugins = (send, b.plugins[0])
    limited = sum(p.counters.get("geometry_rate_limited") for p in plugins)
    check(limited == 0, f"{backend} object: no geometry rate-limited")
    best = min(seconds)
    out = {
        "backend": backend, "object_bytes": NODE_OBJECT_BYTES,
        "chunk_bytes": NODE_CHUNK, "chunks": chunks, "geometry": [10, 14],
        "seconds": seconds, "mb_per_s": NODE_OBJECT_BYTES / best / 1e6,
        "geometry_rate_limited": limited, "stages": stage_delta(stages0),
        "launches": launches,
    }
    if backend == "device":
        check(launches["fused_split"] > 0,
              "the device-backend object stream launched K5")
        from noise_ec_tpu_torch.parallel import BatchCodec

        codec = BatchCodec(10, 4)
        stride = NODE_CHUNK // 10 // 4 * 4
        words = rand_words(rng, (1, 10, stride // 4), torch.device("cuda"))
        ms = timer.median_ms(lambda: codec.device_codec().matmul_words_batch(
            codec.parity_matrix, words))
        out["chunk_product_ms"] = ms
        out["device_share"] = chunks * ms / 1e3 / best
    else:
        check(sum(launches.values()) == 0,
              "the numpy-backend object stream launched no kernel")
    del got, big, warm
    return out


class CliNode:
    """One ``python -m noise_ec_tpu_torch.host.cli`` process with a
    scraper of its log (stderr)."""

    def __init__(self, port: int, *args: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "noise_ec_tpu_torch.host.cli",
             "-port", str(port), "-host", "127.0.0.1", "-device", "cuda",
             *args],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        self.lines: list = []
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._scrape, daemon=True)
        self._reader.start()

    def _scrape(self) -> None:
        for line in self.proc.stderr:
            with self._cond:
                self.lines.append(line)
                self._cond.notify_all()

    def wait_for(self, needle: str, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not any(needle in line for line in self.lines):
                remaining = deadline - time.monotonic()
                check(remaining > 0 and self._reader.is_alive(),
                      f"node log line {needle!r} within {timeout:g} s (rc "
                      f"{self.proc.poll()}; last lines: "
                      f"{''.join(self.lines[-20:])})")
                self._cond.wait(min(remaining, 0.5))

    def send_line(self, text: str) -> None:
        self.proc.stdin.write(text + "\n")
        self.proc.stdin.flush()

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._reader.join(timeout=5)


def free_ports(count: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(count)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def node_cli(rng) -> dict:
    """Two CLI processes on the card (``-device cuda``) over TCP: one line
    and one ``/send`` of a 64 MiB file from A to B, each received
    byte-equal (B's ``-recv-dir`` file, named by its content hash), with a
    ceiling on every wait; both processes are stopped either way."""
    import hashlib
    import tempfile

    payload = rng.integers(0, 256, size=NODE_OBJECT_BYTES,
                           dtype=np.uint8).tobytes()
    with tempfile.TemporaryDirectory(prefix="noise_ec_node_") as tmp:
        recv_dir = os.path.join(tmp, "recv")
        src = os.path.join(tmp, "object.bin")
        with open(src, "wb") as f:
            f.write(payload)
        pa, pb = free_ports(2)
        started = []
        try:
            t0 = time.perf_counter()
            b = CliNode(pb, "-recv-dir", recv_dir)
            started.append(b)
            b.wait_for("listening for peers", NODE_WAIT_S)
            a = CliNode(pa, "-peers", f"tcp://127.0.0.1:{pb}")
            started.append(a)
            a.wait_for("listening for peers", NODE_WAIT_S)
            b.wait_for(f"registered peer tcp://127.0.0.1:{pa}", NODE_WAIT_S)
            start_s = time.perf_counter() - t0
            line = "hello from the node phase on the card"
            t0 = time.perf_counter()
            a.send_line(line)
            b.wait_for(f"message from tcp://127.0.0.1:{pa}: "
                       f"{line.encode().hex()}", NODE_WAIT_S)
            line_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            a.send_line(f"/send {src}")
            b.wait_for(f"saved {len(payload)} bytes", NODE_CLI_SEND_S)
            send_s = time.perf_counter() - t0
            name = hashlib.blake2b(payload, digest_size=8).hexdigest()
            with open(os.path.join(recv_dir, name), "rb") as f:
                check(f.read() == payload, "the CLI /send arrived byte-equal")
        finally:
            for node in started:
                node.stop()
        rcs = [node.proc.returncode for node in started]
    check(rcs == [0, 0], f"both CLI nodes exited 0 ({rcs})")
    return {"start_seconds": start_s, "line_seconds": line_s,
            "send_seconds": send_s, "send_bytes": len(payload),
            "send_mb_per_s": len(payload) / send_s / 1e6}


def phase_node(rng, device) -> dict:
    """The node (plugin + transport + wire + crypto) on the card and on
    the port's host codec: :func:`node_roundtrip` and :func:`node_object`
    on ``-backend device`` (the CUDA codec) and ``-backend numpy`` (NumPy
    and the native shim), then :func:`node_cli`. Its launches are on its
    own line (``by_run``); the kernels line keeps the main path's."""
    from noise_ec_tpu_torch.host.crypto import ED25519_BACKEND

    timer = Timer(device)
    report = {"phase": "node", "nvidia_smi": nvidia_smi(),
              "ed25519_backend": ED25519_BACKEND, "runs": {}}
    for backend in ("device", "numpy"):
        report["runs"][f"roundtrip_{backend}"] = node_roundtrip(
            rng, backend, timer)
        report["runs"][f"object_{backend}"] = node_object(rng, backend, timer)
    report["cli"] = node_cli(rng)
    report["by_run"] = {name: run.pop("launches")
                        for name, run in report["runs"].items()}
    del timer
    return report


def phase_layer_cost(rng) -> dict:
    """The host layers this slice put around every codec call: RS(4,2) on
    a 64 KiB message and RS(10,4) at 1 MiB shards, encode and reconstruct
    p50 on the host clock, the gate, ``device_op``, ``record_kernel`` and
    the breaker alone, and both cases with the layers on and off in ten
    alternating pairs in this process
    (``noise_ec_tpu_torch/tools/layer_cost.py``, which also times any
    other checkout, such as the parent commit)."""
    from noise_ec_tpu_torch.tools import layer_cost

    return {
        "phase": "layer_cost", "nvidia_smi": nvidia_smi(),
        "rs_4_2_64k": layer_cost.codec_times(rng, 4, 2, 16 << 10, (1, 4),
                                             200),
        "rs_10_4_1m": layer_cost.codec_times(rng, 10, 4, SHARD,
                                             (0, 5, 11), 50),
        "layers_alone": layer_cost.layers_us(),
        "layers_ab_rs_4_2_64k": layer_cost.layers_ab(rng, 4, 2, 16 << 10,
                                                     (1, 4)),
        "layers_ab_rs_10_4_1m": layer_cost.layers_ab(rng, 10, 4, SHARD,
                                                     (0, 5, 11), reps=20),
    }


STORE_STRIPES = 16        # bench.py's store_repair on a card (bench.py:548)
STORE_K, STORE_N = 10, 14
STORE_REPS = 3            # best of
LRC_STORM_STRIPES = 8     # bench.py's lrc storm (bench.py:611)
LRC_STORM_SHARD = 8 << 10
OBJECT_BYTES = 32 * MIB   # bench.py's object and convert sizes on a card
HOT_OBJECTS, HOT_BYTES = 12, 4 * MIB
PLACEMENT_BYTES = 8 * MIB
ENGINE_THREADS = ("noise-ec-repair", "noise-ec-scrub", "noise-ec-convert",
                  "placement-rebalance")


def store_counter(name: str, **labels) -> float:
    from noise_ec_tpu_torch.obs import default_registry

    return default_registry().counter(name).labels(**labels).value


def counted_run(by_run: dict, name: str, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after into ``by_run[name]``."""
    from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    by_run[name] = launch_counts()
    return out


def store_repair(rng, timer, by_run) -> dict:
    """bench.py:534-583 at its card sizes: RS(10,4), 16 stripes of 10 x
    1 MiB data shards (224 MiB held), shards 0 and 1 of every stripe
    dropped, then one ``Scrubber.run_cycle`` and one
    ``RepairEngine.drain_once``, which heal all 16 in one batched
    dispatch; best of STORE_REPS as GB/s, byte-equal, K5's launches and
    its product's device time (CUDA events) over the window. Returns the
    report and the live store for :func:`scrub_verify`."""
    from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix
    from noise_ec_tpu_torch.store import RepairEngine, Scrubber, StripeStore

    store = StripeStore()  # device="cuda"
    engine = RepairEngine(store, batch_min=2, max_batch=2 * STORE_STRIPES)
    scrub = Scrubber(store, engine, interval_seconds=3600.0)
    payloads = {}
    for i in range(STORE_STRIPES):
        sig = i.to_bytes(8, "little") + bytes(56)
        blob = rng.integers(0, 256, STORE_K * SHARD, dtype=np.uint8).tobytes()
        payloads[store.put_object(sig, blob, STORE_K, STORE_N)] = blob

    def break_and_repair() -> float:
        for key in payloads:
            store.drop_shard(key, 0)
            store.drop_shard(key, 1)
        b0 = store_counter("noise_ec_store_repair_batches_total")
        s0 = store_counter("noise_ec_store_repair_batch_stripes_total")
        t0 = time.perf_counter()
        scrub.run_cycle()
        healed = engine.drain_once()
        seconds = time.perf_counter() - t0
        check(healed == STORE_STRIPES,
              f"store repair healed {healed}/{STORE_STRIPES}")
        check(store_counter("noise_ec_store_repair_batches_total") == b0 + 1
              and store_counter("noise_ec_store_repair_batch_stripes_total")
              == s0 + STORE_STRIPES,
              "the store repair was one batched dispatch of every stripe")
        return seconds

    counted_run(by_run, "store_repair warm", break_and_repair)
    check(all(store.read(k) == b for k, b in payloads.items()),
          "store repair byte-equal")
    seconds = [counted_run(by_run, f"store_repair {i}", break_and_repair)
               for i in range(STORE_REPS)]
    check(all(store.read(k) == b for k, b in payloads.items()),
          "store repair byte-equal after the timed runs")
    launches = by_run["store_repair 0"]
    check(launches["fused_split"] > 0, "the store repair launched K5")
    rs = store.codec(STORE_K, STORE_N)
    dev = rs._dev
    R = reconstruction_matrix(rs.gf, rs.G, list(range(2, 12)), [0, 1])
    words = rand_words(rng, (STORE_STRIPES, STORE_K, TW), dev.device)
    product_ms = timer.median_ms(lambda: dev.matmul_words_batch(R, words))
    del words
    best = min(seconds)
    return {
        "geometry": [STORE_K, STORE_N], "stripes": STORE_STRIPES,
        "shard_bytes": SHARD, "held_bytes": STORE_STRIPES * STORE_N * SHARD,
        "route_for": dev.route_for(R), "seconds": seconds,
        "gbps": STORE_STRIPES * STORE_K * SHARD / best / 1e9,
        "k5_launches": launches["fused_split"],
        "k5_product_ms": product_ms,
        "k5_share": product_ms / 1e3 / best,
    }, (store, engine, scrub, payloads)


def scrub_verify(rng, timer, by_run, held) -> dict:
    """A clean scrub cycle over the 16 stripes (one (4,10) x (10, 16 MiB)
    parity product), then one byte of one parity shard flipped: the next
    cycle flags exactly that stripe once and ``repair_corrupt`` (the
    error-correcting restore on the host codec, as in the reference)
    restores its bytes."""
    store, engine, scrub, payloads = held
    f0 = store_counter("noise_ec_store_verify_failures_total")
    t0 = time.perf_counter()
    clean = counted_run(by_run, "scrub_verify clean", scrub.run_cycle)
    clean_ms = (time.perf_counter() - t0) * 1e3
    check(clean["flagged_corrupt"] == 0 and by_run["scrub_verify clean"][
        "fused_split"] > 0, f"a clean scrub cycle on K5 ({clean})")
    key = next(iter(payloads))
    want = store.snapshot(key)[1]
    check(store.corrupt_shard(key, STORE_K + 1, lambda b: bytes(
        [b[12345] ^ 0x40]).join((b[:12345], b[12346:]))),
        "one parity byte flipped")
    rot = counted_run(by_run, "scrub_verify rot", scrub.run_cycle)
    check(rot["flagged_corrupt"] == 1 and store_counter(
        "noise_ec_store_verify_failures_total") == f0 + 1,
        f"the rotten stripe flagged once ({rot})")
    fixed = engine.repair_corrupt(key)
    check(fixed and store.snapshot(key)[1] == want,
          "repair_corrupt restored the parity shard's bytes")
    check(scrub.run_cycle()["flagged_corrupt"] == 0, "clean after repair")
    rs = store.codec(STORE_K, STORE_N)
    words = rand_words(rng, (1, STORE_K, STORE_STRIPES * TW), rs._dev.device)
    product_ms = timer.median_ms(
        lambda: rs._dev.matmul_words_batch(rs.G[STORE_K:], words))
    del words
    return {"clean_cycle_ms": clean_ms, "flagged": rot["flagged_corrupt"],
            "route_for": rs._dev.route_for(rs.G[STORE_K:]),
            "k5_launches": by_run["scrub_verify clean"]["fused_split"],
            "k5_product_ms": product_ms, "restored": bool(fixed)}


def lrc_storm(rng, by_run) -> dict:
    """bench.py:593-636: RS(40,16) and then LRC(40,8,8), 8 stripes of 8
    KiB shards, one data loss a stripe, scrub then drain; the repair
    engine's ``shards_read{code}`` gives ``repair_fetch_amplification``
    (LRC reads a heal over RS reads a heal: exactly 0.125), each code's
    heal time and each matrix's route."""
    from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix
    from noise_ec_tpu_torch.store import RepairEngine, Scrubber, StripeStore

    k, g, n = 40, 8, 56
    out = {"stripes": LRC_STORM_STRIPES, "shard_bytes": LRC_STORM_SHARD}
    per_heal = {}
    for label, code in (("rs", "rs"), ("lrc", f"lrc:{g}")):
        store = StripeStore()
        engine = RepairEngine(store, linger_seconds=0.0,
                              max_batch=2 * LRC_STORM_STRIPES)
        scrub = Scrubber(store, engine, interval_seconds=3600.0)
        blobs = {}
        for i in range(LRC_STORM_STRIPES):
            sig = (0x4C52 + i).to_bytes(4, "little") + code.encode()
            blob = rng.integers(0, 256, k * LRC_STORM_SHARD,
                                dtype=np.uint8).tobytes()
            blobs[store.put_object(sig, blob, k, n, code=code)] = blob
        r0 = store_counter("noise_ec_store_repair_shards_read_total",
                           code=label)
        for key in blobs:
            store.drop_shard(key, 3)
        t0 = time.perf_counter()
        healed = counted_run(by_run, f"lrc_storm {label}",
                             lambda: (scrub.run_cycle(),
                                      engine.drain_once())[1])
        heal_s = time.perf_counter() - t0
        engine.close()
        check(healed == LRC_STORM_STRIPES,
              f"{label} storm healed {healed}/{LRC_STORM_STRIPES}")
        check(all(store.read(key) == b for key, b in blobs.items()),
              f"{label} storm byte-equal")
        check(sum(by_run[f"lrc_storm {label}"].values()) > 0,
              f"the {label} storm launched kernels")
        per_heal[label] = (store_counter(
            "noise_ec_store_repair_shards_read_total", code=label) - r0) / healed
        rs = store.codec(k, n, "gf256", code)
        # Shard 3's recovery from the other 39 data rows and its cell's
        # local parity (row 40), invertible for both codes.
        basis = [i for i in range(k + 1) if i != 3]
        lost_R = reconstruction_matrix(rs.gf, rs.G, basis, [3])
        out[label] = {"heal_seconds": heal_s, "reads_per_heal":
                      per_heal[label], "route_for": {
                          "parity": rs._dev.route_for(rs.G[k:]),
                          "rs_recovery": rs._dev.route_for(lost_R)}}
    amp = per_heal["lrc"] / per_heal["rs"]
    check(amp == 0.125, f"repair_fetch_amplification {amp} == 0.125")
    out["repair_fetch_amplification"] = amp
    return out


def object_node(port: int, **objects_kw):
    """One loopback node: store (on the card), repair engine, plugin,
    object service."""
    from noise_ec_tpu_torch.host.plugin import ShardPlugin
    from noise_ec_tpu_torch.host.transport import (
        LoopbackHub,
        LoopbackNetwork,
        format_address,
    )
    from noise_ec_tpu_torch.service import ObjectStore
    from noise_ec_tpu_torch.store import RepairEngine, StripeStore

    node = LoopbackNetwork(LoopbackHub(),
                           format_address("tcp", "localhost", port))
    store = StripeStore()
    engine = RepairEngine(store, network=node, linger_seconds=0.0)
    plugin = ShardPlugin(store=store)
    node.add_plugin(plugin)
    return ObjectStore(store, plugin, node, engine=engine, **objects_kw)


def convert_run(rng, by_run) -> dict:
    """bench.py:640-700 at its card size: a 32 MiB object in hot RS(10,4)
    stripes (k=10, n=14) of 1 MiB converted by the tenant policy
    ``archive=lrc:40/8+8,age=0,stripe_bytes=4194304``: the manifest's
    code is lrc:8 and the read is byte-equal, also with one data shard
    dropped from every archival stripe; MB/s."""
    from noise_ec_tpu_torch.service import TenantRegistry
    from noise_ec_tpu_torch.store import ConversionEngine

    tenants = TenantRegistry()
    tenants.configure("cold", policy="archive=lrc:40/8+8,age=0,"
                      f"stripe_bytes={4 * MIB}")
    objects = object_node(4000, tenants=tenants, stripe_bytes=MIB,
                          k=STORE_K, n=STORE_N)
    obj = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
    objects.put("cold", "glacier", obj)
    conv = ConversionEngine(objects.store, tenants, repair=objects.engine)
    t0 = time.perf_counter()
    stats = counted_run(by_run, "convert", conv.run_cycle)
    seconds = time.perf_counter() - t0
    check(stats["converted"] == 1, f"converted {stats}")
    doc = objects.resolve("cold", "glacier")
    check(doc.get("code") == "lrc:8", f"archival manifest {doc.get('code')}")
    check(objects.read("cold", "glacier") == obj, "converted read byte-equal")
    for key in doc["stripes"]:
        objects.store.drop_shard(key, 1)
    check(counted_run(by_run, "convert degraded read",
                      lambda: objects.read("cold", "glacier")) == obj,
          "degraded archival read byte-equal")
    check(by_run["convert"]["fused_split"] > 0, "the conversion launched K5")
    conv.close()
    objects.engine.close()
    rs = objects.store.codec(40, 56, "gf256", "lrc:8")
    return {"object_bytes": OBJECT_BYTES, "seconds": seconds,
            "mb_per_s": OBJECT_BYTES / seconds / 1e6,
            "archival_stripes": len(doc["stripes"]),
            "route_for": {"lrc_40_8_8_parity": rs._dev.route_for(
                rs.G[40:])}}


def objects_run(rng, by_run) -> dict:
    """bench.py:705-800 at its card sizes: ``ObjectStore`` at 1 MiB
    stripes, RS(10,4); PUT of 32 MiB (best of 3 MB/s, distinct content a
    trial, the HBM watermark not shedding); GET with shards 0-3 dropped
    from every stripe (best of 3); then 12 objects of 4 MiB under a
    zipfian GET mix over a 512 MiB ``DecodedObjectCache`` (hit rate, hot
    MB/s); every byte checked."""
    import hashlib

    from noise_ec_tpu_torch.obs.device import hbm_snapshot
    from noise_ec_tpu_torch.service import DecodedObjectCache

    objects = object_node(3800, stripe_bytes=MIB, k=STORE_K, n=STORE_N)
    base = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
    objects.put("bench", "warm", base)
    hbm = hbm_snapshot()
    check(objects.shed_reason() is None,
          f"the HBM watermark admits a 32 MiB PUT ({hbm})")
    put_s, name, payload = [], None, None
    for trial in range(STORE_REPS):
        payload = base[trial + 1:] + bytes([trial]) * (trial + 1)
        name = f"obj{trial}"
        t0 = time.perf_counter()
        counted_run(by_run, f"objects put {trial}",
                    lambda: objects.put("bench", name, payload))
        put_s.append(time.perf_counter() - t0)
        check(objects.read("bench", name) == payload, "object put/get")
    check(by_run["objects put 0"]["fused_split"] > 0, "the PUT launched K5")
    doc = objects.resolve("bench", name)
    for key in set(doc["stripes"]):
        for shard in range(STORE_N - STORE_K):
            objects.store.drop_shard(key, shard)
    get_s = []
    for trial in range(STORE_REPS):
        t0 = time.perf_counter()
        got = counted_run(by_run, f"objects degraded get {trial}",
                          lambda: objects.read("bench", name))
        get_s.append(time.perf_counter() - t0)
        check(got == payload, "object degraded read byte-equal")
    check(by_run["objects degraded get 0"]["fused_split"] > 0,
          "the degraded GET launched K5")
    objects.engine.close()

    cache = DecodedObjectCache(max_bytes=512 * MIB)
    hot = object_node(3900, stripe_bytes=MIB, k=STORE_K, n=STORE_N,
                      cache=cache)
    digests = {}
    for i in range(HOT_OBJECTS):
        blob = rng.integers(0, 256, HOT_BYTES, dtype=np.uint8).tobytes()
        hot.put("bench", f"hot{i}", blob)
        digests[f"hot{i}"] = hashlib.blake2b(blob, digest_size=16).digest()
    cache.clear()
    draws = rng.zipf(1.1, size=32 + 96)
    for z in draws[:32]:
        hot.read("bench", f"hot{(int(z) - 1) % HOT_OBJECTS}")
    for i in range(HOT_OBJECTS):
        hot.read("bench", f"hot{i}")
    h0 = store_counter("noise_ec_object_cache_hits_total")
    m0 = store_counter("noise_ec_object_cache_misses_total")
    served, reads = 0, {}
    t0 = time.perf_counter()
    for z in draws[32:]:
        name_z = f"hot{(int(z) - 1) % HOT_OBJECTS}"
        _, total, chunks = hot.get_range("bench", name_z)
        reads[name_z] = list(chunks)
        served += total
    hot_s = time.perf_counter() - t0
    check(all(hashlib.blake2b(b"".join(v), digest_size=16).digest()
              == digests[k] for k, v in reads.items()),
          "hot cached reads byte-equal")
    hits = store_counter("noise_ec_object_cache_hits_total") - h0
    misses = store_counter("noise_ec_object_cache_misses_total") - m0
    hot.engine.close()
    return {
        "object_bytes": OBJECT_BYTES, "geometry": [STORE_K, STORE_N],
        "stripe_bytes": MIB, "hbm": hbm, "put_seconds": put_s,
        "put_mb_per_s": OBJECT_BYTES / min(put_s) / 1e6,
        "degraded_get_seconds": get_s,
        "degraded_get_mb_per_s": OBJECT_BYTES / min(get_s) / 1e6,
        "hot_objects": HOT_OBJECTS, "hot_object_bytes": HOT_BYTES,
        "hot_gets": len(draws) - 32, "hot_mb_per_s": served / hot_s / 1e6,
        "hit_rate": hits / max(1.0, hits + misses),
    }


def placement_run(rng, by_run) -> dict:
    """Six loopback nodes in six failure domains (RS(4,2) needs six,
    ``required_domains``), each with a ``TargetedDelivery`` on one ring
    (seed 0): node 0 PUTs an 8 MiB object at 1 MiB stripes; each data
    shard travels once, to its ring owner (the sends a stripe over n;
    ``noise_ec_placement_fanout_saved_total``); node 3 GETs the object
    through the gather tier, byte-equal. The nodes' directed surfaces
    (a directory of ring tokens, a cohort send, an owner's slot fetch)
    are the in-process stand-ins the reference's fleet lab gives its
    nodes."""
    from noise_ec_tpu_torch.obs.trace import trace_key
    from noise_ec_tpu_torch.placement import (
        PlacementRing,
        TargetedDelivery,
        Topology,
    )
    from noise_ec_tpu_torch.placement.ring import required_domains
    from noise_ec_tpu_torch.host.plugin import ShardPlugin
    from noise_ec_tpu_torch.host.transport import (
        LoopbackHub,
        LoopbackNetwork,
        format_address,
    )
    from noise_ec_tpu_torch.service import ObjectStore
    from noise_ec_tpu_torch.store import StripeStore

    k, n = 4, 6
    hub = LoopbackHub()
    tokens = [format_address("tcp", "localhost", 4400 + i) for i in range(6)]
    check(required_domains(k, n) == len(tokens), "RS(4,2) needs six domains")
    ring = PlacementRing(Topology.parse(";".join(
        f"domain=d{i}:{tok}" for i, tok in enumerate(tokens))), seed=0)
    nets, stores, services, sends = {}, {}, [], []
    for tok in tokens:
        net = LoopbackNetwork(hub, tok)
        store = StripeStore()
        plugin = ShardPlugin(store=store)
        net.add_plugin(plugin)
        plugin.placement = TargetedDelivery(ring, self_token=tok)
        nets[tok], stores[tok] = net, store
        services.append(ObjectStore(store, plugin, net, stripe_bytes=MIB,
                                    k=k, n=n, fetch_timeout_seconds=5.0))

    for tok, net in nets.items():
        def send_many_to(dest, msgs, _net=net):
            for m in msgs:
                sends.append((trace_key(m.file_signature), m.shard_number,
                              dest))
                nets[dest].deliver(m.marshal(), _net.id)
            return True

        def fetch(dest, key):
            _, shards, _ = stores[dest].snapshot(key)
            return {i: b for i, b in enumerate(shards) if b is not None}

        net.placement_directory = (
            lambda _tok=tok: {t: t for t in tokens if t != _tok})
        net.send_many_to = send_many_to
        net.placement_fetch = fetch

    def saved() -> float:
        return store_counter("noise_ec_placement_fanout_saved_total")

    s0 = saved()
    payload = rng.integers(0, 256, PLACEMENT_BYTES, dtype=np.uint8).tobytes()
    doc = counted_run(by_run, "placement put",
                      lambda: services[0].put("acme", "placed.bin", payload))
    stripes = doc["stripes"]
    for key in stripes:
        owners = ring.owners(key, n, k=k, alive=set(tokens))
        sent = [(num, dest) for skey, num, dest in sends if skey == key]
        want = [(num, owners[num]) for num in range(n)
                if owners[num] not in (None, tokens[0])]
        check(sorted(sent) == sorted(want),
              f"stripe {key}: each shard sent once, to its owner")
    data_sends = sum(1 for skey, _, _ in sends if skey in stripes)
    g0 = store_counter("noise_ec_object_read_route_total", route="gather")
    got = counted_run(by_run, "placement gather get",
                      lambda: services[3].read("acme", "placed.bin"))
    gathers = store_counter("noise_ec_object_read_route_total",
                            route="gather") - g0
    check(got == payload, "the gathered GET byte-equal")
    check(gathers > 0, "node 3 read through the gather tier")
    return {"nodes": len(tokens), "geometry": [k, n],
            "object_bytes": PLACEMENT_BYTES, "stripes": len(stripes),
            "data_sends_per_stripe_over_n": data_sends / len(stripes) / n,
            "fanout_saved": saved() - s0, "gather_stripes": gathers}


def store_cli(rng) -> dict:
    """Two CLI processes on the card, each with ``-store-dir``,
    ``-object-port 0`` and ``-scrub-interval 1``: a 32 MiB PUT over HTTP
    to A, a GET from B, B restarted from its store directory and a GET
    again, each byte-equal, with a ceiling on every wait."""
    import tempfile
    import urllib.error
    import urllib.request

    def object_url(node) -> str:
        node.wait_for("object service on ", NODE_WAIT_S)
        line = next(ln for ln in node.lines if "object service on " in ln)
        return line.split("object service on ")[1].split("/objects")[0]

    def get(url: str) -> bytes:
        deadline = time.monotonic() + NODE_WAIT_S
        while True:
            try:
                with urllib.request.urlopen(url, timeout=NODE_WAIT_S) as r:
                    return r.read()
            except urllib.error.HTTPError:
                check(time.monotonic() < deadline,
                      f"GET {url} within {NODE_WAIT_S:g} s")
                time.sleep(0.1)

    payload = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
    store_args = ("-object-port", "0", "-scrub-interval", "1")
    out = {"object_bytes": OBJECT_BYTES}
    with tempfile.TemporaryDirectory(prefix="noise_ec_store_") as tmp:
        pa, pb = free_ports(2)
        started = []
        try:
            t0 = time.perf_counter()
            b = CliNode(pb, "-store-dir", os.path.join(tmp, "b"), *store_args)
            started.append(b)
            url_b = object_url(b)
            a = CliNode(pa, "-store-dir", os.path.join(tmp, "a"),
                        "-peers", f"tcp://127.0.0.1:{pb}", *store_args)
            started.append(a)
            url_a = object_url(a)
            b.wait_for(f"registered peer tcp://127.0.0.1:{pa}", NODE_WAIT_S)
            out["start_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            req = urllib.request.Request(url_a + "/objects/acme/big.bin",
                                         data=payload, method="PUT")
            with urllib.request.urlopen(req, timeout=NODE_CLI_SEND_S) as r:
                check(r.status == 201, f"PUT answered {r.status}")
            out["put_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(get(url_b + "/objects/acme/big.bin") == payload,
                  "GET from B byte-equal")
            out["get_b_seconds"] = time.perf_counter() - t0
            b.stop()
            out["b_rc"] = b.proc.returncode
            t0 = time.perf_counter()
            b2 = CliNode(pb, "-store-dir", os.path.join(tmp, "b"),
                         "-object-port", "0")
            started.append(b2)
            url_b2 = object_url(b2)
            out["restart_seconds"] = time.perf_counter() - t0
            loaded = next(ln for ln in b2.lines if "stripes loaded" in ln)
            out["restart_stripes_loaded"] = int(
                re.search(r"(\d+) stripes loaded", loaded).group(1))
            t0 = time.perf_counter()
            check(get(url_b2 + "/objects/acme/big.bin") == payload,
                  "GET from the restarted B byte-equal")
            out["get_restarted_seconds"] = time.perf_counter() - t0
        finally:
            for node in started:
                node.stop()
        rcs = [node.proc.returncode for node in started]
    check(rcs == [0, 0, 0], f"every CLI node exited 0 ({rcs})")
    out["put_mb_per_s"] = OBJECT_BYTES / out["put_seconds"] / 1e6
    return out


def phase_store(rng, device) -> dict:
    """The stripe store, placement and the object service on the card
    (module docstring, phase ``store``): :func:`store_repair`,
    :func:`scrub_verify`, :func:`lrc_storm`, :func:`convert_run`,
    :func:`objects_run`, :func:`placement_run` and :func:`store_cli`,
    each run's launches on this phase's line (``by_run``); every engine
    closed and its thread joined."""
    import gc

    timer = Timer(device)
    by_run: dict = {}
    report = {"phase": "store", "nvidia_smi": nvidia_smi(), "runs": {}}
    runs = report["runs"]
    runs["store_repair"], held = store_repair(rng, timer, by_run)
    runs["scrub_verify"] = scrub_verify(rng, timer, by_run, held)
    held[1].close()
    del held
    runs["lrc_storm"] = lrc_storm(rng, by_run)
    runs["convert"] = convert_run(rng, by_run)
    runs["objects"] = objects_run(rng, by_run)
    runs["placement"] = placement_run(rng, by_run)
    runs["cli"] = store_cli(rng)
    del timer
    gc.collect()
    left = [t.name for t in threading.enumerate()
            if t.name in ENGINE_THREADS and t.is_alive()]
    check(not left, f"every engine thread joined ({left})")
    report["by_run"] = {name: {n: c for n, c in counts.items() if c}
                        for name, counts in by_run.items()}
    report["k5_launches"] = sum(c.get("fused_split", 0)
                                for c in by_run.values())
    check(report["k5_launches"] > 0, "the store phase launched K5")
    return report


CHAOS_MSGS = 200              # the reference soak's broadcast
CHAOS_MSG_BYTES = 64 << 10
CHAOS_GAP_S = 0.03            # between lines: the 6 s send window
CHAOS_SEED = 1234             # straddles the faults
# The proxy's schedule runs from its start in B, not from B's
# registration, so the send starts CHAOS_LEAD_S into it: the reset comes
# 2 s and the partition 4-6 s into the send, whenever B registered.
CHAOS_LEAD_S = 10.0
CHAOS_PROFILE = "drop=0.05,corrupt=0.01,reset@12,partition@14:2:b2a"
CHAOS_WAIT_S = 180.0          # delivery, and /healthz back to 200
FLEET_PROFILE = "peers=200,fanout=6,msgs=500,chat=0.9,object=0.1,chaos=lossy"
FLEET_STRAGGLER = ("peers=24,fanout=4,msgs=64,object=1,get=2,"
                   "object_bytes=8192,stripe_bytes=4096,k=4,n=8,chaos=clean,"
                   "domains@8,slow@2:120:30")
FLEET_SEED = 11


def scrape(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def family_total(text: str, family: str) -> float:
    """The sum of every sample of a counter family in an exposition."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


def launch_gauges(text: str) -> dict:
    """The nonzero ``noise_ec_kernel_launches{kernel}`` samples of an
    exposition, by kernel."""
    out = {}
    for line in text.splitlines():
        if line.startswith('noise_ec_kernel_launches{kernel="'):
            labels, value = line.rsplit(" ", 1)
            if float(value):
                out[labels.split('"')[1]] = int(float(value))
    return out


def http_status(url: str) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code
    except OSError:
        return 0


def e2e_outcomes(url: str) -> dict:
    """A node's end-to-end outcomes so far (its
    ``noise_ec_e2e_latency_seconds`` counts by ``outcome``)."""
    return {line.split('"')[1]: int(float(line.rsplit(" ", 1)[1]))
            for line in scrape(url + "/metrics").splitlines()
            if line.startswith('noise_ec_e2e_latency_seconds_count{outcome="')}


def http_body(url: str) -> str:
    """The body a GET of ``url`` returns, whatever its status."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.read().decode()


def log_value(node: CliNode, prefix: str):
    """The Python literal logged after ``prefix`` on the node's last line
    that holds it."""
    import ast

    for line in reversed(node.lines):
        if prefix in line:
            return ast.literal_eval(line.split(prefix, 1)[1].strip())
    check(False, f"node log line {prefix!r}")


def phase_chaos_obs(rng) -> dict:
    """Two port CLI processes on the card at RS(4,2) (module docstring,
    phase ``chaos_obs``): B dials A through ``-chaos-profile``, pulls A's
    spans (``-trace-peers``), federates both nodes' metrics
    (``-federate``) and saves what it receives (``-recv-dir``); both keep
    a stripe store and a flight recorder (``-incident-dir``), A announces
    its stripes. A broadcasts CHAOS_MSGS lines of 64 KiB while the proxy
    drops, corrupts, resets and partitions; every one must arrive
    byte-equal, ``/healthz`` of B must go 503 and back to 200, exactly one
    bundle must be written, the merged trace must hold both nodes, the
    fleet view must sum both nodes' counters and ``/diagnose`` answer;
    each node must launch K5, refuse nothing and stay closed."""
    import glob
    import hashlib
    import tempfile

    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                            b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)
    lines = [letters[rng.integers(0, len(letters), CHAOS_MSG_BYTES)]
             .tobytes().decode() for _ in range(CHAOS_MSGS)]
    names = {hashlib.blake2b(m.encode(), digest_size=8).hexdigest(): m
             for m in lines}
    check(len(names) == CHAOS_MSGS, "distinct chaos payloads")
    report = {"phase": "chaos_obs", "nvidia_smi": nvidia_smi(),
              "geometry": [4, 6], "messages": CHAOS_MSGS,
              "message_bytes": CHAOS_MSG_BYTES, "profile": CHAOS_PROFILE,
              "seed": CHAOS_SEED}
    with tempfile.TemporaryDirectory(prefix="noise_ec_chaos_") as tmp:
        pa, pb, ma, mb = free_ports(4)
        url_a = f"http://127.0.0.1:{ma}"
        url_b = f"http://127.0.0.1:{mb}"
        recv = os.path.join(tmp, "recv")
        merged = os.path.join(tmp, "merged.json")
        started = []
        seen: list = []
        stop = threading.Event()
        try:
            t0 = time.perf_counter()
            a = CliNode(pa, "-metrics-port", str(ma),
                        "-store-dir", os.path.join(tmp, "sa"),
                        "-announce-interval", "0.25",
                        "-incident-dir", os.path.join(tmp, "ia"))
            started.append(a)
            a.wait_for("flight recorder armed", NODE_WAIT_S)
            b = CliNode(pb, "-metrics-port", str(mb),
                        "-store-dir", os.path.join(tmp, "sb"),
                        "-recv-dir", recv,
                        "-incident-dir", os.path.join(tmp, "ib"),
                        "-chaos-profile", CHAOS_PROFILE,
                        "-chaos-seed", str(CHAOS_SEED),
                        "-trace-peers", url_a, "-collect-traces", merged,
                        "-collect-interval", "1",
                        "-federate", f"{url_a},{url_b}",
                        "-federate-interval", "1",
                        "-peers", f"tcp://127.0.0.1:{pa}")
            started.append(b)
            b.wait_for(f"-> tcp://127.0.0.1:{pa} (seed {CHAOS_SEED})",
                       NODE_WAIT_S)
            t_proxy = time.perf_counter()
            a.wait_for(f"registered peer tcp://127.0.0.1:{pb}", NODE_WAIT_S)
            report["start_seconds"] = time.perf_counter() - t0
            report["registered_proxy_s"] = time.perf_counter() - t_proxy
            before = {u: scrape(u + "/metrics") for u in (url_a, url_b)}

            def poll() -> None:
                while not stop.wait(0.1):
                    seen.append((time.perf_counter() - t0,
                                 http_status(url_b + "/healthz")))

            poller = threading.Thread(target=poll, daemon=True)
            poller.start()
            lead = t_proxy + CHAOS_LEAD_S - time.perf_counter()
            check(lead > 1.0, f"B registered {CHAOS_LEAD_S - lead:.1f} s "
                  f"into the proxy's schedule, before its faults")
            time.sleep(lead)
            t_send = time.perf_counter()
            for m in lines:
                a.send_line(m)
                time.sleep(CHAOS_GAP_S)
            report["send_seconds"] = time.perf_counter() - t_send

            def received() -> set:
                try:
                    return set(os.listdir(recv))
                except FileNotFoundError:
                    return set()

            deadline = time.monotonic() + CHAOS_WAIT_S
            while not (len(received() & set(names)) == CHAOS_MSGS
                       or not all(n.proc.poll() is None for n in started)):
                # What B got and logged, for the failure's message.
                check(time.monotonic() < deadline,
                      f"every chaos message delivered within "
                      f"{CHAOS_WAIT_S:g} s ({len(received() & set(names))}"
                      f"/{CHAOS_MSGS}; e2e outcomes {e2e_outcomes(url_b)}; "
                      f"B's last lines: {''.join(b.lines[-12:])}; A's: "
                      f"{''.join(a.lines[-6:])})")
                time.sleep(0.05)
            report["delivered_seconds"] = time.perf_counter() - t_send
            report["send_proxy_s"] = t_send - t_proxy
            got = received()
            check(got == set(names),
                  f"delivered {len(got & set(names))}/{CHAOS_MSGS}, "
                  f"{len(got - set(names))} wrong objects")
            for name, m in names.items():
                with open(os.path.join(recv, name), "rb") as f:
                    check(f.read() == m.encode(), "a chaos message byte-equal")
            deadline = time.monotonic() + CHAOS_WAIT_S
            while not (any(s == 503 for _, s in seen)
                       and seen[-1][1] == 200):
                if time.monotonic() > deadline:
                    # What B saw, for the failure's message.
                    flips = [round(t, 1) for t, st in seen if st == 503]
                    outcomes = e2e_outcomes(url_b)
                    check(False, "B's /healthz went 503 and back to 200 "
                          f"within {CHAOS_WAIT_S:g} s (503 polls "
                          f"{len(flips)}, first {flips[:1]}, last "
                          f"{flips[-1:]}, last poll {seen[-1:]}, e2e "
                          f"outcomes {outcomes}, /healthz "
                          f"{http_body(url_b + '/healthz?verbose=1')})")
                time.sleep(0.05)
            stop.set()
            poller.join(timeout=5)
            report["outcomes_b"] = e2e_outcomes(url_b)
            first = next(t for t, st in seen if st == 503)
            last = max(t for t, st in seen if st == 503)
            report["healthz"] = {"first_503_s": first, "last_503_s": last,
                                 "back_to_200_s": next(
                                     t for t, st in seen
                                     if t > last and st == 200),
                                 "polls": len(seen)}
            time.sleep(2.5)  # one more scrape cycle of the federator
            now = {u: scrape(u + "/metrics") for u in (url_a, url_b)}
            fleet = scrape(url_b + "/fleet/metrics")
            family = "noise_ec_kernel_calls_total"
            report["federated"] = {
                "family": family,
                "a": family_total(now[url_a], family),
                "b": family_total(now[url_b], family),
                "fleet": family_total(fleet, family),
            }
            fed = report["federated"]
            check(fed["a"] > 0 and fed["b"] > 0
                  and fed["fleet"] == fed["a"] + fed["b"],
                  f"/fleet/metrics sums both nodes' {family}: {fed}")
            diagnose = json.loads(scrape(url_b + "/diagnose"))
            check({"verdicts", "trigger", "healthy"} <= set(diagnose),
                  "/diagnose answered")
            report["diagnose_verdicts"] = [v["verdict"]
                                           for v in diagnose["verdicts"]]
            report["calls"] = {}
            for name, url in (("a", url_a), ("b", url_b)):
                calls = (family_total(now[url], family)
                         - family_total(before[url], family))
                report["calls"][name] = calls
                refused = family_total(now[url],
                                       "noise_ec_codec_refused_total")
                fallback = family_total(now[url],
                                        "noise_ec_codec_fallback_total")
                state = family_total(now[url], "noise_ec_codec_circuit_state")
                check(refused == 0 and fallback == 0 and state == 0,
                      f"node {name} health clean (refused {refused}, "
                      f"fallbacks {fallback}, breaker state {state})")
            check(report["calls"]["a"] > 0 and report["calls"]["b"] > 0,
                  f"both nodes ran device products ({report['calls']})")
            # Each node's kernel launches, from its /metrics.
            report["launches"] = {name: launch_gauges(now[url])
                                  for name, url in (("a", url_a),
                                                    ("b", url_b))}
        finally:
            stop.set()
            for node in started:
                node.stop()
        rcs = [node.proc.returncode for node in started]
        check(rcs == [0, 0], f"both chaos CLI nodes exited 0 ({rcs})")
        report["chaos"] = log_value(b, "chaos stats: ")
        ch = report["chaos"]
        check(ch["resets"] == 1 and ch["dropped"] > 0 and ch["corrupted"] > 0
              and ch["partitioned"] > 0, f"the proxy injected faults: {ch}")
        check(all(ln.get("fused_split", 0) > 0
                  for ln in report["launches"].values()),
              f"K5 launched on each node ({report['launches']})")
        bundles = sorted(glob.glob(os.path.join(tmp, "i*", "incident-*.json")))
        bundles = [p for p in bundles if not p.endswith(".trace.json")]
        check(len(bundles) == 1 and bundles[0].endswith("-flip.json"),
              f"exactly one incident bundle, on the flip ({bundles})")
        with open(bundles[0]) as f:
            bundle = json.load(f)
        report["bundle"] = {"trigger": bundle["trigger"],
                            "timeline": len(bundle["timeline"]),
                            "events": len(bundle.get("events") or []),
                            "verdicts": [v["verdict"] for v in (
                                bundle.get("diagnosis") or {}).get(
                                "verdicts", [])]}
        with open(merged) as f:
            doc = json.load(f)
        nodes = doc["otherData"]["nodes"]
        slices = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        check(len(nodes) == 2 and slices > 0,
              f"the merged trace holds both nodes ({nodes}, {slices} spans)")
        report["merged_trace"] = {"nodes": len(nodes), "spans": slices}
    return report


def phase_fleet() -> dict:
    """The fleet lab on the card (module docstring, phase ``fleet``): one
    ``FleetLab`` of FLEET_PROFILE with every peer's plugin and store on
    ``device="cuda"``, its report (delivery >= 0.999, sheds apart from
    losses, msgs/s, object MB/s, e2e p50/p99), K5's launches and device
    time from a torch.profiler trace of the run, the gate's peak depth,
    the threads and the peers' pinned staging bytes, the report JSON and
    its Perfetto trace; then the straggler drill (a slow owner, the hedged
    GET through ``placement_fetch``) on the card and on numpy peers, with
    its hedge counters and GET outcomes."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from noise_ec_tpu_torch.fleet import FleetLab, FleetProfile
    from noise_ec_tpu_torch.obs import default_registry
    from noise_ec_tpu_torch.ops.dispatch import device_gate

    report = {"phase": "fleet", "nvidia_smi": nvidia_smi(),
              "profile": FLEET_PROFILE, "seed": FLEET_SEED}
    by_run: dict = {}
    gate = device_gate()
    peak = [0, 0]  # the gate's depth, the process's threads
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.001):
            peak[0] = max(peak[0], gate.in_flight + gate.waiters)
            peak[1] = max(peak[1], threading.active_count())

    with tempfile.TemporaryDirectory(prefix="noise_ec_fleet_") as tmp:
        t0 = time.perf_counter()
        lab = FleetLab(FleetProfile.parse(FLEET_PROFILE), seed=FLEET_SEED,
                       device="cuda")
        try:
            lab.start()
            report["start_seconds"] = time.perf_counter() - t0
            devices = {str(fec._rs._dev.device) for p in lab.peers
                       for fec in p.plugin._fec_cache.values()}
            check(devices == {"cuda:0"},
                  f"every peer's codec is on the card ({devices})")
            threads0 = threading.active_count()
            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            # Device activity only: CUPTI records every kernel and copy
            # the run puts on the card, from any thread.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = counted_run(by_run, "lab", lab.run)
                torch.cuda.synchronize()
            stop.set()
            sampler.join(timeout=5)
            report["threads"] = {"before": threads0, "peak": peak[1]}
            # Pinned staging pages the peers' device codecs hold.
            codecs = [fec._rs._dev for p in lab.peers
                      for fec in p.plugin._fec_cache.values()]
            codecs += [rs._dev for p in lab.peers if p.store is not None
                       for rs in p.store._codecs.values()]
            pinned = [sum(b.numel() for stack in c._pool._free.values()
                          for b in stack) for c in codecs]
            report["staging_pinned_bytes"] = {
                "codecs": len(codecs), "total": sum(pinned),
                "max_codec": max(pinned)}
            path = os.path.join(tmp, "fleet.json")
            lab.write_report(path)
            doc = lab.write_trace(path + ".trace.json")
            report["report_bytes"] = os.path.getsize(path)
            report["trace_spans"] = sum(
                1 for e in doc["traceEvents"] if e.get("ph") == "X")
            kinds = sorted({type(e).__name__ for e in lab.errors})
            samples = sorted({f"{type(e).__name__}: {e}"[:100]
                              for e in lab.errors})[:4]
        finally:
            stop.set()
            lab.close()
        delivery = out["delivery"]
        check(delivery["rate"] >= 0.999,
              f"fleet delivery {delivery['rate']} >= 0.999 ({delivery})")
        device_kinds = {"CodecUnavailableError", "KernelBuildError",
                        "KernelLaunchError", "RuntimeError"}
        check(not device_kinds & set(kinds),
              f"no device failure among the fleet's errors ({kinds})")
        launches = by_run["lab"]
        k5 = launches.get("fused_split", 0)
        check(k5 > 0, "the fleet launched K5")
        prof_dev = {"k5_ms": 0.0, "k5_events": 0, "all_ms": 0.0,
                    "all_events": 0}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if not t:
                continue
            prof_dev["all_ms"] += t / 1e3
            prof_dev["all_events"] += ev.count
            if "split_kernel" in ev.key:
                prof_dev["k5_ms"] += t / 1e3
                prof_dev["k5_events"] += ev.count
        shape = FleetProfile.parse(FLEET_PROFILE)
        report["run"] = {
            "delivery": delivery, "shed": out["shed"],
            "msgs_per_s": out["msgs_per_s"], "objects": out["objects"],
            "latency_ms": out["latency_ms"], "duration_s": out["duration_s"],
            "sent": out["sent"], "by_kind": out["by_kind"],
            "chaos": out["chaos"], "errors": out["errors"],
            "error_kinds": kinds, "error_samples": samples,
            "backpressure_waits": out["backpressure_waits"],
            "object_put_mb_per_s": out["by_kind"].get("object", {}).get(
                "sent", 0) * shape.object_bytes / out["duration_s"] / 1e6,
            "gets": out["gets"], "verify_reads": out["verify_reads"],
        }
        report["k5_launches"] = k5
        report["launches"] = {n: c for n, c in launches.items() if c}
        # K5's device time over the run, from the trace; None where the
        # trace came back without device events.
        report["device_trace"] = prof_dev
        wall_ms = out["duration_s"] * 1e3
        report["k5_device_share"] = (prof_dev["k5_ms"] / wall_ms
                                     if prof_dev["k5_events"] else None)
        report["device_busy_share"] = (prof_dev["all_ms"] / wall_ms
                                       if prof_dev["all_events"] else None)
        report["gate_peak_depth"] = peak[0]

        # The straggler drill, on the card and then on numpy peers with
        # the same seed: the numpy run says what the lab's traffic gives
        # without the card.
        reg = default_registry()
        report["straggler"] = {"profile": FLEET_STRAGGLER}
        for name, kwargs in (("cuda", {"device": "cuda"}),
                             ("numpy", {"backend": "numpy"})):
            hedge0 = {key: reg.counter(f"noise_ec_hedge_{key}_total")
                      .labels().value
                      for key in ("requests", "wins", "cancelled", "late")}
            lab = FleetLab(FleetProfile.parse(FLEET_STRAGGLER),
                           seed=FLEET_SEED, **kwargs)
            try:
                lab.start()
                drill = counted_run(by_run, f"straggler {name}", lab.run)
            finally:
                lab.close()
            hedge = {key: int(drill["hedge"][key] - hedge0[key])
                     for key in hedge0}
            gets, reads = drill["gets"], drill["verify_reads"]
            objects = drill["by_kind"]["object"]
            report["straggler"][name] = {
                "hedge": hedge,
                "tenant_get_p99_ms": drill["tenant_get_p99_ms"],
                "gets": gets, "verify_reads": reads,
                "delivery": drill["delivery"],
                "placement": drill["placement"],
                "launches": {n: c for n, c in
                             by_run[f"straggler {name}"].items() if c},
            }
            check(hedge["requests"] > 0 and hedge["wins"] > 0,
                  f"the {name} straggler drill hedged ({hedge})")
            check(sum(gets.values()) > 0 and gets["bad"] == 0
                  and gets["failed"] == 0,
                  f"no {name} straggler GET failed or read wrong bytes "
                  f"({gets})")
            check(reads["ok"] == objects["expected"] > 0
                  and reads["bad"] == reads["failed"] == reads["missing"]
                  == 0,
                  f"every {name} straggler object read back from every "
                  f"expected receiver ({reads}, {objects})")
        check(by_run["straggler cuda"].get("fused_split", 0) > 0,
              "the straggler drill launched K5")
        check(sum(by_run["straggler numpy"].values()) == 0,
              "the numpy-peer drill launched no kernel")
    return report



def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--panel-sweep", action="store_true",
                        help="also time K7 and K5 under other tile shapes")
    parser.add_argument("--mxu-sweep", action="store_true",
                        help="also time K8 at every width and its probes")
    parser.add_argument("--dense-sweep", action="store_true",
                        help="also time K11 under other launch shapes and "
                        "its probes")
    parser.add_argument("--pack-sweep", action="store_true",
                        help="also time every pack by device time beside "
                        "a copy of its bytes")
    parser.add_argument("--out", help="also write every JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        _OUT.append(open(args.out, "w"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rng = np.random.default_rng(args.seed)
    sources = {
        "fused_encode": ("noise_ec_tpu_torch/csrc/fused.cu",
                         "noise_ec_tpu/ops/pallas_fused.py:145"),
        "pack_lanes": ("noise_ec_tpu_torch/csrc/pack.cu",
                       "noise_ec_tpu/ops/pallas_pack.py:230"),
        "gf2mm_sparse": ("noise_ec_tpu_torch/csrc/gf2mm.cu",
                         "noise_ec_tpu/ops/pallas_gf2mm.py:149"),
        "unpack_lanes": ("noise_ec_tpu_torch/csrc/pack.cu",
                         "noise_ec_tpu/ops/pallas_pack.py:249"),
        "gf2mm_panel": ("noise_ec_tpu_torch/csrc/panel.cu",
                        "noise_ec_tpu/ops/pallas_gf2mm.py:471"),
        "gf2mm_panel_acc": ("noise_ec_tpu_torch/csrc/panel.cu",
                            "noise_ec_tpu/ops/pallas_gf2mm.py:542"),
        "pack_lanes_blocked": ("noise_ec_tpu_torch/csrc/pack.cu",
                               "noise_ec_tpu/ops/pallas_pack.py:374"),
        "unpack_lanes_blocked": ("noise_ec_tpu_torch/csrc/pack.cu",
                                 "noise_ec_tpu/ops/pallas_pack.py:394"),
        "mxu_gf2": ("noise_ec_tpu_torch/csrc/mxu.cu",
                    "noise_ec_tpu/ops/mxu_gf2.py:55"),
        "pack_words16": ("noise_ec_tpu_torch/csrc/pack.cu",
                         "noise_ec_tpu/ops/pallas_pack.py:448"),
        "unpack_words16": ("noise_ec_tpu_torch/csrc/pack.cu",
                           "noise_ec_tpu/ops/pallas_pack.py:453"),
        "fused_split": ("noise_ec_tpu_torch/csrc/fused.cu",
                        "noise_ec_tpu/ops/pallas_fused.py:287"),
        "fused_split16": ("noise_ec_tpu_torch/csrc/fused.cu",
                          "noise_ec_tpu/ops/pallas_fused.py:287"),
        "fused_encode16": ("noise_ec_tpu_torch/csrc/fused.cu",
                           "noise_ec_tpu/ops/pallas_fused.py:145"),
        "pack_lanes16": ("noise_ec_tpu_torch/csrc/pack.cu",
                         "noise_ec_tpu/ops/pallas_pack.py:230"),
        "unpack_lanes16": ("noise_ec_tpu_torch/csrc/pack.cu",
                           "noise_ec_tpu/ops/pallas_pack.py:249"),
        "pack_lanes_blocked16": ("noise_ec_tpu_torch/csrc/pack.cu",
                                 "noise_ec_tpu/ops/pallas_pack.py:374"),
        "unpack_lanes_blocked16": ("noise_ec_tpu_torch/csrc/pack.cu",
                                   "noise_ec_tpu/ops/pallas_pack.py:394"),
        "pack_sublane": ("noise_ec_tpu_torch/csrc/pack.cu",
                         "noise_ec_tpu/ops/pallas_pack.py:76"),
        "unpack_sublane": ("noise_ec_tpu_torch/csrc/pack.cu",
                           "noise_ec_tpu/ops/pallas_pack.py:81"),
        "gf2mm_dense": ("noise_ec_tpu_torch/csrc/dense.cu",
                        "noise_ec_tpu/ops/pallas_gf2mm.py:67"),
        "gf2mm_dense_tiled": ("noise_ec_tpu_torch/csrc/dense.cu",
                              "noise_ec_tpu/ops/pallas_gf2mm.py:192"),
    }
    results = {
        name: {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "max_abs_err": 0}
        for name, (src, rep) in sources.items()
    }

    def timed(phase, *phase_args) -> dict:
        t0 = time.monotonic()
        before = obs_counts()
        report = phase(*phase_args)
        report.setdefault("seconds", time.monotonic() - t0)
        report["health"] = phase_health(before, report)
        emit(report)
        return report

    timed(phase_build)
    # One codec a field for the kernel phases, the main path's hardware
    # check, and their shared matrices' plans (RS(50,20), RS(200,56)).
    codecs = {"gf256": DeviceCodec(device=device),
              "gf65536": DeviceCodec(field="gf65536", device=device)}
    timed(phase_kernels, rng, device, results)
    timed(phase_panel_kernels, rng, device, results, codecs["gf256"],
          codecs["gf65536"])
    timed(phase_gf16_kernels, rng, device, results)
    timed(phase_split_kernels, rng, device, results, codecs["gf256"],
          codecs["gf65536"])
    timed(phase_dense_kernels, rng, device, results)
    timed(phase_words16_kernels, rng, device, results, codecs["gf65536"])
    main_path = timed(phase_main_path, rng, codecs)
    # The breaker's own paths and LRC print their launches on their own
    # lines; the kernels line keeps the main path's.
    timed(phase_resilience, rng)
    timed(phase_lrc, rng)
    timed(phase_times, rng, device, results)
    timed(phase_layer_cost, rng)
    timed(phase_panel_times, rng, device, results)
    timed(phase_gf16_times, rng, device, results)
    timed(phase_split_times, rng, device, results)
    timed(phase_words16_times, rng, device, results)
    timed(phase_dense_times, rng, device, results)
    timed(phase_fec_times, rng, device)
    timed(phase_mesh, rng, device)
    if args.panel_sweep:
        timed(phase_panel_sweep, rng, device)
    if args.mxu_sweep:
        timed(phase_mxu_sweep, rng, device)
    if args.dense_sweep:
        timed(phase_dense_sweep, rng, device)
    if args.pack_sweep:
        timed(phase_pack_sweep, rng, device)
    # The node and the store run last: their host threads, sockets and
    # large objects stay out of every timed phase's process state.
    timed(phase_node, rng, device)
    timed(phase_store, rng, device)
    timed(phase_chaos_obs, rng)
    timed(phase_fleet)
    kernels = []
    for name, res in results.items():
        res["launches"] = main_path["launches"][name]
        res["library_ms"] = None
        kernels.append(res)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
