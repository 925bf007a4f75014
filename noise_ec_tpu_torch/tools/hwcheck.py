"""Hardware kernel sweep: every dispatch tier, bit-exact against golden.

Port of ``noise_ec_tpu.tools.hwcheck``: the reference's 51 checks, each
under the reference's name, run on the port's kernels ON THE CARD — the
planned fused kernels (K1, K5), the lane pipeline (K2 -> K4 -> K3), the
sublane kernels (K9 -> K4 -> K9), the panel route (K6 -> K7 -> K6) and the
dense int8 product (K8), both fields, aligned and odd lengths, encode and
reconstruct matrices, the error-correcting decode's device entries and a
corrupted-share FEC decode — each against the NumPy golden codec (the
trust anchor: the codec IS what the node trusts, main.go:73-77).

Usage:
    python -m noise_ec_tpu_torch.tools.hwcheck [--out HWCHECK.json]
        [--device cuda]

``--device cpu`` runs the kernels' plain versions instead. Exit code 0 iff
every check passes; the JSON report lists each check and names the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Iterator, Optional


class _Rig:
    """What every check shares: the device, one ``DeviceCodec`` per field
    (so plans are shared), the data generator and the golden codecs."""

    def __init__(self, device: str, codecs: Optional[dict]):
        import numpy as np

        self.device = device
        self.codecs = dict(codecs or {})
        self.rng = np.random.default_rng(0x440C)

    def codec_for(self, field: str):
        from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

        if field not in self.codecs:
            self.codecs[field] = DeviceCodec(field=field, device=self.device)
        return self.codecs[field]

    def data_for(self, field, k, S):
        import numpy as np

        if field == "gf256":
            return self.rng.integers(0, 256, size=(k, S)).astype(np.uint8)
        return self.rng.integers(0, 1 << 16, size=(k, S)).astype(np.uint16)

    @staticmethod
    def golden(field, k, n):
        from noise_ec_tpu_torch.golden.codec import GoldenCodec

        return GoldenCodec(k, n, field=field)

    def words_of(self, rows):
        """Byte rows (length a multiple of 4) as int32 words on the card."""
        import numpy as np
        import torch

        return torch.from_numpy(np.ascontiguousarray(rows).view(
            np.int32)).to(self.codec_for("gf256").device)

    @staticmethod
    def bytes_of(words):
        import numpy as np

        return words.cpu().numpy().view(np.uint8)


def _checks(device: str = "cuda", *,
            codecs: Optional[dict] = None) -> Iterator[tuple[str, bool]]:
    """Yield (check name, passed). ``codecs`` maps a field to a
    ``DeviceCodec`` to run on, so a caller that has planned the same
    matrices shares its plans."""
    import numpy as np

    from noise_ec_tpu_torch.golden.codec import GoldenCodec
    from noise_ec_tpu_torch.matrix.generators import generator_matrix
    from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

    rig = _Rig(device, codecs)
    codec_for, data_for, golden = rig.codec_for, rig.data_for, rig.golden
    words_of, bytes_of = rig.words_of, rig.bytes_of

    # --- tier sweep through the public dispatch (the planner picks the
    # kernel: K5, else K1 or the pipeline; the panel route past its
    # bounds).
    geometries = [
        ("gf256", 4, 2),    # reference default RS(4,6), main.go:34-35
        ("gf256", 10, 4),   # north-star config
        ("gf256", 17, 3),   # high-rate streaming config
        ("gf256", 50, 20),  # wide streaming config (K5)
        ("gf65536", 10, 4),  # wide-field variant
    ]
    # Aligned, odd, and sub-quantum stripe lengths (the pad/slice path of
    # matmul_stripes).
    lengths = [8192, 8192 + 36, 1000, 131072]

    for field, k, r in geometries:
        dev = codec_for(field)
        G = generator_matrix(dev.gf, k, k + r, "cauchy")
        gold = golden(field, k, k + r)
        for S in lengths:
            if field == "gf65536" and S % 2:
                S += 1
            D = data_for(field, k, S)
            got = dev.matmul_stripes(G[k:], D)
            want = np.asarray(gold.encode(D))
            yield (
                f"encode {field} RS({k},{r}) S={S}",
                np.array_equal(got, want),
            )
        # Reconstruction matrices (the decode hot loop, main.go:77): erase
        # up to r shards, multiply by the inverse-submatrix rows. The
        # erasure counts are de-duplicated, as in the reference.
        D = data_for(field, k, 65536 if field == "gf256" else 32768)
        full = np.concatenate([D, np.asarray(gold.encode(D))], axis=0)
        for e in sorted({1, min(2, r), r}):
            erased = list(range(e))
            present = [i for i in range(k + r) if i not in erased][:k]
            R = reconstruction_matrix(dev.gf, G, present, erased)
            got = dev.matmul_stripes(R, full[present])
            yield (
                f"reconstruct {field} RS({k},{r}) erasures={e}",
                np.array_equal(got, full[erased]),
            )

    # --- forced fallback tiers (gf256 RS(10,4)): the planner normally
    # shadows these.
    from noise_ec_tpu_torch.ops.gf2mm import gf2_matmul_sparse, sparse_plan
    from noise_ec_tpu_torch.ops.pack import (
        lane_tl,
        pack_words_lanes,
        pack_words_sublane,
        unpack_words_lanes,
        unpack_words_sublane,
    )

    k, r = 10, 4
    dev = codec_for("gf256")
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    gold = golden("gf256", k, k + r)
    threads, prog = sparse_plan(dev.bits_rows_for(G[k:]), 8 * k)
    prog = prog.to(dev.device)
    D = data_for("gf256", k, 65536)
    want = np.asarray(gold.encode(D))
    words = words_of(D)
    TW = words.shape[1]

    # Tier 2: the three-kernel lane pipeline, K2 -> K4 -> K3.
    tl = lane_tl(TW)
    tiled = pack_words_lanes(words, tl)
    out = gf2_matmul_sparse(prog, tiled.reshape(k * 8, 8, -1), threads)
    got = bytes_of(unpack_words_lanes(out.reshape(r, 8, 8, -1), tl))
    yield ("tier2 lane pipeline gf256 RS(10,4)", np.array_equal(got, want))

    # Tier 3: the sublane kernels, K9 -> K4 -> K9 (plane (j, i) of the
    # sublane layout is row 8j + i of K4's input).
    planes = pack_words_sublane(words)
    W = planes.shape[2]
    out = gf2_matmul_sparse(prog, planes.reshape(k * 8, 8, W // 8), threads)
    got = bytes_of(unpack_words_sublane(out.reshape(r, 8, W)))
    yield ("tier3 sublane kernels gf256 RS(10,4)", np.array_equal(got, want))

    # --- batched words entry (one launch over the objects, the streaming
    # path).
    B = 4
    Db = np.stack([data_for("gf256", k, 32768) for _ in range(B)])
    wb = words_of(Db.reshape(B * k, -1)).reshape(B, k, -1)
    got_b = dev.matmul_words_batch(G[k:], wb).cpu().numpy()
    ok = all(
        np.array_equal(
            got_b[i].view(np.uint8).reshape(r, -1),
            np.asarray(gold.encode(Db[i])),
        )
        for i in range(B)
    )
    yield ("batched words encode gf256 RS(10,4) B=4", ok)

    # --- PAR1 generator variant.
    Gp = generator_matrix(dev.gf, k, k + r, "par1")
    gold_p = GoldenCodec(k, k + r, matrix="par1")
    D = data_for("gf256", k, 16384)
    yield (
        "encode gf256 RS(10,4) par1",
        np.array_equal(dev.matmul_stripes(Gp[k:], D),
                       np.asarray(gold_p.encode(D))),
    )

    # --- device syndrome route: the [A | I] augmented product behind
    # FEC(bw_route="device"), against the host formulation.
    from noise_ec_tpu_torch.matrix.bw import _syndrome

    m = k + r
    D = data_for("gf256", k, 65536)
    cw = np.concatenate([D, np.asarray(gold.encode(D))], axis=0)
    cw[1] ^= 0xA5  # whole-share corruption
    # basis = the k data rows, so A = G[extra] @ inv(I) = the parity rows.
    A = np.ascontiguousarray(G[k:], dtype=np.uint8)
    rows = [np.ascontiguousarray(cw[i]) for i in range(m)]
    host_s, host_counts = _syndrome(dev.gf, A, rows, k)
    dev_s, dev_counts = dev.syndrome_stripes(A, np.stack(rows))
    yield (
        "device syndrome gf256 RS(10,4) corrupt share",
        np.array_equal(dev_s, host_s) and np.array_equal(dev_counts,
                                                         host_counts),
    )

    # --- device decode1 fold: the single-corrupt-row decode as ONE
    # generator-shaped product — the corrected row equals the true data
    # row and every consistency row reads zero on pure whole-share
    # corruption; a mixed-corruption column is flagged nonzero.
    got_c, got_bad = dev.decode1_words(A, 1, words_of(cw))
    yield (
        "device decode1 fused fold gf256 RS(10,4)",
        np.array_equal(bytes_of(got_c), D[1])
        and not bool(got_bad.any()),
    )
    cw_mix = cw.copy()  # share 1 is ALREADY wholly corrupt (above)
    cw_mix[2, 100] ^= 0x3C  # a second error at one column -> mixed
    _, bad_mix = dev.decode1_words(A, 1, words_of(cw_mix))
    bad_bytes = bytes_of(bad_mix)
    yield (
        "device decode1 flags mixed-corruption columns gf256 RS(10,4)",
        bool(bad_bytes[100]) and not bad_bytes[:100].any(),
    )

    # --- full corrupted-share decode with the device route end to end.
    from noise_ec_tpu_torch.codec.fec import FEC, Share

    fec_dev = FEC(k, k + r, backend="device", bw_route="device",
                  device=device)
    payload = data_for("gf256", k, 8192)
    shares = fec_dev.encode_shares(payload.tobytes())
    bad = [
        Share(s.number, bytes(b ^ 0x3C for b in s.data))
        if s.number == 2 else s
        for s in shares
    ]
    yield (
        "device-route BW decode gf256 RS(10,4) corrupt share",
        fec_dev.decode(bad) == payload.tobytes(),
    )

    yield from _near_limit_checks(rig)

    # --- the int8 bit-plane encoder (K8) on its own.
    from noise_ec_tpu_torch.ops.mxu import MxuCodec

    mx = MxuCodec(dev.gf, device=device)
    for mk, mr_ in ((10, 4), (50, 20)):
        Gm = generator_matrix(dev.gf, mk, mk + mr_, "cauchy")
        Dm = data_for("gf256", mk, 6000)  # non-tile-aligned: pad path
        yield (
            f"mxu int8 encode gf256 RS({mk},{mr_})",
            np.array_equal(
                mx.encode_stripes(Gm[mk:], Dm),
                np.asarray(golden("gf256", mk, mk + mr_).encode(Dm)),
            ),
        )


def _near_limit_checks(rig: _Rig) -> Iterator[tuple[str, bool]]:
    """The RS(200,56) checks: minutes of planning and host arithmetic on a
    CPU."""
    import numpy as np

    from noise_ec_tpu_torch.codec.fec import FEC, Share
    from noise_ec_tpu_torch.matrix.bw import _syndrome
    from noise_ec_tpu_torch.matrix.generators import generator_matrix
    from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

    codec_for, data_for, golden = rig.codec_for, rig.data_for, rig.golden
    words_of, bytes_of = rig.words_of, rig.bytes_of
    dev = codec_for("gf256")

    # --- near-field-limit geometry: k <= n <= 256 is first-class contract
    # (NewFEC, main.go:248; the runtime geometry adjustment mints large
    # prime k, main.go:185-191), through the public dispatch: encode
    # against golden, erasure reconstruct, device syndrome, decode1, and a
    # corrupted-share FEC decode.
    kL, rL = 200, 56
    t_plan = time.time()
    GL = generator_matrix(dev.gf, kL, kL + rL, "cauchy")
    routes = (
        dev.route_for(GL[kL:]),
        dev.route_for(np.ascontiguousarray(GL[:3, :kL])),
    )
    t_plan = time.time() - t_plan
    # The port's routes, not the reference's ("mxu", "mxu"): the port
    # bounds its baked route by shared-memory fit over input byte rows
    # (227) and by XOR budgets (ops/dispatch.py), so the ~361k-XOR
    # parity network is within the panel budget (600k), and the (3, 200)
    # many-rows shape (here G's first three identity rows: no XORs over
    # 200 rows) stays baked. The bytes are the same whichever route runs
    # them (the checks below).
    yield (
        "near-limit RS(200,56) routes=(panel, baked), planning bounded",
        routes == ("panel", "baked") and t_plan < 30.0,
    )
    goldL = golden("gf256", kL, kL + rL)
    DL = data_for("gf256", kL, 8192)
    yield (
        "near-limit encode gf256 RS(200,56)",
        np.array_equal(
            dev.matmul_stripes(GL[kL:], DL), np.asarray(goldL.encode(DL))
        ),
    )
    fullL = np.concatenate([DL, np.asarray(goldL.encode(DL))], axis=0)
    erasedL = [0, 100, 199]
    presentL = [i for i in range(kL + rL) if i not in erasedL][:kL]
    RL = reconstruction_matrix(dev.gf, GL, presentL, erasedL)
    yield (
        "near-limit reconstruct 3 erasures gf256 RS(200,56)",
        np.array_equal(
            dev.matmul_stripes(RL, fullL[presentL]), DL[erasedL]
        ),
    )
    cwL = fullL.copy()
    cwL[7] ^= 0x2D  # corrupt data share 7 wholly
    AL = np.ascontiguousarray(GL[kL:], dtype=np.uint8)
    rowsL = [np.ascontiguousarray(cwL[i]) for i in range(kL + rL)]
    host_sL, host_cL = _syndrome(dev.gf, AL, rowsL, kL)
    dev_sL, dev_cL = dev.syndrome_stripes(AL, np.stack(rowsL))
    yield (
        "near-limit device syndrome gf256 RS(200,56)",
        np.array_equal(dev_sL, host_sL)
        and np.array_equal(dev_cL, host_cL),
    )
    cL, badL = dev.decode1_words(AL, 7, words_of(cwL))
    yield (
        "near-limit device decode1 (MXU route) gf256 RS(200,56)",
        np.array_equal(bytes_of(cL), DL[7]) and not bool(badL.any()),
    )
    # Wide field: the byte-sliced route over 400 byte rows, on K8.
    dev16L = codec_for("gf65536")
    G16L = generator_matrix(dev16L.gf, kL, kL + rL, "cauchy")
    D16L = data_for("gf65536", kL, 2048)
    yield (
        "near-limit encode gf65536 RS(200,56) (byte-sliced MXU)",
        dev16L.route_for(G16L[kL:]) == "mxu"
        and np.array_equal(
            dev16L.matmul_stripes(G16L[kL:], D16L),
            np.asarray(golden("gf65536", kL, kL + rL).encode(D16L)),
        ),
    )
    fecL = FEC(kL, kL + rL, backend="numpy")
    sharesL = fecL.encode_shares(DL.tobytes())
    badL = [
        Share(s.number, bytes(b ^ 0x3C for b in s.data))
        if s.number == 13 else s
        for s in sharesL
    ]
    yield (
        "near-limit FEC corrupted-share decode gf256 RS(200,56)",
        fecL.decode(badL) == DL.tobytes(),
    )


def run(device: str = "cuda", *, codecs: Optional[dict] = None,
        log=None) -> dict:
    """Run every check and return the report: ``ok``, ``checks`` (name and
    result each, in order), ``device`` (the card's name, or "cpu") and
    ``elapsed_s``. A check that raises propagates."""
    import torch

    t0 = time.time()
    results = []
    for name, ok in _checks(device, codecs=codecs):
        results.append({"check": name, "ok": bool(ok)})
        if log is not None:
            print(f"[{'ok' if ok else 'FAIL'}] {name}", file=log, flush=True)
    dev = torch.device(device)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ok": all(r["ok"] for r in results),
        "checks": results,
        "elapsed_s": time.time() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="HWCHECK.json", help="JSON report path")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu" for the plain versions')
    args = ap.parse_args(argv)
    report = run(args.device, log=sys.stderr)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"hwcheck": "ok" if report["ok"] else "FAIL",
                      "n": len(report["checks"]),
                      "device": report["device"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
