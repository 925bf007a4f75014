"""Two real processes, one global mesh, on the CPU: the port's
``parallel/multihost.py`` over a gloo group on 127.0.0.1, four CPU
positions a process, running the reference worker's rounds
(tests/mh_worker.py) in tests/torch_mh_worker.py. The row axis spans both
processes, so the codeword is assembled by an all-gather that crosses the
process boundary; every round is held against the reference's
GoldenCodec. (The reference's own two-process test skips on a CPU: XLA's
CPU backend has no cross-process collectives.)"""

import os
import socket
import subprocess
import sys

import numpy as np

from noise_ec_tpu.golden.codec import GoldenCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, port: int) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(REPO, "tests", "torch_mh_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), "2",
             str(tmp_path / f"out{i}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env)
        for i in range(2)
    ]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        results.append((p.returncode, out, err))
    return results


def test_two_process_global_mesh_matches_golden(tmp_path):
    # _free_port can race another binder between close and bind: one
    # retry on a fresh port.
    for attempt in range(2):
        results = _run_workers(tmp_path, _free_port())
        if all(rc == 0 for rc, _, _ in results):
            break
        if attempt == 1:
            detail = "\n".join(f"--- worker {i} rc={rc}\n{err[-3000:]}"
                               for i, (rc, _, err) in enumerate(results))
            raise AssertionError(f"multihost workers failed:\n{detail}")
    outs = [np.load(tmp_path / f"out{i}.npz") for i in range(2)]
    for i, (_, out, _) in enumerate(results):
        assert f"MULTIHOST-OK proc={i}" in out, out
    for key in ("parity", "syndrome", "decode1"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    words = outs[0]["words"]
    k, r, B = 10, 8, 2
    g = GoldenCodec(k, k + r)
    for b in range(B):
        np.testing.assert_array_equal(
            np.ascontiguousarray(outs[0]["parity"][b]).view(np.uint8),
            np.asarray(g.encode(np.ascontiguousarray(words[b])
                                .view(np.uint8))))
    # The syndrome localizes the corrupted copies (object 1 of each of
    # the four repeats), and equals the golden [G_parity | I] product.
    full = outs[0]["full"]
    s_out = outs[0]["syndrome"]
    np.testing.assert_array_equal(np.nonzero(s_out.any(axis=(1, 2)))[0],
                                  [1, 3, 5, 7])
    aug = np.concatenate([g.G[k:], np.eye(r, dtype=g.G.dtype)], axis=1)
    from noise_ec_tpu.matrix.hostmath import host_matvec

    for b in range(2):
        np.testing.assert_array_equal(s_out[b],
                                      host_matvec(g.gf, aug, full[b]))
    # decode1 corrects share 2 everywhere, consistency rows all zero.
    d_out = outs[0]["decode1"]
    data8 = np.concatenate([full[:, :k]] * 4, axis=0)
    data8[1::2, 2] ^= 0x5A  # the true data row of the corrupted copies
    np.testing.assert_array_equal(d_out[:, 0], data8[:, 2])
    assert not d_out[:, 1:].any()
