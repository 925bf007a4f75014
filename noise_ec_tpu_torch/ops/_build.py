"""Builds the CUDA kernels in ``csrc/`` and binds them with ctypes.

The sources ``csrc/*.cu`` become one shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a``), built at first
use into ``_build/`` (listed in ``.gitignore``) under a name keyed on a
hash of the sources and flags, so a checkout builds its own kernels and an
edited source is rebuilt. Each source compiles in its own ``nvcc``, all at
once, and one more links them. What ``ptxas`` printed for each source is
kept beside the library (``.ptxas.json``) and read back on a cached build,
so :data:`build_log` is filled either way. Without ``nvcc`` this raises:
there is no other route to the kernels. :func:`probe_library` builds the
timing probes of K8 and K11 (``csrc/mxu_probe.cu``,
``csrc/dense_probe.cu``) the same way, as a library of their
own.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`launch`
raises on anything but 0, since a refused launch never runs and no later
synchronise reports it. Both failures have a type of their own,
:class:`KernelBuildError` and :class:`KernelLaunchError` (each a
``RuntimeError``): the codec breaker (ops/dispatch.py) lets them
propagate as they are, neither retried nor counted as a breaker failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pack", "gf2mm", "fused", "panel", "dense", "mxu")
PROBE_SOURCES = ("mxu_probe", "dense_probe")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Pointers and the stream as c_void_p: a bare Python int would be passed
# as a 32-bit int and cut the address.
_SIGNATURES = {
    "ec_pack_lanes": [_p, _p, _ll, _ll, _i, _i, _p],
    "ec_unpack_lanes": [_p, _p, _ll, _ll, _i, _i, _p],
    "ec_groups": [_i, _p, _p, _i, _i, _i, ctypes.c_uint, _i, _i, _i, _i, _i,
                  _i, _p],
    "ec_gf2mm": [_p, _p, _i, _ll, _i, _i, _p, _p, _p, _i, _i, _i, _p, _i, _i,
                 _p],
    "ec_gf2mm_dense": [_p, _p, _p, _i, _i, _ll, _ll, _ll, _i, _i, _i, _i, _i,
                       _i, _p],
    "ec_fused": [_p, _p, _i, _i, _i, _ll, _i, _i, _p, _p, _p, _p, _i, _i,
                 _i, _p, _i, _i, _p],
    "ec_fused_split": [_p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _i, _i,
                       _i, _i, _ll, _p, _ll, _p, _p],
    "ec_panel": [_p, _p, _p, _i, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                 _i, _p],
    "ec_mxu": [_p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _p],
}
_PROBE_SIGNATURES = {
    "ec_mxu_probe": [_p, _p, _p, _i, _i, _i, _ll, _i, _i, _i, _i, _i, _p],
    "ec_wgmma_peak": [_i, _i, _i, _p, _p],
    "ec_dense_probe": [_p, _p, _p, _i, _i, _ll, _ll, _ll, _i, _i, _i, _i, _i,
                       _i, _i, _p],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_probe_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or a compile or link step failed."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error: the launch was refused."""


# What the build of each source printed (nvcc -Xptxas=-v: registers,
# shared memory and spills per kernel), for chip_smoke.py.
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built"
    )


def set_build_dir(path) -> None:
    """Build and cache the libraries under ``path`` instead of the
    package's ``_build/`` (the node's ``-compile-cache-dir``). Takes
    effect for libraries not loaded yet in this process."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def build(sources: tuple = SOURCES,
          stem: str = "libnoise_ec_kernels") -> Path:
    """Build the library of ``sources`` unless this checkout's build exists;
    returns its path and fills :data:`build_log` with each source's
    ``ptxas`` output. Raises with nvcc's output when a step fails."""
    nvcc = nvcc_path()
    h = hashlib.sha256(" ".join((nvcc,) + FLAGS + sources).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode() + path.read_bytes())
    target = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    log_path = target.with_suffix(".ptxas.json")
    # The log is written before the library, so a library has its log.
    if target.exists() and log_path.exists():
        build_log.update(json.loads(log_path.read_text()))
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = {name: BUILD_DIR / f"{name}.{tag}.o" for name in sources}
    procs = {
        name: subprocess.Popen(
            [nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, obj in objs.items()
    }
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{logs[name]}")
    build_log.update(logs)
    if not failed:
        tmp = target.with_suffix(f".{tag}")
        link = subprocess.run(
            [nvcc, *FLAGS, "-shared", "-o", str(tmp), *map(str, objs.values())],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            failed.append(f"link (rc {link.returncode}):\n{link.stdout}{link.stderr}")
        else:
            log_tmp = log_path.with_suffix(f".{tag}")
            log_tmp.write_text(json.dumps(logs))
            os.replace(log_tmp, log_path)
            os.replace(tmp, target)
    for obj in objs.values():
        obj.unlink(missing_ok=True)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return target


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _load(build(), _SIGNATURES)
            lib.ec_error_string.argtypes = [_i]
            lib.ec_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def probe_library() -> ctypes.CDLL:
    """The loaded library of K8's and K11's timing probes (built on first
    use)."""
    global _probe_lib
    with _lock:
        if _probe_lib is None:
            _probe_lib = _load(build(PROBE_SOURCES, "libnoise_ec_probes"),
                               _PROBE_SIGNATURES)
        return _probe_lib


def launch(fn: str, like, *args, lib: Optional[ctypes.CDLL] = None) -> None:
    """Run kernel entry ``fn`` (of ``lib``, default :func:`library`) on the
    device of tensor ``like``, on that device's current PyTorch stream
    (passed as the last argument); raise on a CUDA error."""
    lib = library() if lib is None else lib
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = library().ec_error_string(rc).decode()
        raise KernelLaunchError(f"{fn}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
