"""One mesh across processes over ``torch.distributed``.

Port of ``noise_ec_tpu.parallel.multihost``. The reference scales across
machines with its P2P transport (main.go:137-173, one node a host); the
device tier runs one program over a mesh whose devices live in several
processes. Here each process joins a ``torch.distributed`` group
(:func:`initialize`), the global device list is every process's devices in
rank order (:func:`global_mesh`), and the same builders of
``parallel/batch.py`` run unchanged: each process computes the blocks of
its own positions, and a row or batch axis that spans processes is
assembled by an all-gather over the group, so the codeword that comes
back is whole on every process.

The backend is NCCL where the process's devices are CUDA and gloo where
they are the CPU (``backend=`` overrides). Nothing falls back: if NCCL
cannot start on a CUDA process, :func:`initialize` raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from noise_ec_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    default_devices,
    make_mesh,
    reset_mesh_router,
)

__all__ = [
    "fetch_to_every_host",
    "global_devices",
    "global_mesh",
    "initialize",
    "replicate_to_global",
]

# (rank, device) of every position of the group, rank-major, set by
# initialize().
_global: list[tuple[int, torch.device]] = []


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *,
               local_devices: Optional[Sequence] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the group of ``num_processes`` as rank
    ``process_id``.

    ``coordinator_address`` is ``host:port`` of rank 0 (it binds it, the
    others dial it; ``init_method="tcp://<address>"``), the reference's
    coordinator. ``local_devices`` are this process's devices (default:
    its CUDA devices, or the CPU); a device may be listed more than once.
    The backend is NCCL for CUDA devices and gloo for the CPU unless
    ``backend`` names one. Every process's device list is exchanged, and
    the mesh router is reset, as the reference's is."""
    local = [torch.device(d) for d in (
        local_devices if local_devices is not None else default_devices())]
    if backend is None:
        backend = "nccl" if all(d.type == "cuda" for d in local) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    everyone: list = [None] * num_processes
    dist.all_gather_object(everyone, [str(d) for d in local])
    _global.clear()
    for rank, names in enumerate(everyone):
        _global.extend((rank, torch.device(n)) for n in names)
    reset_mesh_router()


def global_devices() -> list[tuple[int, torch.device]]:
    """(rank, device) of every position of the group, rank-major."""
    if not _global:
        raise RuntimeError("multihost.initialize has not run")
    return list(_global)


def global_mesh(axis_names: Sequence[str],
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every process's devices, rank-major over ``shape``: an
    axis longer than one process's devices spans processes, and its
    assembly crosses them."""
    ranks, devices = zip(*global_devices())
    return make_mesh(axis_names, shape, list(devices), list(ranks))


def replicate_to_global(arr: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """Host-identical ndarray -> the same bytes on this process's first
    device of ``mesh`` (uint32 words as int32, the port's word type).

    Every process must pass the same bytes (same seed, same file): a
    builder reads from it the blocks of this process's positions."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(mesh.home)


def fetch_to_every_host(x) -> np.ndarray:
    """A builder's or the router's output -> a full ndarray on this
    process. A builder's output is already whole on every process (its
    cross-process blocks arrive by the all-gather inside it), so this is
    the copy to the host."""
    if isinstance(x, ShardedBatch):
        x = x.to_tensor("cpu")
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)
