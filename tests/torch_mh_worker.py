"""Worker process for tests/test_torch_multihost.py — not collected by
pytest.

``python tests/torch_mh_worker.py PORT RANK NPROCS OUT.npz`` joins a gloo
group of NPROCS processes on 127.0.0.1:PORT with four CPU positions, builds
the port's global ("batch", "row") meshes and runs the reference worker's
three rounds (tests/mh_worker.py): the parity rows of a words batch with
the row axis across both processes (each process computes four row
slices; the all-gather over the group assembles the codeword), the
syndrome scan of a corrupted batch over the batch axis, and the decode1
fold. It saves what every round returned for the test to hold against the
reference's GoldenCodec, and prints one MULTIHOST-OK line.
"""

import sys

port, rank, nprocs, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from noise_ec_tpu_torch.parallel import multihost  # noqa: E402
from noise_ec_tpu_torch.parallel.batch import BatchCodec  # noqa: E402

multihost.initialize(f"127.0.0.1:{port}", nprocs, rank,
                     local_devices=["cpu"] * 4)
assert len(multihost.global_devices()) == 4 * nprocs

k, r = 10, 8  # one parity row a position of the 8-way row axis
bc = BatchCodec(k, r, device="cpu")
mesh = multihost.global_mesh(("batch", "row"), (1, 8))
local = sum(mesh.is_local(pos) for pos in np.ndindex(mesh.devices.shape))
assert local == 4, local
enc = bc.make_sharded_encoder_words(mesh, row_axis="row")

rng = np.random.default_rng(0xD15)  # the same seed in every process
B, TW = 2, 2560
words = rng.integers(0, 1 << 32, size=(B, k, TW),
                     dtype=np.uint64).astype(np.uint32)
gwords = multihost.replicate_to_global(words, mesh)
parity = multihost.fetch_to_every_host(enc(gwords)).view(np.uint32)

data_u8 = np.stack([np.ascontiguousarray(words[b]).view(np.uint8)
                    for b in range(B)])
full = np.concatenate(
    [data_u8, np.ascontiguousarray(parity).view(np.uint8).reshape(B, r, -1)],
    axis=1,
)
full[1, 2] ^= 0x5A  # object 1, data share 2, every column
aug = np.concatenate([bc.G[k:], np.eye(r, dtype=bc.G.dtype)], axis=1)
mesh2 = multihost.global_mesh(("batch", "row"), (8, 1))
gfull = multihost.replicate_to_global(np.concatenate([full] * 4, axis=0),
                                      mesh2)
syndrome = multihost.fetch_to_every_host(
    bc.make_sharded_matmul(mesh2, aug)(gfull))
decode1 = multihost.fetch_to_every_host(
    bc.make_sharded_decode1(mesh2, 2)(gfull))

np.savez(out, words=words, parity=parity, full=full, syndrome=syndrome,
         decode1=decode1)
print(f"MULTIHOST-OK proc={rank} checksum={int(parity.sum())}", flush=True)
dist.destroy_process_group()
