// K7: block-panel K-tiled GF(2) matmul — the wide-geometry XOR network.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _make_panel_kernel and
// _make_panel_acc_kernel (one kernel here: `accumulate` selects the second).
// (B, C, 8, W8) planes -> (B, R, 8, W8) planes; output row r is the XOR, over
// the K blocks pk in [pk_lo, pk_hi), of panel (r / RB, pk)'s program applied
// to input planes [pk*KB, (pk+1)*KB). The network is an operand, a
// PanelProgram (noise_ec_tpu_torch/ops/network.py): per panel a slotted op
// list, a row CSR and the slot of each panel-local input.
//
// Bound on the H100: operations. RS(200,56) at 1 MiB shards moves 256 MiB
// (0.08 ms at 3.35 TB/s) but runs ~150k factored XORs on each of 32,768
// plane words. In practice the interpreted network's latency bounds it
// (per op a warp-uniform program load, two shared-memory loads, a store),
// so the design buys resident threads. Design: one thread owns one
// plane-word position p, as in K4. The block's row block pr is the
// fastest-varying part of blockIdx.x, so the PR blocks that read the same
// input words run side by side and share them through L2. For each K block
// the thread stages the panel's used input words into their slots (loads
// coalesce: neighbouring threads take neighbouring words), runs the panel's
// ops, and XORs each row into its accumulator. Slots and accumulators live
// in shared memory laid out [slot][thread] (bank-conflict free). A thread
// touches only its own column, so the block never synchronises. With
// `accumulate` the accumulators start from `out` itself, which is updated
// in place (the reference donates its accumulator to the output instead).
#include "common.cuh"

namespace {

__global__ void panel_kernel(const uint32_t* __restrict__ in,
                             uint32_t* out, long long P, int C, int R, int KB,
                             int RB, int PK, int pk_lo, int pk_hi,
                             int accumulate, const int* __restrict__ ops,
                             const int* __restrict__ op_ptr,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ row_terms,
                             const int* __restrict__ in_slot, int n_slots) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int PR = (R + RB - 1) / RB;
  const int pr = blockIdx.x % PR;
  const long long p = (long long)(blockIdx.x / PR) * T + tid;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const uint32_t* src = in + b * C * P + p;
  uint32_t* dst = out + (b * R + (long long)pr * RB) * P + p;
  uint32_t* slots = smem;
  uint32_t* acc = smem + n_slots * T;
  const int rows = min(RB, R - pr * RB);
  for (int r = 0; r < rows; ++r) {
    acc[r * T + tid] = accumulate ? dst[(long long)r * P] : 0u;
  }
  for (int pk = pk_lo; pk < pk_hi; ++pk) {
    const int panel = pr * PK + pk;
    const int* slot_of = in_slot + (long long)panel * KB;
    const uint32_t* col = src + (long long)pk * KB * P;
    // Only planes a term of this panel reads have a slot, and padding
    // columns past C have none, so no load leaves the input.
    for (int c = 0; c < KB; ++c) {
      const int s = __ldg(slot_of + c);
      if (s >= 0) slots[s * T + tid] = __ldg(col + (long long)c * P);
    }
    const int op0 = __ldg(op_ptr + panel);
    noise_ec::run_ops(ops + 3LL * op0, __ldg(op_ptr + panel + 1) - op0, slots,
                      T, tid, nullptr, 0);
    for (int r = 0; r < rows; ++r) {
      acc[r * T + tid] ^= noise_ec::eval_row(row_ptr, row_terms,
                                             panel * RB + r, slots, T, tid,
                                             nullptr, 0);
    }
  }
  for (int r = 0; r < rows; ++r) dst[(long long)r * P] = acc[r * T + tid];
}

}  // namespace

extern "C" int ec_panel(const void* in, void* out, int batch, long long P,
                        int C, int R, int KB, int RB, int PK, int pk_lo,
                        int pk_hi, int accumulate, const void* ops,
                        const void* op_ptr, const void* row_ptr,
                        const void* row_terms, const void* in_slot,
                        int n_slots, int threads, void* stream) {
  if (batch == 0 || P == 0 || R == 0) return cudaSuccess;
  const size_t smem = (size_t)(n_slots + RB) * threads * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(panel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long PR = (R + RB - 1) / RB;
  const long long blocks = (P + threads - 1) / threads * PR;
  if (blocks > 0x7fffffffLL || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  panel_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, P, C, R, KB, RB, PK, pk_lo, pk_hi,
      accumulate, (const int*)ops, (const int*)op_ptr, (const int*)row_ptr,
      (const int*)row_terms, (const int*)in_slot, n_slots);
  return (int)cudaGetLastError();
}
