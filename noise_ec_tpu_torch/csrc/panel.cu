// K7: the block-panel K-tiled GF(2) matmul for wide geometries.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _make_panel_kernel and
// _make_panel_acc_kernel (one kernel here: `accumulate` selects the
// second). (B, C, 8, W8) planes -> (B, R, 8, W8) planes over the K tiles
// [lo, hi) of KT planes: out[r] = XOR over those planes c of bit (r, c) of
// the matrix times plane c. With `accumulate` the sum is XORed into `out`,
// which holds the earlier sub-launches' sum (the reference donates its
// accumulator to the output instead).
//
// Bound on the H100: operations. RS(200,56) at 1 MiB shards moves 256 MiB
// (0.08 ms at 3.35 TB/s); its factored network is ~150k XORs a plane word
// (0.29 ms), and the dense product this kernel runs is 448 x 1600 LOP3s a
// plane word (1.41 ms at 16.7e12 LOP3/s), so the logic pipes bound it. The
// kernel it replaces interpreted the factored network from shared-memory
// slots, three memory operations an XOR, at few resident threads (11.4 ms).
//
// Design: the product core (gf2tile.cuh, masked_kernel over the tiled
// operand, TiledMasks). A block owns `ncol` plane-word columns and one row
// group (up to 16 warps of 32 rows); its warps keep their rows'
// accumulators in registers and read the masks as broadcasts, so the
// logic pipes, not memory operations, set the pace. The ring stages
// K tile t+1's planes and masks with cp.async while tile t's product runs,
// and every warp of the block reads the one staged copy of the planes.
// Where the columns do not fill the card (RS(229,6) at 64 KiB shards:
// 2,048 words a plane), the launch splits the K tiles over `ksplit` blocks
// a column tile, which XOR their partial sums into the output atomically.
#include "gf2tile.cuh"

using namespace noise_ec::tile;

// `accumulate`: out already holds a sum to XOR into. With ksplit > 1 the
// caller has zeroed out (or it holds that sum) and the blocks XOR into it
// atomically.
extern "C" int ec_panel(const void* in, void* out, const void* masks,
                        int batch, long long P, int C, int R, int KT, int NT,
                        int NRG, int WR, int WC, int lo, int hi, int ksplit,
                        int accumulate, void* stream) {
  if (batch == 0 || P == 0 || R == 0 || hi <= lo) return cudaSuccess;
  if (P % 4 != 0) return (int)cudaErrorInvalidValue;
  const int mode = ksplit > 1 ? kAtomicXor : (accumulate ? kXor : kStore);
  const Operands a{(const uint32_t*)in, (uint32_t*)out,
                   (const uint32_t*)masks, P, P, 0, C, R, NT, lo, hi,
                   ksplit, mode};
  return launch_masked<4, TiledMasks>(a, KT, NRG, WR, WC, 1, batch, stream);
}
