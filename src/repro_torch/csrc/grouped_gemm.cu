// grouped_gemm: the batched densified path's grouped GEMM for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/grouped_gemm/grouped_gemm.py:_gg_kernel /
// grouped_gemm_pallas.
//
// What it computes.  out (E, C, f) f32 = tokens (E, C, d) @ weights (E, d, f)
// for every group e, all row-major and contiguous, tokens and weights both
// f32 or both bf16 (converted to f32 on load), accumulated in IEEE f32 with
// FMA: no TF32.  In the batched multiply, group e is product e of a fused
// bucket: (G, ml, kl) @ (G, kl, nl).
//
// Design.  The Pallas kernel walks the grid (E, C/bc, f/bf, d/bk) with E
// outermost and d innermost, all in order on one core, and carries a VMEM
// f32 accumulator across the d steps; its wrapper pads C, d and f to tile
// multiples.  Here every (group, C tile, f tile) is one thread block, with
// blockIdx.z the group (outermost, so the blocks in flight share one
// group's operands in L2), and a K loop inside the block replaces the d
// axis: the body is the port's shared GEMM (gemm_tile.cuh, also
// tiled_matmul.cu's), 128 x 128 C tiles of 8 x 8 register micro-tiles fed
// by a cp.async ring of 32-deep K slices.  Ragged C, d and f edges are
// zero-filled by the copies, so the wrapper pads nothing.  Summation order:
// each output element is one fmaf chain over d from 0, so out[e] is
// bitwise tiled_matmul(tokens[e], weights[e]), and a fused densified
// bucket bitwise the looped per-request multiplies.
//
// What bounds it on the H100.  At the batched path's 16 x 1,980^3 the batch
// is 2.48e11 flop on 753 MB: flop-bound, 3.71 ms at the 67 TFLOP/s f32
// (non-tensor) peak of the SXM part against 0.22 ms of bytes at 3.35 TB/s.
// On an NVIDIA H100 80GB HBM3 at 700.00 W it takes about 1.16 times
// torch.bmm's time (chip_smoke.py phase 3; each run's times are in PERF.md
// section 6, row 3), about 1.6 times faster than the earlier body
// (ab_build's A/B turns).  Copy-only and arithmetic-only builds (PERF.md,
// PR 17) show the FMA loop alone taking 87 % of the time: FMA issue bounds
// it, and 1,980 in 16 tiles of 128 pads 7 % of the tile area.  Opt-in
// TF32/bf16 wgmma is later work.

#include "gemm_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (tokens and weights); out is float32.
int grouped_gemm_launch(const void* tokens, const void* weights, void* out,
                        int E, int C, int F, int D, int dtype, void* stream) {
  return gemm_tile::launch(tokens, weights, out, E, C, F, D, dtype, stream);
}

const char* grouped_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
