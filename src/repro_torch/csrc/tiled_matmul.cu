// tiled_matmul: the densified path's dense GEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tiled_matmul/tiled_matmul.py:_matmul_kernel /
// tiled_matmul_pallas.
//
// What it computes.  C (M, N) f32 = A (M, K) @ B (K, N), A and B row-major
// and both f32 or both bf16 (converted to f32 on load), accumulated in
// IEEE f32 with FMA: no TF32, so the port's f32 parity policy holds.
//
// Design.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid with k innermost
// and carries an f32 VMEM accumulator from one k step to the next.  Here it
// is the one-product launch of the port's shared GEMM body (gemm_tile.cuh,
// also grouped_gemm.cu's): every 128 x 128 C tile is one thread block, all
// blocks run in parallel, a loop over K inside the block replaces the
// sequential k axis, and operands stream through a cp.async ring of 32-deep
// K slices in shared memory (A transposed by 4-byte copies, B by 16-byte
// copies where aligned).  Ragged edges are zero-filled by the copies, so
// the wrapper pads nothing.  Summation order: each C element is one fmaf
// chain over k = 0..K-1 from 0, so the result is bitwise grouped_gemm's
// for the same product and bitwise the earlier kernel's.  The one-product
// launch is its own instantiation, which does not read blockIdx.z: 5 %
// faster at 3,960^3 than the batched one (ab_build's A/B turns).
//
// What bounds it on the H100.  At the densified path's 3,960^3 the product
// is 1.24e11 flop on 188 MB, flop-bound: 1.85 ms at the 67 TFLOP/s f32
// (non-tensor) peak of the SXM part.  On an NVIDIA H100 80GB HBM3 at
// 700.00 W it runs within 5 % of torch.matmul (chip_smoke.py phase 3;
// each run's times are in PERF.md section 6, row 2), about 1.6 times
// faster than the earlier body (ab_build's A/B turns).  Copy-only and
// arithmetic-only builds (PERF.md, PR 17) show the FMA loop alone taking
// about nine tenths of the time: FMA issue bounds it (4 16-byte shared
// reads per 64 FMAs), on top of 961 tiles in 3.64 waves of 264 blocks (2
// an SM), the last wave 64 % full.

#include "gemm_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A and B); C is float32.
int tiled_matmul_launch(const void* a, const void* b, void* c, int M, int N,
                        int K, int dtype, void* stream) {
  return gemm_tile::launch(a, b, c, 1, M, N, K, dtype, stream);
}

const char* tiled_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
