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
// and carries an f32 VMEM accumulator from one k step to the next.  Here
// every 128 x 128 C tile is one thread block, all blocks run in parallel,
// and a loop over K inside the block replaces the sequential k axis: the
// accumulator lives in registers (an 8 x 8 micro-tile per thread, 256
// threads) and is stored once.  Each K step stages a 128 x 8 slice of A
// (transposed) and an 8 x 128 slice of B in shared memory.  Ragged edges
// are masked in the kernel: out-of-range loads read zero and out-of-range
// stores are skipped, so the wrapper pads nothing.
//
// What bounds it on the H100.  At the densified path's 3,960^3 the product
// is 1.24e11 flop on 188 MB, flop-bound: 1.85 ms at the 67 TFLOP/s f32
// (non-tensor) peak of the SXM part.  This kernel does 64 FMA per 16
// shared-memory reads per thread and K step, with no double buffering of
// the global loads; tensor cores (TF32/bf16 wgmma, opt-in precision) and
// TMA pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;  // 16 x 16, each an 8 x 8 micro-tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K) {
  // A slice stored transposed (k-major); +4 keeps rows 16-byte aligned
  // and spreads the transposing stores over the banks.
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK;
      const int kk = e % kBK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(a[(int64_t)gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int cc = e % kBN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      Bs[kk][cc] = (gk < K && gc < N) ? to_f32(b[(int64_t)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < N) c[(int64_t)r * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A and B); C is float32.
int tiled_matmul_launch(const void* a, const void* b, void* c, int M, int N,
                        int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tiled_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K);
  } else if (dtype == 1) {
    tiled_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tiled_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
