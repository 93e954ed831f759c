// gemm_tile.cuh: the port's one register-tiled f32 GEMM body for Hopper
// (sm_90a), shared by tiled_matmul.cu (one product) and grouped_gemm.cu (a
// batch of products).
//
// What it computes.  For every product e of a batch (blockIdx.z):
// C[e] (M, N) f32 = A[e] (M, K) @ B[e] (K, N), all row-major and packed
// back to back, A and B both f32 or both bf16 (converted to f32 on load),
// accumulated in IEEE f32 with FMA: no TF32.
//
// Design.  Every 128 x 128 C tile of every product is one thread block, all
// blocks run in parallel, and a loop over K inside the block takes the place
// of the TPU kernels' sequential k grid axis: the accumulator lives in
// registers (an 8 x 8 micro-tile per thread, 256 threads) and is stored
// once.  Each K step stages a 128 x 8 slice of A (transposed) and an 8 x 128
// slice of B in shared memory.  Ragged edges are masked in the kernel:
// out-of-range loads read zero and out-of-range stores are skipped, so the
// wrappers pad nothing.  This kernel does 64 FMA per 16 shared-memory reads
// per thread and K step, with no double buffering of the global loads;
// tensor cores (TF32/bf16 wgmma, opt-in precision) and TMA pipelining are
// later work.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace gemm_tile {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;  // 16 x 16, each an 8 x 8 micro-tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// kBatched = false is the one-product body (blockIdx.z is not read); the
// batched instantiation first moves the operand pointers to product
// blockIdx.z.  Measured on the H100 at 3,960^3, reading the offset in the
// one-product case costs ~9 % (PERF.md), hence two instantiations.
template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K) {
  // A slice stored transposed (k-major); +4 keeps rows 16-byte aligned
  // and spreads the transposing stores over the banks.
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  if (kBatched) {  // this block's product of the packed batch
    const int64_t e = blockIdx.z;
    a += e * M * K;
    b += e * K * N;
    c += e * M * N;
  }

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
    for (int el = tid; el < kBM * kBK; el += kThreads) {
      const int r = el / kBK;
      const int kk = el % kBK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(a[(int64_t)gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int el = tid; el < kBK * kBN; el += kThreads) {
      const int kk = el / kBN;
      const int cc = el % kBN;
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

template <typename T>
void launch_typed(const void* a, const void* b, void* c, int E, int M, int N,
                  int K, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  float* cp = static_cast<float*>(c);
  if (E == 1) {
    batched_gemm_kernel<T, false><<<grid, kThreads, 0, s>>>(ap, bp, cp, M, N, K);
  } else {
    batched_gemm_kernel<T, true><<<grid, kThreads, 0, s>>>(ap, bp, cp, M, N, K);
  }
}

// Launch the E products on ``stream``.  dtype: 0 = float32, 1 = bfloat16 (A
// and B); C is float32.  Returns cudaGetLastError() (0 when there is nothing
// to compute).
inline int launch(const void* a, const void* b, void* c, int E, int M, int N,
                  int K, int dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_typed<float>(a, b, c, E, M, N, K, s);
  } else if (dtype == 1) {
    launch_typed<__nv_bfloat16>(a, b, c, E, M, N, K, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm_tile
