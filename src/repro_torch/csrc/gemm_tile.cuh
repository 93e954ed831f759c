// gemm_tile.cuh: the port's one f32 GEMM body for Hopper (sm_90a), shared
// by tiled_matmul.cu (one product) and grouped_gemm.cu (a batch of
// products).
//
// What it computes.  For every product e of a batch (blockIdx.z):
// C[e] (M, N) f32 = A[e] (M, K) @ B[e] (K, N), all row-major and packed
// back to back, A and B both f32 or both bf16 (converted to f32 when
// staged), in IEEE f32 FMAs: no TF32.
//
// Summation order (a contract, not a detail).  Every C element is one f32
// accumulator that starts at 0 and takes fmaf(a[k], b[k], acc) for k = 0,
// 1, ..., K-1 in order; k past K adds fmaf(0, 0, acc) == acc.  No split-K,
// no partial sums merged later, no atomics.  So a product's C does not
// depend on the batch it is in (grouped_gemm(t, w)[e] is bitwise
// tiled_matmul(t[e], w[e])), nor on the copy path below, and it is bitwise
// that of the earlier body of 8-deep slices and plain loads.
//
// Design.  Every 128 x 128 C tile of every product is one block of 256
// threads, each holding an 8 x 8 register micro-tile; a loop over K inside
// the block stands in for the TPU kernels' sequential k grid axis.  The
// tiles are one linear grid axis (x, limit 2^31 - 1: no row-tile limit),
// the products grid z, outermost, so the tiles in flight share one
// product's A and B in L2.  Operands flow through a ring of kStages K
// slices in shared memory, filled by cp.async: while the block computes
// slice s, slices s+1 .. s+kStages-1 are in flight, with one __syncthreads
// a slice.  A slice is 128 x 32 of A, stored transposed (k-major), so one
// 16-byte shared read brings 4 rows of one k and a k step holds only 8 A
// and 8 B values in registers (4 16-byte shared reads for 64 FMAs); and
// 32 x 128 of B.  On the H100 (PERF.md) this beat A kept row-major
// (one 16-byte read of 4 k of a row, 32 A values held over 4 k steps: the
// FMA loop alone 6-8 % slower), and 2 stages of 32 k beat 3-6 stages of
// 16 k and 3 of 32 on the batched shape and tied on the single one (one
// barrier a 32-k slice; why 2 beat 3 is not measured).
//
// Copies.  A is transposed by the copy itself: one 4-byte cp.async an
// element, a warp covering 8 k of 4 rows (32-byte pieces of 4 rows in
// global memory, 32 different banks in shared memory).  B goes by 16-byte
// cp.async.cg when its rows (N) and the pointers of B and C are 16-byte
// aligned, else by 4-byte copies: chosen per launch, never per element.
// The 16-byte path earns its place: with only the 4-byte one, the body
// took 3.12 ms at 3,960^3 against 2.86 and 6.10 at 16 x 1,980^3 against
// 5.98 (ab_build's A/B turns on an NVIDIA H100 80GB HBM3 at 700.00 W;
// PERF.md, PR 17).
// bf16 operands are loaded and converted to f32 as they are staged (plain
// loads: cp.async cannot convert).  Ragged edges are zero-filled by the
// copy itself (source size 0: nothing is read), so edge tiles run the
// interior code; which rows and columns a thread copies is fixed when the
// block starts, copy addresses advance by pointer increments, and only
// the last slice, when K is no multiple of kBK, tests k.  C is stored
// once, 16 bytes at a time on the aligned path, masked at ragged edges.
//
// What bounds it on the H100: see tiled_matmul.cu and grouped_gemm.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace gemm_tile {

constexpr int kBM = 128;      // C tile rows
constexpr int kBN = 128;      // C tile columns
constexpr int kBK = 32;       // K slice depth
constexpr int kStages = 2;    // slices in the ring
constexpr int kThreads = 256; // 16 x 16, each an 8 x 8 micro-tile

// One ring stage, f32 whatever the operand type: A transposed, As[k][m],
// rows padded by 16 bytes (aligned 16-byte reads; the transposing writes
// of a warp hit 32 different banks), then B, Bs[k][n].
constexpr int kLda = kBM + 4;
constexpr int kAElems = kBK * kLda;
constexpr int kStageElems = kAElems + kBK * kBN;
constexpr size_t kRingBytes = size_t(kStages) * kStageElems * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or zeros where src_bytes == 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// One element into shared memory as f32, zero where !ok.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy1(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  float v = 0.f;
  if (ok) v = __bfloat162float(*src);
  *dst = v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// What one thread copies of every K slice.  A: NK x NR elements, k = kq +
// 8 jk of rows rq + 32 jr.  B: NB runs of VB elements, k rows RB apart,
// one column.
template <typename T, int VB>
struct Copier {
  static constexpr int NK = kBK / 8;             // A k values a thread
  static constexpr int NR = kBM / 32;            // A rows a thread
  static constexpr int CB = kBN / VB;            // copies per B row
  static constexpr int NB = kBK * CB / kThreads;
  static constexpr int RB = kThreads / CB;
  static_assert(kBK % 8 == 0 && kThreads == 256, "A copy plan");
  static_assert(kThreads % CB == 0 && NB >= 1, "B copy plan");

  const T* pa;        // this thread's first A element in the next slice
  const T* pb;        // ... and first B copy
  int64_t a_step;     // 32 rows of A
  int64_t b_step;     // RB rows of B
  int64_t b_slice;    // kBK rows of B
  uint32_t a_rows;    // bit jr: row rq + 32 jr lies below M
  bool b_col;         // the B columns lie left of N
  int kq, bk;         // first k of the A copies, of the B copies
  int sa, sb;         // their offsets in a stage

  __device__ __forceinline__ Copier(const T* a, const T* b, int M, int N,
                                    int K, int row0, int col0, int tid) {
    kq = tid % 8;
    const int rq = tid / 8;
    bk = tid / CB;
    const int bc = (tid % CB) * VB;
    pa = a + (int64_t)(row0 + rq) * K + kq;
    pb = b + (int64_t)bk * N + col0 + bc;
    a_step = (int64_t)32 * K;
    b_step = (int64_t)RB * N;
    b_slice = (int64_t)kBK * N;
    a_rows = 0;
#pragma unroll
    for (int jr = 0; jr < NR; ++jr)
      if (row0 + rq + 32 * jr < M) a_rows |= 1u << jr;
    b_col = col0 + bc < N;   // VB divides N on the 16-byte path
    sa = kq * kLda + rq;
    sb = kAElems + bk * kBN + bc;
  }

  // Issue the copies of the next slice into ``stage``; kleft = K minus the
  // slice's first k.  Only the last slice of a K that is no multiple of
  // kBK (kFull false) tests k.
  template <bool kFull>
  __device__ __forceinline__ void load(float* stage, int kleft) {
#pragma unroll
    for (int jr = 0; jr < NR; ++jr)
#pragma unroll
      for (int jk = 0; jk < NK; ++jk) {
        const bool ok = ((a_rows >> jr) & 1u) && (kFull || kq + 8 * jk < kleft);
        copy1(stage + sa + 8 * jk * kLda + 32 * jr, pa + jr * a_step + 8 * jk,
              ok);
      }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const bool ok = b_col && (kFull || bk + j * RB < kleft);
      if constexpr (VB == 1) {
        copy1(stage + sb + j * RB * kBN, pb + j * b_step, ok);
      } else {
        cp_async16(stage + sb + j * RB * kBN, pb + j * b_step, ok ? 16 : 0);
      }
    }
    pa += kBK;
    pb += b_slice;
  }

  __device__ __forceinline__ void load(float* stage, int kleft) {
    if (kleft >= kBK) {
      load<true>(stage, kleft);
    } else {
      load<false>(stage, kleft);
    }
  }
};

// kVec: 16-byte copies of B and stores of C (the host checked alignment).
// kBatched = false is the one-product body (blockIdx.z is not read).
template <typename T, bool kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            float* __restrict__ c, int M, int N, int K, int tiles_n) {
  extern __shared__ __align__(16) float ring[];

  if (kBatched) {  // this block's product of the packed batch
    const int64_t e = blockIdx.z;
    a += e * M * K;
    b += e * K * N;
    c += e * M * N;
  }
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / tiles_n) * kBM;
  const int col0 = (blockIdx.x % tiles_n) * kBN;

  Copier<T, kVec ? 4 : 1> copier(a, b, M, N, K, row0, col0, tid);
  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) copier.load(ring + s * kStageElems, K - s * kBK);
    cp_async_commit();
  }

  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int stage = 0;                  // slice s's stage
  int fill = kStages - 1;         // slice s + kStages - 1's stage
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice s landed
    __syncthreads();               // everyone's did, and slice s-1 is done
    if (s + kStages - 1 < nk)
      copier.load(ring + fill * kStageElems, K - (s + kStages - 1) * kBK);
    cp_async_commit();
    fill = fill + 1 == kStages ? 0 : fill + 1;

    const float* as = ring + stage * kStageElems + ty * 4;
    const float* bs = ring + stage * kStageElems + kAElems + tx * 4;
    stage = stage + 1 == kStages ? 0 : stage + 1;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = lds4(as + kk * kLda);
      const float4 a1 = lds4(as + kk * kLda + 64);
      const float4 b0 = lds4(bs + kk * kBN);
      const float4 b1 = lds4(bs + kk * kBN + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
    float* crow = c + (int64_t)r * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + h * 64 + tx * 4;
      if (kVec) {   // N % 4 == 0: the 4 columns are in or out together
        if (col < N)
          *reinterpret_cast<float4*>(crow + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) crow[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

// Above 48 KB a kernel may use only the dynamic shared memory it has been
// allowed with cudaFuncSetAttribute, a driver call.  Each instantiation
// makes it once a device, not at every launch, as in smm.cu and
// decode_attention.cu.  The record lives in an unnamed namespace, as
// there: the local static of a template with external linkage is one
// symbol for all libraries in the process, but each library has its own
// kernels, so tiled_matmul's record would stand for grouped_gemm's E == 1
// kernel, which then could not launch.
constexpr int kMaxDevices = 64;

namespace {

template <typename T, bool kVec, bool kBatched>
int launch_kernel(const T* a, const T* b, float* c, int E, int M, int N,
                  int K, cudaStream_t s) {
  static bool allowed[kMaxDevices] = {};
  const auto kernel = gemm_kernel<T, kVec, kBatched>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const int64_t tiles_n = (N + kBN - 1) / kBN;
  const int64_t tiles = tiles_n * ((M + kBM - 1) / kBM);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3((unsigned)tiles, 1, E), kThreads, kRingBytes, s>>>(
      a, b, c, M, N, K, (int)tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kBatched>
int launch_typed(const T* a, const T* b, float* c, int E, int M, int N,
                 int K, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {  // 16-byte copies of B, stores of C
    if (N % 4 == 0 && aligned16(b) && aligned16(c))
      return launch_kernel<T, true, kBatched>(a, b, c, E, M, N, K, s);
  }
  return launch_kernel<T, false, kBatched>(a, b, c, E, M, N, K, s);
}

template <typename T>
int launch_typed(const void* a, const void* b, void* c, int E, int M, int N,
                 int K, cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  float* cp = static_cast<float*>(c);
  return E == 1 ? launch_typed<T, false>(ap, bp, cp, E, M, N, K, s)
                : launch_typed<T, true>(ap, bp, cp, E, M, N, K, s);
}

// Launch the E products on ``stream``.  dtype: 0 = float32, 1 = bfloat16 (A
// and B); C is float32.  Returns a CUDA error code, 0 on success and when
// there is nothing to compute; E above 65,535 is refused by the launch.
inline int launch(const void* a, const void* b, void* c, int E, int M, int N,
                  int K, int dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(a, b, c, E, M, N, K, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, b, c, E, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gemm_tile
