// smm: the small-matrix-multiply stack kernel (the paper's LIBCUSMM) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/smm/smm.py:_smm_kernel / smm_pallas_call.
//
// What it computes.  Over a size bin's flattened stack rows
// (a_idx, b_idx, c_idx[, valid]):   C[c] += valid * (A[a] @ B[b]),
// accumulated in f32 from f32 or bf16 blocks.  Rows with equal c_idx are
// contiguous (a "run"; stacks.py guarantees it), and every C block's run
// lies in exactly one stack, so one launch covers a whole size bin.
//
// Design.  The TPU kernel walks one triple per sequential grid step and
// keeps the C block resident in VMEM for the length of its run.  Here the
// grid is one thread block per run (run starts are computed on the host
// and cached in the executor plan).  The block seeds its accumulator in
// registers from C[c], adds each row's product in run order, and stores
// C[c] once: no atomics, so the result is deterministic and a fused
// (one launch per bin) and a looped (one launch per stack) execution are
// bitwise equal.  Rows with valid == 0 are skipped; the host never
// launches a run made only of padding rows, which all point at one
// scratch block and would race on it.  C is updated in place (the
// reference donates the C buffer: input_output_aliases={3: 0}).
//
// Per row the A and B blocks are staged in shared memory (converted to
// f32 on load) in TK-deep slices, and each of the 256 threads computes an
// RM x RN register micro-tile of the TM x TN C tile.  Blocks larger than
// the tile loop over C tiles and K slices inside the kernel.  Two tile
// shapes are instantiated: 32x32 (2x2 per thread) for blocks up to 32,
// 64x64 (4x4 per thread) for larger ones.  Element offsets are 64-bit.
//
// What bounds it on the H100.  At the paper's block 22 a row is 21,296
// flop on 3.9 KB of operands; both blocks are re-read from L2 by every run
// that uses them, and each row costs two __syncthreads.  The whole product
// (e.g. 3,960^2 at block 22: 1.2e11 flop, ~190 MB of operands and
// triples) is flop-bound against the 67 TFLOP/s f32 (non-tensor) peak, but
// this first kernel is latency-bound on the per-row shared-memory round
// trip; wgmma/TMA tiling over several rows at once is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
smm_runs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ c, const int* __restrict__ triples,
                const int* __restrict__ run_starts, int n_rows, int ncols,
                int bm, int bk, int bn) {
  constexpr int TM = 16 * RM;
  constexpr int TN = 16 * RN;
  __shared__ float As[TM][kTK + 1];
  __shared__ float Bs[kTK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // Slots outside a row's (tm x tk) / (tk x tn) slice feed only outputs
  // that are never stored; zero them once so they hold finite values.
  for (int e = tid; e < TM * (kTK + 1); e += kThreads) (&As[0][0])[e] = 0.f;
  for (int e = tid; e < kTK * TN; e += kThreads) (&Bs[0][0])[e] = 0.f;
  __syncthreads();

  const int start = run_starts[blockIdx.x];
  const int c_idx = triples[(int64_t)start * ncols + 2];
  const int64_t a_size = (int64_t)bm * bk;
  const int64_t b_size = (int64_t)bk * bn;
  float* cblk = c + (int64_t)c_idx * ((int64_t)bm * bn);

  for (int m0 = 0; m0 < bm; m0 += TM) {
    const int tm = min(TM, bm - m0);
    for (int n0 = 0; n0 < bn; n0 += TN) {
      const int tn = min(TN, bn - n0);

      // seed the accumulator from the incoming C block
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int r = ty + 16 * i;
          const int col = tx + 16 * j;
          acc[i][j] = (r < tm && col < tn)
                          ? cblk[(int64_t)(m0 + r) * bn + n0 + col]
                          : 0.f;
        }
      }

      for (int row = start; row < n_rows; ++row) {
        const int* t = triples + (int64_t)row * ncols;
        if (t[2] != c_idx) break;            // end of this C block's run
        if (ncols > 3 && t[3] == 0) continue;  // masked (padding) row
        const T* ablk = a + (int64_t)t[0] * a_size;
        const T* bblk = b + (int64_t)t[1] * b_size;

        float p[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) p[i][j] = 0.f;

        for (int k0 = 0; k0 < bk; k0 += kTK) {
          const int tk = min(kTK, bk - k0);
          for (int e = tid; e < tm * tk; e += kThreads) {
            const int r = e / tk;
            const int kk = e - r * tk;
            As[r][kk] = to_f32(ablk[(int64_t)(m0 + r) * bk + k0 + kk]);
          }
          for (int e = tid; e < tk * tn; e += kThreads) {
            const int kk = e / tn;
            const int col = e - kk * tn;
            Bs[kk][col] = to_f32(bblk[(int64_t)(k0 + kk) * bn + n0 + col]);
          }
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < tk; ++kk) {
            float av[RM], bv[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
            for (int j = 0; j < RN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < RN; ++j)
                p[i][j] = fmaf(av[i], bv[j], p[i][j]);
          }
          __syncthreads();
        }
        // C = C + A @ B, the reference's order of the two additions
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] += p[i][j];
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int r = ty + 16 * i;
          const int col = tx + 16 * j;
          if (r < tm && col < tn)
            cblk[(int64_t)(m0 + r) * bn + n0 + col] = acc[i][j];
        }
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, const void* triples,
            const void* run_starts, int n_runs, int n_rows, int ncols, int bm,
            int bk, int bn, cudaStream_t stream) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  float* cp = static_cast<float*>(c);
  const int* tp = static_cast<const int*>(triples);
  const int* rp = static_cast<const int*>(run_starts);
  if (bm <= 32 && bn <= 32) {
    smm_runs_kernel<T, 2, 2><<<n_runs, kThreads, 0, stream>>>(
        ap, bp, cp, tp, rp, n_rows, ncols, bm, bk, bn);
  } else {
    smm_runs_kernel<T, 4, 4><<<n_runs, kThreads, 0, stream>>>(
        ap, bp, cp, tp, rp, n_rows, ncols, bm, bk, bn);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A and B); C is always float32.
// triples: (n_rows, ncols) int32, ncols 3 or 4; run_starts: (n_runs,) int32.
int smm_process_runs(const void* a, const void* b, void* c,
                     const void* triples, const void* run_starts, int n_runs,
                     int n_rows, int ncols, int bm, int bk, int bn, int dtype,
                     void* stream) {
  if (n_runs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, c, triples, run_starts, n_runs, n_rows, ncols, bm, bk,
                  bn, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, c, triples, run_starts, n_runs, n_rows, ncols,
                          bm, bk, bn, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* smm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
