// smm: the small-matrix-multiply stack kernel (the paper's LIBCUSMM) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/smm/smm.py:_smm_kernel / smm_pallas_call.
//
// What it computes.  Over a size bin's flattened stack rows
// (a_idx, b_idx, c_idx[, valid]):   C[c] += valid * (A[a] @ B[b]),
// accumulated in f32 from f32 or bf16 blocks.  Rows with equal c_idx are
// contiguous (a "run"; stacks.py guarantees it), and every C block's run
// lies in exactly one stack, so one launch covers a whole size bin.  The
// host passes the first row of every run that holds a valid row (runs
// made only of padding all point at one scratch block and are never
// launched).  Each run has one owner, which seeds its sum from C[c], adds
// the rows' products in run order and stores C[c] once: no atomics, so a
// fused (one launch per bucket) and a looped (one launch per stack)
// execution are bitwise equal, and C is updated in place (the reference
// donates the C buffer: input_output_aliases={3: 0}).
//
// Summation order, the same in both kernels below and in every launch
// grouping: per row, p = fmaf chain over k = 0, 1, ... from 0; then
// acc += p, in run order -- the reference's c_out = c_out + prod.
//
// What bounds it on the H100.  At the paper's block 22 a row is 10,648
// FMAs on 3,872 bytes of operands (f32).  The blocks of a row are not
// reused by its run, so every row streams its two blocks from L2: 22.6 GB
// at 3,960^2 against 1.2e11 flop (1.85 ms at the 67 TFLOP/s f32
// non-tensor peak; f32 stays IEEE f32 on the FMA pipe, no TF32).  A
// thread block that stages each row synchronously between two
// __syncthreads is bound by that per-row round trip, not by L2 (~30 ms
// there on an H100, on a 32x32 tile of 256 threads, one 4-byte shared
// load per FMA).  This design removes the barriers and the round trip:
//
//   * bm, bn <= 32 (warp kernel): ONE WARP PER C RUN, kWarps warps a
//     thread block, grid ceil(n_runs / kWarps).  The C block lives in
//     the warp's registers for the whole run on an 8 x 4 lane grid, RM x
//     RN accumulators a lane (22 x 22: 3 x 6, 24 x 24 covered, 84 %
//     live).  Each warp owns a ring of kStages stages in shared memory;
//     a stage holds one row's A and B blocks, copied raw with cp.async
//     (16 bytes a copy where the block's address allows it, else 8 or 4;
//     bf16 blocks of odd element count fall back to plain 2-byte
//     copies).  Row r + kStages - 1 is in flight while row r's FMAs run;
//     the warp waits with cp.async.wait_group and __syncwarp, never with
//     a block barrier.  Operands are read with 8-byte shared loads (two
//     k of an A row, two columns of a B row): 4 FMAs a load at 22^3.
//     Two stages, not three: a row's FMAs (~2,000 cycles of a warp when
//     four share a scheduler) cover one row's copy, and the smaller ring
//     fits 6 thread blocks (24 warps) an SM instead of 4 (on an H100 at
//     3,960^2: 5.88 against 6.26 ms in A/B turns).
//   * larger blocks (block kernel): one thread block of 256 threads per
//     run, a 64 x 64 C tile (4 x 4 a thread, read with 16-byte shared
//     loads, 8 FMAs a load), and the K loop pipelined over (row, 64-deep
//     K slice) stages through a kBStages-deep cp.async ring with ONE
//     __syncthreads a stage, so one a row at block 64 (a 32-deep slice
//     took 10 % longer).  Blocks above 64 loop over C tiles.
//   * The triples of a run are read 32 rows at a time, one row a lane;
//     two ballots give the rows of the window that belong to the run and
//     are valid, so valid == 0 rows are skipped without being staged.
//
// What bounds it now (H100 80GB HBM3 at 700 W, 3,960^2 at block 22): the
// copies alone take 3.7 ms (22.6 GB at ~6 TB/s), the FMAs, shared loads
// and bookkeeping alone 4.4 ms, both together ~5.3 ms: instruction
// issue, with the L2 stream mostly hidden under it.  Fewer instructions
// a row (the 16 % of dead lane slots, the loads) come before sharing
// staged blocks between runs.
//
// bm = bk = bn = 22 (the warp kernel) and 64 (the block kernel) are
// compile-time instantiations, as LIBCUSMM specialises per (m, n, k);
// every other size runs a masked generic instantiation of the same body.
// Element offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // warp kernel: runs (warps) a thread block
constexpr int kStages = 2;      // warp kernel: stages of each warp's ring
constexpr int kLaneRows = 8;    // warp kernel: lane grid over the C block
constexpr int kLaneCols = 4;
constexpr int kBThreads = 256;  // block kernel: 16 x 16 threads
constexpr int kTile = 64;       // block kernel: C tile edge
constexpr int kTK = 64;         // block kernel: K slice
constexpr int kBStages = 3;     // block kernel: stages of the ring
constexpr int kMaxSmem = 232448;  // shared memory a block may use (227 KB)

// ---------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copies bypass L1 (.cg); 4- and 8-byte copies can only go
// through it (.ca).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copy_chunk(char* d, const char* s, int ch) {
  if (ch == 16) {
    cp_async<16>(d, s);
  } else if (ch == 8) {
    cp_async<8>(d, s);
  } else if (ch == 4) {
    cp_async<4>(d, s);
  } else {
    *reinterpret_cast<unsigned short*>(d) =
        __ldg(reinterpret_cast<const unsigned short*>(s));
  }
}

// Copy `bytes` contiguous bytes from global to shared memory in chunks of
// `ch` bytes spread over `nthreads` threads, with no division per chunk
// as stage_rows needs (the warp kernel's copies sit on its issue-bound
// path).  ch is 16, 8 or 4 (asynchronous) or 2 (plain loads and stores,
// for bf16 blocks that are not 4-byte aligned); it divides every address
// and length involved.
__device__ __forceinline__ void stage_bytes(char* dst, const char* src,
                                            int bytes, int ch, int tid,
                                            int nthreads) {
  for (int off = tid * ch; off < bytes; off += nthreads * ch)
    copy_chunk(dst + off, src + off, ch);
}

// Copy `rows` rows of `row_bytes` bytes (strides in bytes) from global to
// shared memory, as stage_bytes does.
__device__ __forceinline__ void stage_rows(char* dst, int dst_stride,
                                           const char* src,
                                           int64_t src_stride, int rows,
                                           int row_bytes, int ch, int tid,
                                           int nthreads) {
  const int per_row = row_bytes / ch;
  const int total = rows * per_row;
  for (int e = tid; e < total; e += nthreads) {
    const int r = e / per_row;
    const int off = (e - r * per_row) * ch;
    copy_chunk(dst + r * dst_stride + off, src + r * src_stride + off, ch);
  }
}

// ------------------------------------------------------ shared-memory reads

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// -------------------------------------------------------- the rows of a run

// Walks one run's valid rows in order, 32 triples a window (one a lane).
// Every lane of a warp sees the same sequence; in the block kernel every
// warp walks the same run, so the sequence is uniform over the block.
struct RunRows {
  const int* t;
  int ncols, n_rows, c_idx, lane;
  int base;       // first row of the window
  unsigned bits;  // window lanes still to hand out: in the run and valid
  bool last;      // the run ends inside this window
  int my_a, my_b;

  __device__ __forceinline__ void load(int first) {
    base = first;
    const int row = first + lane;
    bool in_run = false, ok = false;
    if (row < n_rows) {
      const int* p = t + (int64_t)row * ncols;
      my_a = p[0];
      my_b = p[1];
      in_run = p[2] == c_idx;
      ok = in_run && (ncols < 4 || p[3] != 0);
    }
    const unsigned run = __ballot_sync(0xffffffffu, in_run);
    // the run is the prefix of lanes before the first row outside it
    const unsigned prefix =
        run == 0xffffffffu ? run : (1u << (__ffs(~run) - 1)) - 1u;
    last = run != 0xffffffffu;
    bits = __ballot_sync(0xffffffffu, ok) & prefix;
  }

  __device__ __forceinline__ bool next(int& a, int& b) {
    while (bits == 0) {
      if (last) return false;
      load(base + 32);
    }
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    a = __shfl_sync(0xffffffffu, my_a, j);
    b = __shfl_sync(0xffffffffu, my_b, j);
    return true;
  }
};

__device__ __forceinline__ RunRows run_rows(const int* triples, int ncols,
                                            int n_rows, int start,
                                            int lane) {
  RunRows r;
  r.t = triples;
  r.ncols = ncols;
  r.n_rows = n_rows;
  r.c_idx = triples[(int64_t)start * ncols + 2];
  r.lane = lane;
  r.my_a = r.my_b = 0;
  r.load(start);
  return r;
}

// ------------------------------------------------------------- warp kernel

// Lane grid cover of a warp-kernel instantiation (BM = 0: generic <= 32).
__host__ __device__ constexpr int warp_rm(int BM) {
  return BM > 0 ? (BM + kLaneRows - 1) / kLaneRows : 32 / kLaneRows;
}
__host__ __device__ constexpr int warp_rn(int BN) {
  return BN > 0 ? (BN + kLaneCols - 1) / kLaneCols : 32 / kLaneCols;
}
__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// One stage: the A block, then the B block, each 16-byte aligned.  Lanes
// past the block's edge read up to kLaneRows*RM rows of A and kLaneCols*RN
// columns past B's last row; those values feed only slots that are never
// stored, and the regions are sized so the reads stay inside the stage.
__host__ __device__ constexpr int warp_a_region(int rm, int bk, int es) {
  return align16(kLaneRows * rm * bk * es);
}
__host__ __device__ constexpr int warp_stage(int rm, int rn, int bk, int bn,
                                             int es) {
  return warp_a_region(rm, bk, es) + align16((bk * bn + kLaneCols * rn) * es);
}

template <typename T, int BM, int BK, int BN>
__global__ void __launch_bounds__(kWarps * 32)
smm_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ c, const int* __restrict__ triples,
                const int* __restrict__ run_starts, int n_runs, int n_rows,
                int ncols, int bm_rt, int bk_rt, int bn_rt, int ch_a,
                int ch_b) {
  constexpr bool kFixed = BM > 0;
  constexpr int RM = warp_rm(BM);
  constexpr int RN = warp_rn(BN);
  constexpr int es = sizeof(T);
  const int bm = kFixed ? BM : bm_rt;
  const int bk = kFixed ? BK : bk_rt;
  const int bn = kFixed ? BN : bn_rt;
  extern __shared__ __align__(16) char smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int run = blockIdx.x * kWarps + warp;
  if (run >= n_runs) return;  // the whole warp; no block barrier follows

  const int a_region = warp_a_region(RM, bk, es);
  const int stage_size = warp_stage(RM, RN, bk, bn, es);
  char* ring = smem + warp * kStages * stage_size;
  const int a_bytes = bm * bk * es;
  const int b_bytes = bk * bn * es;

  const int start = run_starts[run];
  RunRows rows = run_rows(triples, ncols, n_rows, start, lane);
  const int r0 = (lane / kLaneCols) * RM;
  const int c0 = (lane % kLaneCols) * RN;
  float* cblk = c + (int64_t)rows.c_idx * bm * bn;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      acc[i][j] = (r0 + i < bm && c0 + j < bn)
                      ? cblk[(r0 + i) * bn + c0 + j]
                      : 0.f;

  // stage the next valid row of the run into `slot`; false when none is left
  auto issue = [&](int slot) -> bool {
    int ai, bi;
    if (!rows.next(ai, bi)) return false;
    char* st = ring + slot * stage_size;
    stage_bytes(st, reinterpret_cast<const char*>(a) + (int64_t)ai * a_bytes,
                a_bytes, ch_a, lane, 32);
    stage_bytes(st + a_region,
                reinterpret_cast<const char*>(b) + (int64_t)bi * b_bytes,
                b_bytes, ch_b, lane, 32);
    return true;
  };

  // Row n's copies are commit group n; a group is committed every
  // iteration (empty once the run is exhausted) so wait_group counts hold.
  int issued = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (issue(issued)) ++issued;
    cp_async_commit();
  }
  for (int r = 0; r < issued; ++r) {
    // the slot of row r + kStages - 1 held row r - 1, read before the
    // __syncwarp that ended the previous iteration
    if (issue(issued % kStages)) ++issued;
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const char* st = ring + (r % kStages) * stage_size;
    const T* As = reinterpret_cast<const T*>(st);
    const T* Bs = reinterpret_cast<const T*>(st + a_region);

    float p[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) p[i][j] = 0.f;

    if constexpr (kFixed) {
      // two k a load from an A row, two columns a load from a B row
      constexpr int KS = BK % 2 == 0 ? 2 : 1;
      constexpr int VB = (BN % 2 == 0 && RN % 2 == 0) ? 2 : 1;
#pragma unroll
      for (int k = 0; k < BK; k += KS) {
        float av[RM][KS];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const T* pa = As + (r0 + i) * BK + k;
          if constexpr (KS == 2) {
            const float2 v = ld2(pa);
            av[i][0] = v.x;
            av[i][KS - 1] = v.y;
          } else {
            av[i][0] = ld1(pa);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const T* pb = Bs + (k + kk) * BN + c0;
          float bv[RN];
#pragma unroll
          for (int j = 0; j < RN; j += VB) {
            if constexpr (VB == 2) {
              const float2 v = ld2(pb + j);
              bv[j] = v.x;
              bv[j + VB - 1] = v.y;
            } else {
              bv[j] = ld1(pb + j);
            }
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              p[i][j] = fmaf(av[i][kk], bv[j], p[i][j]);
        }
      }
    } else {
      for (int k = 0; k < bk; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = ld1(As + (r0 + i) * bk + k);
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = ld1(Bs + k * bn + c0 + j);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] += p[i][j];
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      if (r0 + i < bm && c0 + j < bn) cblk[(r0 + i) * bn + c0 + j] = acc[i][j];
}

// ------------------------------------------------------------ block kernel

// Stage layout: A slice kTile x kTK, then B slice kTK x kTile, rows padded
// by 16 bytes (4 f32 / 8 bf16) so rows start 16-byte aligned and the two
// rows a warp reads at once sit in different banks.
template <typename T>
struct BlockStage {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLda = kTK + kPad;
  static constexpr int kLdb = kTile + kPad;
  static constexpr int kABytes = kTile * kLda * sizeof(T);
  static constexpr int kBytes = kABytes + kTK * kLdb * sizeof(T);
};

template <typename T, int BM, int BK, int BN>
__global__ void __launch_bounds__(kBThreads, 2)
smm_block_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 float* __restrict__ c, const int* __restrict__ triples,
                 const int* __restrict__ run_starts, int n_rows, int ncols,
                 int bm_rt, int bk_rt, int bn_rt, int ch_a, int ch_b) {
  using G = BlockStage<T>;
  constexpr int es = sizeof(T);
  const int bm = BM > 0 ? BM : bm_rt;
  const int bk = BK > 0 ? BK : bk_rt;
  const int bn = BN > 0 ? BN : bn_rt;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int start = run_starts[blockIdx.x];
  const int n_ks = (bk + kTK - 1) / kTK;
  const int64_t a_size = (int64_t)bm * bk;
  const int64_t b_size = (int64_t)bk * bn;

  for (int m0 = 0; m0 < bm; m0 += kTile) {
    const int tm = min(kTile, bm - m0);
    for (int n0 = 0; n0 < bn; n0 += kTile) {
      const int tn = min(kTile, bn - n0);
      RunRows rows = run_rows(triples, ncols, n_rows, start, tid % 32);
      float* cblk = c + (int64_t)rows.c_idx * bm * bn;

      float acc[4][4], p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i;
          const int col = tx * 4 + j;
          acc[i][j] = (r < tm && col < tn)
                          ? cblk[(int64_t)(m0 + r) * bn + n0 + col]
                          : 0.f;
          p[i][j] = 0.f;
        }

      // stage (row, K slice) pairs in order: every row has n_ks slices
      int ks = n_ks, cur_a = 0, cur_b = 0;
      auto issue = [&](int slot) -> bool {
        if (ks == n_ks) {
          if (!rows.next(cur_a, cur_b)) return false;
          ks = 0;
        }
        const int k0 = ks * kTK;
        const int tk = min(kTK, bk - k0);
        char* st = smem + slot * G::kBytes;
        stage_rows(st, G::kLda * es,
                   reinterpret_cast<const char*>(
                       a + cur_a * a_size + (int64_t)m0 * bk + k0),
                   (int64_t)bk * es, tm, tk * es, ch_a, tid, kBThreads);
        stage_rows(st + G::kABytes, G::kLdb * es,
                   reinterpret_cast<const char*>(
                       b + cur_b * b_size + (int64_t)k0 * bn + n0),
                   (int64_t)bn * es, tk, tn * es, ch_b, tid, kBThreads);
        ++ks;
        return true;
      };

      // stage q's copies are commit group q (empty groups once exhausted)
      int issued = 0;
#pragma unroll
      for (int s = 0; s < kBStages - 1; ++s) {
        if (issue(issued)) ++issued;
        cp_async_commit();
      }
      for (int q = 0; q < issued; ++q) {
        cp_async_wait<kBStages - 2>();
        // stage q is visible to all, and every thread is done with stage
        // q - 1, whose slot the next copy reuses
        __syncthreads();
        if (issue(issued % kBStages)) ++issued;
        cp_async_commit();

        const char* st = smem + (q % kBStages) * G::kBytes;
        const T* As = reinterpret_cast<const T*>(st) + (ty * 4) * G::kLda;
        const T* Bs = reinterpret_cast<const T*>(st + G::kABytes) + tx * 4;
        const int slice = q % n_ks;
        const int tk = min(kTK, bk - slice * kTK);
        if (tk == kTK) {
#pragma unroll
          for (int k = 0; k < kTK; k += 4) {
            float av[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 v = ld4(As + i * G::kLda + k);
              av[i][0] = v.x;
              av[i][1] = v.y;
              av[i][2] = v.z;
              av[i][3] = v.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 v = ld4(Bs + (k + kk) * G::kLdb);
              const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  p[i][j] = fmaf(av[i][kk], bv[j], p[i][j]);
            }
          }
        } else {
          for (int k = 0; k < tk; ++k) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = ld1(As + i * G::kLda + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ld1(Bs + k * G::kLdb + j);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);
          }
        }
        if (slice == n_ks - 1) {  // the row's product is complete
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] += p[i][j];
              p[i][j] = 0.f;
            }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // the next C tile's copies reuse every slot

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i;
          const int col = tx * 4 + j;
          if (r < tm && col < tn)
            cblk[(int64_t)(m0 + r) * bn + n0 + col] = acc[i][j];
        }
    }
  }
}

// ------------------------------------------------------------------ launch

// Above 48 KB a kernel may use only the dynamic shared memory it has been
// allowed with cudaFuncSetAttribute, a driver call.  Each instantiation
// keeps, per device, the largest size allowed so far, so the call is made
// once and not at every launch.
constexpr int kMaxDevices = 64;

template <typename T, int B, bool kWarp>
size_t* allowed_smem() {
  static size_t allowed[kMaxDevices] = {};
  return allowed;
}

cudaError_t allow_smem(size_t* allowed, const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

// The largest copy (16, 8, 4 or 2 bytes) that divides the base address
// and the stride between the starts of the rows copied.
int chunk(const void* base, int64_t stride_bytes) {
  const uint64_t x = (uint64_t)(uintptr_t)base | (uint64_t)stride_bytes;
  for (int ch = 16; ch >= 4; ch /= 2)
    if (x % ch == 0) return ch;
  return 2;
}

template <typename T, int B>
cudaError_t launch_warp(const T* a, const T* b, float* c, const int* tp,
                        const int* rp, int n_runs, int n_rows, int ncols,
                        int bm, int bk, int bn, size_t smem,
                        cudaStream_t stream) {
  auto kernel = smm_warp_kernel<T, B, B, B>;
  cudaError_t err = allow_smem(allowed_smem<T, B, true>(),
                               reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_runs + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      a, b, c, tp, rp, n_runs, n_rows, ncols, bm, bk, bn,
      chunk(a, (int64_t)bm * bk * sizeof(T)),
      chunk(b, (int64_t)bk * bn * sizeof(T)));
  return cudaGetLastError();
}

template <typename T, int B>
cudaError_t launch_block(const T* a, const T* b, float* c, const int* tp,
                         const int* rp, int n_runs, int n_rows, int ncols,
                         int bm, int bk, int bn, cudaStream_t stream) {
  auto kernel = smm_block_kernel<T, B, B, B>;
  const size_t smem = (size_t)kBStages * BlockStage<T>::kBytes;
  cudaError_t err = allow_smem(allowed_smem<T, B, false>(),
                               reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_runs, kBThreads, smem, stream>>>(
      a, b, c, tp, rp, n_rows, ncols, bm, bk, bn,
      chunk(a, (int64_t)bk * sizeof(T)), chunk(b, (int64_t)bn * sizeof(T)));
  return cudaGetLastError();
}

// bm, bn <= 32: the warp kernel, unless its ring would not fit (a very
// deep bk), then the block kernel, which takes any size.
template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, const void* triples,
                   const void* run_starts, int n_runs, int n_rows, int ncols,
                   int bm, int bk, int bn, cudaStream_t stream) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  float* cp = static_cast<float*>(c);
  const int* tp = static_cast<const int*>(triples);
  const int* rp = static_cast<const int*>(run_starts);
  constexpr int es = sizeof(T);
  if (bm <= 32 && bn <= 32) {
    if (bm == 22 && bk == 22 && bn == 22) {
      const size_t smem = (size_t)kWarps * kStages *
                           warp_stage(warp_rm(22), warp_rn(22), 22, 22, es);
      return launch_warp<T, 22>(ap, bp, cp, tp, rp, n_runs, n_rows, ncols, bm,
                                bk, bn, smem, stream);
    }
    const size_t smem = (size_t)kWarps * kStages *
                         warp_stage(warp_rm(0), warp_rn(0), bk, bn, es);
    if (smem <= (size_t)kMaxSmem)
      return launch_warp<T, 0>(ap, bp, cp, tp, rp, n_runs, n_rows, ncols, bm,
                               bk, bn, smem, stream);
  }
  if (bm == 64 && bk == 64 && bn == 64)
    return launch_block<T, 64>(ap, bp, cp, tp, rp, n_runs, n_rows, ncols, bm,
                               bk, bn, stream);
  return launch_block<T, 0>(ap, bp, cp, tp, rp, n_runs, n_rows, ncols, bm, bk,
                            bn, stream);
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
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, b, c, triples, run_starts, n_runs,
                                          n_rows, ncols, bm, bk, bn, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a, b, c, triples,
                                                  run_starts, n_runs, n_rows,
                                                  ncols, bm, bk, bn, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* smm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
