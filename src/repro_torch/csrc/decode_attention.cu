// decode_attention: single-token attention over a KV cache for Hopper
// (sm_90a), the serving path's decode step.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py:_kernel /
// decode_attention_pallas (wrapper kernels/decode_attention/ops.py), and on
// the model path the jnp decode of src/repro/models/attention.py
// decode_attention.
//
// What it computes.  q (B, Hkv, R, Dh): the R query heads that share KV
// head h, grouped; k, v (B, S, Hkv, Dh), the cache, all f32 or all bf16;
// cur_len, one int32 on the device.  For every (b, h, r):
//   s_j = (q . k_j) * scale, or -1e30 for j >= cur_len
//   out = sum_j softmax(s)_j v_j        (B, Hkv, R, Dh), in q's dtype
// All arithmetic is f32; a bf16 output is the f32 result rounded to
// nearest even.  The denominator is floored at 1e-30.
//
// Rows past cur_len are never read.  For cur_len >= 1 a masked row's
// weight is exp(-1e30 - m) = 0 exactly in f32 (m is a real score), so
// only the rows [0, L), L = min(cur_len, S), take part.  With cur_len <= 0
// every score is -1e30, every weight exp(0) = 1, and the result is the
// mean of V over all S rows: then L = S and every score is -1e30.
//
// Design.  The TPU kernel walks the grid (B, Hkv, S/512) with the kv axis
// innermost and in order, carrying the online-softmax state in VMEM
// scratch; cur_len comes in by scalar prefetch.  Here:
//   * Split-KV over a thread-block cluster.  Each (b, h, query-row group)
//     is one cluster of `nsplit` CTAs (1-8, chosen on the host from the
//     shapes so that the grid covers the SMs several times).  [0, L) is
//     cut into 16-row tiles, the tiles into nsplit contiguous ranges, and
//     a CTA's range round-robin over its warps.  L is computed on the
//     device from cur_len, so the host never waits and a CUDA-graph
//     replay with a new cur_len is right.
//   * One warp, one run of tiles, its own online-softmax state; no block
//     barrier inside the row loop.  A tile's 16 rows of K and V are staged
//     raw (bf16 stays bf16) with cp.async into the warp's own 2-stage
//     ring (16-byte copies where the rows allow, else 8, 4, or plain
//     2-byte loads): the next tile is in flight while one is computed; the
//     warp waits with cp.async.wait_group and __syncwarp.  Rows of a tile
//     past L are zero-filled, never read.  Two stages, not three: the
//     smaller ring fits 3 CTAs (12 warps) an SM instead of 2 (on an H100
//     at B=8, S=4,096: 0.097 against 0.120 ms in A/B turns).
//   * Scores: two lanes per row (lane & 15 the row, lane >> 4 the half of
//     Dh), 16-byte reads of K from a row stride that puts eight rows in
//     distinct banks, q from shared memory (broadcast, zero-padded to the
//     16-byte chunk), one shuffle to join the halves; the tile's max by
//     four shuffles.  Weights go through a per-warp shared buffer to the
//     accumulate, where a lane owns DPL neighbouring output columns of
//     every query row in registers (KR x DPL floats; 6 x 4 for Qwen2).
//   * Query rows: a group of at most 8 rows per cluster (KR, a compile-time
//     bound); R > 8 (Granite's MQA, R = 48) is split into groups that read
//     the cache each, so registers stay bounded.
//   * Merge: each CTA merges its warps' (m, l, acc) in shared memory, the
//     cluster synchronises, and every CTA finalises a slice of the output
//     by reading the nsplit CTAs' partials through distributed shared
//     memory, in a fixed order: no workspace, no atomics, one launch, the
//     same bits on every run.
//
// What bounds it on the H100.  Decode reads the valid cache rows once:
// 2 * B*L*Hkv*Dh * elem bytes against ~4*B*Hkv*R*L*Dh flop, about 3 flop
// per byte at R = 6 in bf16, far below the ~295 flop/byte where the
// tensor rate takes over, so bytes bound it (0.040 ms at B=8, L=4,096,
// Hkv=8, Dh=128 bf16 and 3.35 TB/s).  The FMAs (~48 warp instructions a
// row) stay on CUDA cores in IEEE f32, under the byte time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 16;   // cache rows per tile (ops.py TILE_ROWS)
constexpr int kStages = 2;      // ring depth per warp
constexpr int kMaxWarps = 4;    // warps per CTA (the host may take fewer)
constexpr int kMaxSplits = 8;   // CTAs per cluster (portable maximum)
constexpr int kMaxSmem = 232448;
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* cur_len;
  void* out;
  int S, hkv, R, dh;
  int rpg;         // query rows per group
  int nrg;         // groups per (b, h)
  int nsplit;      // CTAs per cluster
  int copy_bytes;  // 16, 8, 4 (cp.async) or 2 (plain loads)
  float scale;
};

// Shared-memory layout, the same on host and device (ops.py mirrors it).
struct Layout {
  int dhp;         // Dh padded so each half row is whole 16-byte chunks
  int kstr;        // bytes between staged K rows
  int vstr;        // bytes between staged V rows
  int stage;       // bytes of one stage (K then V)
  int ring;        // bytes of one warp's ring
  int qs;          // offset of q (KR x dhp floats)
  int ps;          // offset of the per-warp weight buffers
  int wt;          // offset of the merge weights (warps, then CTAs) and sums
  int total;
};

__host__ __device__ inline Layout make_layout(int elem, int dh, int kr,
                                              int dpl, int warps) {
  Layout s;
  const int row = dh * elem;
  s.dhp = ((row + 31) / 32) * 32 / elem;
  s.kstr = s.dhp * elem + 16;  // an odd number of 16-byte chunks
  s.vstr = 32 * dpl * elem;
  s.stage = kTileRows * (s.kstr + s.vstr);
  s.ring = kStages * s.stage;
  s.qs = warps * s.ring;
  s.ps = s.qs + kr * s.dhp * 4;
  s.wt = s.ps + warps * kr * kTileRows * 4;
  s.total = s.wt + ((kMaxWarps + kMaxSplits) * kr + kr) * 4;
  return s;
}

// ---------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `ch` bytes, or write `ch` zero bytes when !valid (src-size 0: the
// source is not read).
__device__ __forceinline__ void copy_chunk(char* dst, const char* src,
                                           int ch, bool valid) {
  const uint32_t d = smem_u32(dst);
  const uint32_t n = valid ? ch : 0;
  if (ch == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (ch == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (ch == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {  // 2-byte rows (bf16 of odd Dh): a plain load
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ conversion

template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out);

template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w,
                                                      float* out) {
  out[0] = __uint_as_float(w << 16);          // element 0: the low half
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// N elements of type T from 4-byte aligned shared memory (N * sizeof(T)
// a multiple of 4), read with the widest loads the size allows.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const char* p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kWords = kBytes / 4;
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // elements a word
  static_assert(kBytes % 4 == 0, "whole words only");
  uint32_t w[kWords];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) unpack<T>(w[i], out + i * kPer);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- kernel

template <typename T, int KR, int DPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attention_kernel(const Params p) {
  constexpr int E = static_cast<int>(sizeof(T));
  constexpr int kChunkElems = 16 / E;  // elements in a 16-byte K chunk
  extern __shared__ float4 smem_f4[];  // 16-byte aligned
  char* smem = reinterpret_cast<char*>(smem_f4);

  cg::cluster_group cluster = cg::this_cluster();
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Layout lay = make_layout(E, p.dh, KR, DPL, nw);
  const int split = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / p.nsplit;     // (b * hkv + h) * nrg + g
  const int g = cid % p.nrg;
  const int bh = cid / p.nrg;
  const int b = bh / p.hkv;
  const int h = bh - b * p.hkv;
  const int r0 = g * p.rpg;
  const int rg = min(p.rpg, p.R - r0);
  const int dh = p.dh;
  const int cur = *p.cur_len;
  const bool all_masked = cur < 1;
  const int L = all_masked ? p.S : min(cur, p.S);

  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ps =
      reinterpret_cast<float*>(smem + lay.ps) + warp * KR * kTileRows;
  char* ring = smem + warp * lay.ring;

  // q (rows past rg and columns past Dh are 0), and the ring's padding
  // columns, which no copy writes, zeroed once
  const T* qg = static_cast<const T*>(p.q) + ((size_t)bh * p.R + r0) * dh;
  for (int i = threadIdx.x; i < KR * lay.dhp; i += blockDim.x) {
    const int r = i / lay.dhp;
    const int d = i - r * lay.dhp;
    qs[i] = (r < rg && d < dh) ? to_f32(qg[r * dh + d]) : 0.f;
  }
  {
    const int kpad = lay.dhp * E - dh * E;  // bytes of zero K columns
    const int vpad = lay.vstr - dh * E;     // bytes of unused V columns
    for (int i = lane; i < kStages * kTileRows * (kpad + vpad); i += 32) {
      const int row = i / (kpad + vpad);    // stage * kTileRows + row
      const int c = i - row * (kpad + vpad);
      char* st = ring + (row / kTileRows) * lay.stage;
      const int rr = row % kTileRows;
      if (c < kpad)
        st[rr * lay.kstr + dh * E + c] = 0;
      else
        st[kTileRows * lay.kstr + rr * lay.vstr + dh * E + (c - kpad)] = 0;
    }
  }
  __syncthreads();

  // this warp's tiles: the split's range of [0, ceil(L / 16)), round-robin
  const int nt_all = (L + kTileRows - 1) / kTileRows;
  const int t_begin = (int)((long long)split * nt_all / p.nsplit);
  const int t_end = (int)((long long)(split + 1) * nt_all / p.nsplit);
  const int nt =
      t_end - t_begin > warp ? (t_end - t_begin - warp + nw - 1) / nw : 0;

  const char* kbase = reinterpret_cast<const char*>(
      static_cast<const T*>(p.k) + ((size_t)b * p.S * p.hkv + h) * dh);
  const char* vbase = reinterpret_cast<const char*>(
      static_cast<const T*>(p.v) + ((size_t)b * p.S * p.hkv + h) * dh);
  const size_t row_bytes = (size_t)p.hkv * dh * E;  // cache row stride
  const int ch = p.copy_bytes;
  const int cpr = dh * E / ch;               // chunks a row
  // lanes over (row, chunk): several rows an instruction where 32 % cpr == 0
  const int rpi = (cpr < 32 && 32 % cpr == 0) ? 32 / cpr : 1;
  const int lrow = rpi > 1 ? lane / cpr : 0;
  const int lcol = rpi > 1 ? lane - lrow * cpr : lane;

  // issue the copies of this warp's tile i into its stage, one commit
  // group a call (empty past the warp's last tile, so the counts hold)
  auto issue = [&](int i) {
    if (i < nt) {
      const int j0 = (t_begin + warp + i * nw) * kTileRows;
      const int n = min(kTileRows, L - j0);
      char* ks = ring + (i % kStages) * lay.stage;
      char* vs = ks + kTileRows * lay.kstr;
      const char* kr = kbase + (size_t)j0 * row_bytes;
      const char* vr = vbase + (size_t)j0 * row_bytes;
      for (int row = lrow; row < kTileRows; row += rpi) {
        const bool valid = row < n;
        const size_t off = valid ? (size_t)row * row_bytes : 0;
        for (int c = lcol; c < cpr; c += 32) {
          copy_chunk(ks + row * lay.kstr + c * ch, kr + off + c * ch, ch,
                     valid);
          copy_chunk(vs + row * lay.vstr + c * ch, vr + off + c * ch, ch,
                     valid);
        }
      }
    }
    cp_async_commit();
  };

  float m[KR], l[KR], acc[KR][DPL];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int row = lane & 15;
  const int half = lane >> 4;
  const int hw = lay.dhp / 2;                // elements in half a row
  const float* qh = qs + half * hw;
  const float scale = p.scale;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();            // tile i has landed
    __syncwarp();                            // ... for every lane; and
    issue(i + kStages - 1);                  // tile i - 1's stage is free
    const int j0 = (t_begin + warp + i * nw) * kTileRows;
    const int n = min(kTileRows, L - j0);
    const char* ks = ring + (i % kStages) * lay.stage;
    const char* vs = ks + kTileRows * lay.kstr;

    // scores of this lane's row over its half of Dh
    float s[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) s[r] = 0.f;
    const char* krow = ks + row * lay.kstr + half * hw * E;
    for (int c = 0; c < hw; c += kChunkElems) {
      float kf[kChunkElems];
      load_vals<T, kChunkElems>(krow + c * E, kf);
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const float* qr = qh + r * lay.dhp + c;
#pragma unroll
        for (int e = 0; e < kChunkElems; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }

    // online softmax over the tile (rows past n weigh exactly 0)
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      float sc = s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16);
      sc = all_masked ? kMasked : sc * scale;
      sc = row < n ? sc : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float pr = expf(sc - m_new);
      l[r] = l[r] * alpha + pr;
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
      if (half == 0) ps[r * kTileRows + row] = pr;
    }
    __syncwarp();

    // accumulate: this lane's DPL columns of every query row
    const int jmax = (n + 3) & ~3;           // rows [n, jmax) are zeros
    const char* vcol = vs + lane * DPL * E;
    for (int j = 0; j < jmax; j += 4) {
      float4 pw[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        pw[r] = *reinterpret_cast<const float4*>(ps + r * kTileRows + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
        load_vals<T, DPL>(vcol + (j + jj) * lay.vstr, vv);
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          const float w = jj == 0 ? pw[r].x
                        : jj == 1 ? pw[r].y
                        : jj == 2 ? pw[r].z
                                  : pw[r].w;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(w, vv[d], acc[r][d]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warp's denominator: lanes l and l ^ 16 hold the same row's terms
#pragma unroll
  for (int r = 0; r < KR; ++r) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  }
  __syncthreads();  // every warp is done with its ring: it becomes a slot

  // slot of warp w (at the start of its ring): m[KR], l[KR], acc[KR][dh];
  // the CTA's merged partial, in the same form, follows warp 0's slot
  const int slot_floats = 2 * KR + KR * dh;
  float* slot = reinterpret_cast<float*>(ring);
  float* cta = reinterpret_cast<float*>(smem) + ((slot_floats + 3) & ~3);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      slot[r] = m[r];
      slot[KR + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < KR; ++r) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int col = lane * DPL + d;
      if (col < dh) slot[2 * KR + r * dh + col] = acc[r][d];
    }
  }
  __syncthreads();

  // the CTA's warps, merged in warp order with weights exp(m_w - max m)
  float* wt = reinterpret_cast<float*>(smem + lay.wt);  // [kMaxWarps][KR]
  float* wc = wt + kMaxWarps * KR;                      // [kMaxSplits][KR]
  float* tot = wc + kMaxSplits * KR;                    // [KR]
  for (int r = threadIdx.x; r < rg; r += blockDim.x) {
    float mm = -INFINITY;
    for (int w = 0; w < nw; ++w)
      mm = fmaxf(mm, reinterpret_cast<const float*>(smem + w * lay.ring)[r]);
    float sum = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* sl = reinterpret_cast<const float*>(smem + w * lay.ring);
      const float x = sl[r] == -INFINITY ? 0.f : expf(sl[r] - mm);
      wt[w * KR + r] = x;
      sum += x * sl[KR + r];
    }
    cta[r] = mm;
    cta[KR + r] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rg * dh; e += blockDim.x) {
    const int r = e / dh;
    float a = 0.f;
    for (int w = 0; w < nw; ++w)
      a = fmaf(wt[w * KR + r],
               reinterpret_cast<const float*>(smem + w * lay.ring)[2 * KR + e],
               a);
    cta[2 * KR + e] = a;
  }
  cluster.sync();   // every CTA's partial is visible to the cluster

  // the cluster's CTAs, merged in rank order; the loads of the nsplit
  // partials are issued together
  const int ns = p.nsplit;
  for (int r = threadIdx.x; r < rg; r += blockDim.x) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      const float* pc = cluster.map_shared_rank(cta, c < ns ? c : 0);
      mv[c] = c < ns ? pc[r] : -INFINITY;
      lv[c] = c < ns ? pc[KR + r] : 0.f;
    }
    float mm = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) mm = fmaxf(mm, mv[c]);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      const float x = mv[c] == -INFINITY ? 0.f : expf(mv[c] - mm);
      wc[c * KR + r] = x;
      sum += x * lv[c];
    }
    tot[r] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();

  // this CTA's slice of the group's rg x dh outputs
  const int n_out = rg * dh;
  const int e0 = (int)((long long)split * n_out / ns);
  const int e1 = (int)((long long)(split + 1) * n_out / ns);
  T* og = static_cast<T*>(p.out) + ((size_t)bh * p.R + r0) * dh;
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int r = e / dh;
    float av[kMaxSplits];
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c)
      av[c] = c < ns ? cluster.map_shared_rank(cta, c)[2 * KR + e] : 0.f;
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) a = fmaf(wc[c * KR + r], av[c], a);
    store(og + e, a / tot[r]);
  }
  cluster.sync();   // no CTA leaves while another still reads its slots
}

// ---------------------------------------------------------------- launch

// Above 48 KB a kernel may use only the dynamic shared memory it has been
// allowed with cudaFuncSetAttribute, a driver call.  Each instantiation
// keeps, per device, the largest size allowed so far, so the call is made
// once and not at every launch of a decode step (nor inside a CUDA-graph
// capture after a first call or a capacity query).
constexpr int kMaxDevices = 64;

// The launch configuration of one call (or of a capacity query: grid 0).
cudaLaunchConfig_t make_config(unsigned blocks, int warps, size_t smem,
                               int nsplit, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What to do with one instantiation: launch it, or ask how many of its
// clusters the card holds at once (into *clusters).
struct Job {
  const Params* p;   // null: a capacity query
  int B, warps, nsplit;
  size_t smem;
  cudaStream_t stream;
  int* clusters;
};

template <typename T, int KR, int DPL>
cudaError_t run(const Job& job) {
  static size_t allowed[kMaxDevices] = {};
  auto kernel = decode_attention_kernel<T, KR, DPL>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (job.smem > 48 * 1024 &&
      (dev >= kMaxDevices || allowed[dev] < job.smem)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)job.smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = job.smem;
  }
  cudaLaunchAttribute attr[1];
  if (job.p == nullptr) {
    cudaLaunchConfig_t cfg = make_config(job.nsplit, job.warps, job.smem,
                                         job.nsplit, job.stream, attr);
    return cudaOccupancyMaxActiveClusters(job.clusters, kernel, &cfg);
  }
  const Params& p = *job.p;
  cudaLaunchConfig_t cfg = make_config(
      (unsigned)((size_t)job.B * p.hkv * p.nrg * p.nsplit), job.warps,
      job.smem, p.nsplit, job.stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int KR>
cudaError_t run_dpl(const Job& job, int dpl) {
  switch (dpl) {
    case 2: return run<T, KR, 2>(job);
    case 4: return run<T, KR, 4>(job);
    case 8: return run<T, KR, 8>(job);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_kr(const Job& job, int kr, int dpl) {
  switch (kr) {
    case 1: return run_dpl<T, 1>(job, dpl);
    case 2: return run_dpl<T, 2>(job, dpl);
    case 4: return run_dpl<T, 4>(job, dpl);
    case 6: return run_dpl<T, 6>(job, dpl);
    case 8: return run_dpl<T, 8>(job, dpl);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Job& job, int dtype, int kr, int dpl) {
  if (dtype == 0) return run_kr<float>(job, kr, dpl);
  if (dtype == 1) return run_kr<__nv_bfloat16>(job, kr, dpl);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The argument list's version: ab_build calls a tree with the list its
// library takes (version 1, without this symbol, had no plan arguments
// and wrote f32).
int decode_attention_abi(void) { return 2; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  The plan (ops.py
// `plan`): rpg query rows a group, nrg groups, kr the compile-time row
// bound (1, 2, 4, 6 or 8, >= rpg), dpl output columns a lane (2, 4 or 8,
// 32 * dpl >= Dh), warps a CTA (1-4), nsplit CTAs a cluster (1-8).
// copy_bytes: 16, 8 or 4 if every cache row (and the caches' bases) is
// aligned to it and Dh * elem is a multiple, else 2 (bf16 only).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cur_len, void* out, int B, int S,
                            int hkv, int R, int dh, float scale, int dtype,
                            int rpg, int nrg, int kr, int dpl, int warps,
                            int nsplit, int copy_bytes, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (B <= 0 || S <= 0 || hkv <= 0 || R <= 0 || dh <= 0 || dh > 32 * dpl ||
      rpg <= 0 || rpg > kr || nrg * rpg < R || (nrg - 1) * rpg >= R ||
      warps < 1 || warps > kMaxWarps || nsplit < 1 || nsplit > kMaxSplits ||
      (dtype != 0 && dtype != 1) ||
      (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 4 &&
       !(copy_bytes == 2 && elem == 2)) ||
      (dh * elem) % copy_bytes != 0)
    return cudaErrorInvalidValue;
  const Layout lay = make_layout(elem, dh, kr, dpl, warps);
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.cur_len = static_cast<const int*>(cur_len);
  p.out = out;
  p.S = S;
  p.hkv = hkv;
  p.R = R;
  p.dh = dh;
  p.rpg = rpg;
  p.nrg = nrg;
  p.nsplit = nsplit;
  p.copy_bytes = copy_bytes;
  p.scale = scale;
  const Job job{&p, B, warps, nsplit, (size_t)lay.total,
                static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(job, dtype, kr, dpl);
}

// How many clusters of `nsplit` CTAs of this configuration the current
// device holds at once (cudaOccupancyMaxActiveClusters), or -1 on error.
// The planner sizes the split count with it: clusters must fit whole in
// a GPC, so the count the card holds is not the SMs' CTAs over nsplit.
int decode_attention_max_clusters(int dtype, int dh, int kr, int dpl,
                                  int warps, int nsplit) {
  if (dh <= 0 || dh > 32 * dpl || warps < 1 || warps > kMaxWarps ||
      nsplit < 1 || nsplit > kMaxSplits)
    return -1;
  const Layout lay = make_layout(dtype == 0 ? 4 : 2, dh, kr, dpl, warps);
  if (lay.total > kMaxSmem) return -1;
  int clusters = 0;
  const Job job{nullptr, 0, warps, nsplit, (size_t)lay.total, nullptr,
                &clusters};
  return dispatch(job, dtype, kr, dpl) == cudaSuccess ? clusters : -1;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
