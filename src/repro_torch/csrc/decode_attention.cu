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
//   out = sum_j softmax(s)_j v_j        (B, Hkv, R, Dh), f32
// All arithmetic is f32.  The masked score is -1e30, not -inf, as in the
// JAX package: with cur_len = 0 every score is -1e30 and the result is
// the mean of V over all S rows, which the kernel reproduces by letting
// each masked row weigh exp(0) = 1 until a real score arrives.  The
// denominator is floored at 1e-30.
//
// Design.  The TPU kernel walks the grid (B, Hkv, S/512) with the kv axis
// innermost and in order, carrying the online-softmax state (running max,
// denominator, accumulator) in VMEM scratch across kv steps; cur_len comes
// in by scalar prefetch.  Here one thread block of 256 threads takes one
// (b, h) and a loop over S replaces the kv grid axis.  Each step stages a
// chunk of 64 cache rows of K and V in shared memory, converted to f32
// (512 rows x 128 x 2 B x 2 caches would be 256 KB; 64 rows take 64 KB
// at Dh = 128), computes the R x 64 scores (one thread per score),
// reduces each query row's max and sum with one warp per row, and
// rescales and adds into the R x Dh accumulator (in shared memory; each
// thread owns the same outputs throughout).  Where Dh % 4 == 0 both
// products read shared memory 16 bytes at a time (a thread's score walks
// q and K four elements a load; a thread owns four neighbouring outputs
// and reads four V values a load), with K rows padded to Dh + 4 so that
// a quarter warp's eight rows fall in 32 distinct banks; otherwise one
// element at a time, K rows padded to an odd stride.  The tail chunk of
// any S is handled by excluding rows past S outright (weight exactly 0);
// cur_len is read from device memory, so the host never waits for it.
// Global loads are 16 bytes a thread, four in flight, where the rows are
// 16-byte aligned, else one element at a time.  Any Dh <= 256 and any R
// whose shared memory fits (the wrapper checks) are taken.
//
// What bounds it on the H100.  Decode reads every cache row once: 2 *
// B*S*Hkv*Dh * elem bytes against ~B*Hkv*R*S*Dh*4 flop, about 3 flop per
// byte at R = 6 in bf16, far below the ~295 flop/byte where the card's
// tensor rate takes over: bytes bound it (0.040 ms at B=8, S=4,096,
// Hkv=8, Dh=128 bf16 and 3.35 TB/s).  This first kernel gives the serve
// case only B*Hkv = 64 blocks for 132 SMs, with a load-then-compute step
// per chunk; split-KV with a combine pass, TMA-staged double-buffered
// chunks and skipping chunks past cur_len (exact only for cur_len >= 1)
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;    // cache rows per step (ops.py's _CHUNK)
constexpr int kUnroll = 4;    // 16-byte loads in flight per thread and cache
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [c0, c0 + n) of this block's K and V into ks (row stride
// kstride) and vs (row stride dh) as f32.  kg/vg point at row 0 of this
// (b, h); consecutive rows are row_stride elements apart.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ kg,
                                           const T* __restrict__ vg,
                                           size_t row_stride, int c0, int n,
                                           int dh, int kstride, bool vec,
                                           float* ks, float* vs) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
    const int per_row = dh / kVec;
    const int nvec = n * per_row;
    for (int base = 0; base < nvec; base += kThreads * kUnroll) {
      uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nvec) {
          const int j = i / per_row;
          const int d = (i - j * per_row) * kVec;
          const size_t off = (size_t)(c0 + j) * row_stride + d;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(kg + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(vg + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nvec) {
          const int j = i / per_row;
          const int d = (i - j * per_row) * kVec;
          const T* ke = reinterpret_cast<const T*>(&kr[u]);
          const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            ks[j * kstride + d + e] = to_f32(ke[e]);
            vs[j * dh + d + e] = to_f32(ve[e]);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < n * dh; i += kThreads) {
      const int j = i / dh;
      const int d = i - j * dh;
      const size_t off = (size_t)(c0 + j) * row_stride + d;
      ks[j * kstride + d] = to_f32(kg[off]);
      vs[j * dh + d] = to_f32(vg[off]);
    }
  }
}

// Row stride of the staged K chunk, in floats (see the design note).
__host__ __device__ __forceinline__ int k_stride(int dh) {
  return dh % 4 == 0 ? dh + 4 : (dh | 1);
}

template <typename T, bool kF4>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ cur_len_ptr,
                        float* __restrict__ out, int S, int hkv, int R,
                        int dh, float scale, bool vec) {
  extern __shared__ float4 smem_f4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int kstride = k_stride(dh);
  const int rd = R * dh;
  float* qs = smem;                 // R x dh
  float* acc = qs + rd;             // R x dh
  float* ks = acc + rd;             // kChunk x kstride
  float* vs = ks + kChunk * kstride;  // kChunk x dh
  float* ps = vs + kChunk * dh;     // R x kChunk: scores, then weights
  float* ms = ps + R * kChunk;      // R: running max
  float* ls = ms + R;               // R: running denominator
  float* alphas = ls + R;           // R: this chunk's rescale factor

  const int bh = blockIdx.x;        // b * hkv + h
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cur_len = *cur_len_ptr;

  const T* qg = q + (size_t)bh * rd;
  for (int i = tid; i < rd; i += kThreads) {
    qs[i] = to_f32(qg[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  const size_t row_stride = (size_t)hkv * dh;
  const T* kg = k + ((size_t)b * S * hkv + h) * dh;
  const T* vg = v + ((size_t)b * S * hkv + h) * dh;

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();  // the previous step is done with ks, vs and ps
    load_chunk<T>(kg, vg, row_stride, c0, n, dh, kstride, vec, ks, vs);
    __syncthreads();

    // scores; rows past S get -inf (weight exactly 0), rows past cur_len
    // get -1e30 as in the JAX package
    for (int p = tid; p < R * kChunk; p += kThreads) {
      const int r = p / kChunk;
      const int j = p - r * kChunk;
      float s = -INFINITY;
      if (j < n) {
        const float* qr = qs + r * dh;
        const float* kr = ks + j * kstride;
        float dot = 0.f;
        if (kF4) {
          for (int d = 0; d < dh; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(qr + d);
            const float4 c = *reinterpret_cast<const float4*>(kr + d);
            dot = fmaf(a.x, c.x, dot);
            dot = fmaf(a.y, c.y, dot);
            dot = fmaf(a.z, c.z, dot);
            dot = fmaf(a.w, c.w, dot);
          }
        } else {
          for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        }
        s = (c0 + j < cur_len) ? dot * scale : kNegInf;
      }
      ps[p] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float* pr = ps + r * kChunk;
      float mx = -INFINITY;
      for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float e = expf(pr[j] - m_new);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alphas[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    if (kF4) {
      for (int o = 4 * tid; o < rd; o += 4 * kThreads) {
        const int r = o / dh;
        const int d = o - r * dh;
        const float* pr = ps + r * kChunk;
        const float alpha = alphas[r];
        float4 a = *reinterpret_cast<float4*>(acc + o);
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
        for (int j = 0; j < n; ++j) {
          const float pj = pr[j];
          const float4 w = *reinterpret_cast<const float4*>(vs + j * dh + d);
          a.x = fmaf(pj, w.x, a.x);
          a.y = fmaf(pj, w.y, a.y);
          a.z = fmaf(pj, w.z, a.z);
          a.w = fmaf(pj, w.w, a.w);
        }
        *reinterpret_cast<float4*>(acc + o) = a;
      }
    } else {
      for (int o = tid; o < rd; o += kThreads) {
        const int r = o / dh;
        const int d = o - r * dh;
        const float* pr = ps + r * kChunk;
        float a = acc[o] * alphas[r];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * dh + d], a);
        acc[o] = a;
      }
    }
  }
  __syncthreads();  // the final pass reads accumulator entries of others
  float* og = out + (size_t)bh * rd;
  for (int o = tid; o < rd; o += kThreads)
    og[o] = acc[o] / fmaxf(ls[o / dh], 1e-30f);
}

// Above 48 KB a kernel may use only the dynamic shared memory it has been
// allowed with cudaFuncSetAttribute, a driver call.  Each instantiation
// keeps, per device, the largest size allowed so far, so the call is made
// once and not at every launch of a decode step.
constexpr int kMaxDevices = 64;

template <typename T, bool kF4>
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

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* cur_len, void* out, int B, int S,
                         int hkv, int R, int dh, float scale, bool vec,
                         size_t smem, cudaStream_t stream) {
  const bool f4 = dh % 4 == 0;
  auto kernel = f4 ? decode_attention_kernel<T, true>
                   : decode_attention_kernel<T, false>;
  cudaError_t err = allow_smem(f4 ? allowed_smem<T, true>()
                                  : allowed_smem<T, false>(),
                               reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cur_len),
      static_cast<float*>(out), S, hkv, R, dh, scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v); out is float32.
// vec: 1 if every cache row starts 16-byte aligned (16-byte loads).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* cur_len, void* out, int B, int S,
                            int hkv, int R, int dh, float scale, int dtype,
                            int vec, void* stream) {
  if (B <= 0 || S <= 0 || hkv <= 0 || R <= 0 || dh <= 0 || dh > 256)
    return cudaErrorInvalidValue;
  const int kstride = k_stride(dh);
  const size_t smem = sizeof(float) *
      ((size_t)2 * R * dh + (size_t)kChunk * kstride + (size_t)kChunk * dh +
       (size_t)R * kChunk + 3 * (size_t)R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, cur_len, out, B, S, hkv, R, dh,
                               scale, vec != 0, smem, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, cur_len, out, B, S, hkv, R,
                                       dh, scale, vec != 0, smem, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
